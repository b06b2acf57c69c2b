"""SDF to prepass density in one kernel (counterpart of the density-cache
build, nicer_slam_tpu/models/scene_model.py:108 ``build_density_cache``,
and of the exact prepass, :238-287, of an eval render and of every
training iteration with ``prepass_mode = exact``): kernel K6.

Per point x, from the SDF grids' tables rounded to bfloat16
(``fields.pack_combine_tables``)::

  sdf     = coarse_mlp([x, PE6(x), K3_coarse(x)])[0]
            + fine_mlp([x, PE6(x), K3_fine(x)])[0]
  beta    = the voxel counter's beta at x (K7's read), or the learned
            scalar beta; times beta_scale when given
  density = (1/beta)(0.5 + 0.5·sign(sdf)·expm1(−|sdf|/beta))

``density_grid`` evaluates it at every point of the ``linspace(-1, 1,
res)³`` grid (the density cache, flat index ``(i·res + j)·res + k``),
``density_rays`` at ``o + z·d`` for every ray and prepass z (the exact
prepass). On a CPU tensor both run ``sdf_density_plain``: plain torch
(K3's and K7's plain versions, the MLPs, the Laplace density) rounded as
the kernels round (``sdf_plain``). On a CUDA tensor each is one
launch of ``csrc/sdf_density.cu``; it never falls back to the plain
version. ``check_sdf_network`` picks the kernel once per ``pack_sdf``:

  * ``shipped``: the one SDF network every shipped configuration uses, a
    kernel compiled for its shape (launch counters ``sdf_density.grid`` /
    ``.rays``);
  * ``general``: any other network the JAX package runs, one kernel that
    reads the shape from a descriptor (``pack_general``; counters
    ``sdf_density_general.*``);
  * ``concat``: ``concat_coarse_feature``, the general kernel on fp32
    tables (the JAX package's prepass runs fp32 ``combine_sdf`` there),
    with the coarse network's feature rows fed to the fine network
    (``sdf_density_concat.*``; ray mode only: the JAX package cannot build a
    density cache for it).

It raises only for a network the JAX package cannot run either.

The kernels read the weight-normed layers as their effective weights
``g·v/‖v‖``, computed once per pack (as ``WNLinear.forward`` computes
them, so the same bits as the plain version's). The shipped kernel's
layout (``pack_sdf_weights``): each hidden layer transposed ``[in][64]``
with its units in the order ``q -> q//4 + 16·(q % 4)`` (a thread's 4 units
are one float4), and of each last layer only row 0, the SDF. The general
kernel's (``pack_general``): each layer transposed ``[K][N]`` over the
rows it reads in shared memory, every width padded to a multiple of 4 with
zero units; the note at the top of the CUDA source has the designs and
their error budget.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import fields
from ..models.linear import softplus_beta100
from . import _cuda
from . import density as density_ops
from . import hash_encoder as he
from .embedder import positional_encoding

# the SDF network the kernel serves: every shipped configuration's
# (coarse 71 -> 64 -> 65 on a 4 x 8 dense grid, fine 71 -> 64 -> 64 -> 64
# -> 65 on an 8 x 4 grid, multires 6, no skip, no clamp, grid features on)
KERNEL_WIDTH = 64
KERNEL_HIDDEN = {"coarse": 1, "fine": 3}
KERNEL_GRID = {"coarse": (4, 8), "fine": (8, 4)}   # (levels, channels)
KERNEL_MULTIRES = 6
# points per chunk of the plain grid build (the build ran in 16 chunks)
PLAIN_GRID_CHUNKS = 16
# the general kernel: layers per network, and the ints of one network's
# descriptor (n, n_pe, multires, L, C, d0, clamp, feat, divide_factor's
# bits, then per layer K, N, skip and the weights' offset)
MAX_LAYERS = 16
DESC_HEAD = 9
DESC_INTS = DESC_HEAD + 4 * MAX_LAYERS


class SdfPack(NamedTuple):
    """What K6 reads of the SDF network, packed once per cache build or per
    render: the grids' tables (bf16; fp32 for the concat variant) and, on a
    card, the packed weights and (general and concat) the descriptor."""

    tables: Dict[str, torch.Tensor]        # fields.pack_combine_tables
    weights: Optional[torch.Tensor]        # None on the CPU
    variant: str = "shipped"               # check_sdf_network
    desc: Optional[np.ndarray] = None      # int32 [2, DESC_INTS] (pack_general)


def _is_shipped(cfg: fields.CombineConfig) -> bool:
    for name in ("coarse", "fine"):
        c = getattr(cfg, name)
        hidden = c.layer_dims[1:-1]
        L, C = KERNEL_GRID[name]
        if not (not c.skip_in and c.multires == KERNEL_MULTIRES and c.use_grid_feature
                and not (c.clamp and name == "fine") and not c.concat_coarse_feature
                and c.divide_factor == 1.0 and c.num_levels == L and c.level_dim == C
                and len(hidden) == KERNEL_HIDDEN[name]
                and all(h == KERNEL_WIDTH for h in hidden)):
            return False
    return True


def check_sdf_network(cfg: fields.CombineConfig) -> str:
    """The K6 variant for this SDF network: ``shipped`` (the kernel
    compiled for every shipped configuration's network), ``general`` (any
    other) or ``concat`` (concat_coarse_feature, fp32 tables). Raises
    ValueError only for a network the JAX package cannot run either."""
    for name in ("coarse", "fine"):
        c = getattr(cfg, name)
        why = None
        if c.d_in != 3:
            why = f"d_in {c.d_in}: its grids and positional encoding take 3-d points"
        elif 0 in c.skip_in:
            why = "skip_in holds 0: the first layer's input would be twice its width"
        elif any(c.layer_dims[l] - (c.layer_dims[0] if l in c.skip_in else 0) < 1
                 for l in range(1, len(c.layer_dims))):
            why = (f"layer dims {c.layer_dims} with skip_in {c.skip_in}: a layer before a "
                   f"skip has no units left beside the {c.layer_dims[0]} input columns")
        elif name == "coarse" and c.concat_coarse_feature:
            why = "the coarse network has no coarse features to concatenate"
        elif (c.use_grid_feature and c.level_dim % 2
              and not cfg.fine.concat_coarse_feature):
            why = (f"level_dim {c.level_dim} is odd: the packed bf16 encoder of its "
                   f"prepass asserts an even level_dim (nicer_slam_tpu/ops/"
                   f"hash_encoder.py:865)")
        elif (name == "fine" and c.concat_coarse_feature
              and cfg.coarse.layer_dims[-1] - 1 != c.feature_vector_size):
            why = (f"the coarse network's {cfg.coarse.layer_dims[-1] - 1} feature rows "
                   f"are not the {c.feature_vector_size} its first layer takes")
        if why is not None:
            raise ValueError(f"sdf_density: the {name} SDF network runs in neither "
                             f"package: {why}")
        if len(c.layer_dims) - 1 > MAX_LAYERS:
            raise ValueError(f"sdf_density: the {name} SDF network has "
                             f"{len(c.layer_dims) - 1} layers; the kernel takes {MAX_LAYERS}")
    if cfg.fine.concat_coarse_feature:
        return "concat"
    return "shipped" if _is_shipped(cfg) else "general"


# ---------------------------------------------------------------------------
# the packed weights
# ---------------------------------------------------------------------------

def unit_order(width: int) -> torch.Tensor:
    """The packed position q holds unit q//4 + (width/4)·(q % 4): thread og
    of the kernel's 16 reads its units og, og + 16, og + 32, og + 48 as one
    float4 at 4·og."""
    q = torch.arange(width)
    return q // 4 + (width // 4) * (q % 4)


def effective_layers(net: fields.ImplicitNet) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(W [out, in], b [out]) of every layer, ``W = g·v/‖v‖`` computed as
    ``WNLinear.forward`` computes it."""
    out = []
    for lin in net.lins:
        v = lin.v.detach()
        w = v if lin.g is None else v * (lin.g.detach()
                                         / torch.sqrt((v * v).sum(dim=1, keepdim=True)))
        out.append((w, lin.b.detach()))
    return out


def packed_floats(dims: Tuple[int, ...]) -> int:
    """Floats of one network with layer dims ``dims`` in the packed layout."""
    width = dims[1]
    return sum((k_in + 1) * width for k_in in dims[:-2]) + width + 4


@functools.lru_cache(maxsize=8)
def _pack_index(dims: Tuple[Tuple[int, ...], ...], device: str) -> torch.Tensor:
    """For each packed float, its place in the networks' effective layers
    laid out naturally one after the other (each W [out, in] row-major,
    then b); the 3 pad floats after each SDF bias (never read) take place
    0."""
    idx, base = [], 0
    for d in dims:
        order = unit_order(d[1])
        for l, k_in in enumerate(d[:-1]):
            n_out = d[l + 1]
            if l < len(d) - 2:       # hidden layer: [k_in][width], units in order
                idx.append((base + order[None, :] * k_in
                            + torch.arange(k_in)[:, None]).reshape(-1))
                idx.append(base + n_out * k_in + order)
            else:                    # last layer: its row 0 and its bias, padded
                idx.append(base + order)
                idx.append(torch.tensor([base + n_out * k_in, 0, 0, 0]))
            base += n_out * k_in + n_out
    return torch.cat(idx).to(device)


def pack_sdf_weights(net: fields.CombineNet) -> torch.Tensor:
    """Both networks' effective weights in the kernel's order, flat float32:
    per network each hidden layer ``[in][width]`` (units in ``unit_order``)
    and its bias, then the last layer's SDF row and its bias padded to 4
    (one concatenation and one gather after the weight norms)."""
    dims = (net.cfg.coarse.layer_dims, net.cfg.fine.layer_dims)
    if any(d[1] % 4 for d in dims):
        raise ValueError(f"the packed layout needs widths divisible by 4, got {dims}")
    flat = torch.cat([t.reshape(-1) for sub in (net.coarse, net.fine)
                      for layer in effective_layers(sub) for t in layer])
    return flat[_pack_index(dims, str(flat.device))]


def _ceil4(v: int) -> int:
    return (v + 3) // 4 * 4


def _n_pe(c: fields.ImplicitNetConfig) -> int:
    return 3 * (1 + 2 * c.multires) if c.multires > 0 else 3


@functools.lru_cache(maxsize=16)
def _general_layout(cfg: fields.CombineConfig):
    """(index, desc): for each float of the general kernel's weights its
    place in both networks' effective layers laid out naturally one after
    the other (each W [out, in] row-major, then b), -1 for a zero; and the
    descriptor int32 [2, DESC_INTS].

    A network's input rows X are x and its positional encoding, the grid's
    L·C features (none without use_grid_feature: those columns are zero)
    and, for the fine network with concat, the coarse feature rows padded
    to 4. Layer l reads K rows: X (l = 0), the previous layer's units padded
    to 4, and after them X again where l is in skip_in. A hidden layer is
    W [K][N] then b [N] (N its units padded to 4), the last the SDF row
    [ceil4(K)] and its bias padded to 4, then, for the coarse network with
    concat, its feature rows W [K][F4] and b [F4]."""
    concat = cfg.fine.concat_coarse_feature
    F = cfg.coarse.layer_dims[-1] - 1
    F4 = _ceil4(F) if concat else 0
    idx, desc = [], np.zeros((2, DESC_INTS), np.int32)
    pos = base = 0
    for i, name in enumerate(("coarse", "fine")):
        c = getattr(cfg, name)
        dims, n, n_pe = c.layer_dims, len(c.layer_dims) - 1, _n_pe(c)
        LC = c.num_levels * c.level_dim
        xmap = list(range(n_pe)) + (list(range(n_pe, n_pe + LC)) if c.use_grid_feature else [])
        if name == "fine" and concat:
            xmap += [n_pe + LC + f if f < F else -1 for f in range(F4)]
        outs = [dims[l + 1] - (dims[0] if l + 1 in c.skip_in else 0) for l in range(n)]
        desc[i, :DESC_HEAD] = [n, n_pe, max(c.multires, 0),
                               c.num_levels if c.use_grid_feature else 0, c.level_dim,
                               len(xmap), int(c.clamp and name == "fine"),
                               F4 if name == "coarse" else 0,
                               np.float32(c.divide_factor).view(np.int32)]
        n_prev = 0
        for l in range(n):
            if l == 0:
                imap = xmap
            else:
                imap = [j if j < outs[l - 1] else -1 for j in range(n_prev)]
                if l in c.skip_in:
                    imap += [outs[l - 1] + m if m >= 0 else -1 for m in xmap]
            imap = np.asarray(imap, np.int64)[:, None]
            K, k_in, w0 = len(imap), dims[l], base
            b0 = base + outs[l] * k_in
            desc[i, DESC_HEAD + l] = K
            desc[i, DESC_HEAD + 2 * MAX_LAYERS + l] = int(l in c.skip_in)
            desc[i, DESC_HEAD + 3 * MAX_LAYERS + l] = pos
            if l < n - 1:
                N = n_prev = _ceil4(outs[l])
                desc[i, DESC_HEAD + MAX_LAYERS + l] = N
                j = np.arange(N)[None, :]
                idx += [np.where((imap >= 0) & (j < outs[l]), w0 + j * k_in + imap, -1),
                        np.where(j[0] < outs[l], b0 + j[0], -1)]
                pos += K * N + N
            else:
                row = np.full(_ceil4(K), -1, np.int64)
                row[:K] = np.where(imap[:, 0] >= 0, w0 + imap[:, 0], -1)
                idx += [row, np.array([b0, -1, -1, -1])]
                pos += _ceil4(K) + 4
                if name == "coarse" and concat:
                    f = np.arange(F4)[None, :]
                    idx += [np.where((imap >= 0) & (f < F), w0 + (1 + f) * k_in + imap, -1),
                            np.where(f[0] < F, b0 + 1 + f[0], -1)]
                    pos += K * F4 + F4
            base += outs[l] * k_in + outs[l]
    index = np.concatenate([a.reshape(-1) for a in idx])
    assert index.size == pos
    return np.where(index < 0, base, index), desc


def pack_general(net: fields.CombineNet) -> Tuple[torch.Tensor, np.ndarray]:
    """(weights, desc) of the general kernel: both networks' effective
    weights in ``_general_layout``'s order (one concatenation and one
    gather after the weight norms, a trailing 0 for the padding) and the
    descriptor."""
    index, desc = _general_layout(net.cfg)
    flat = torch.cat([t.reshape(-1) for sub in (net.coarse, net.fine)
                      for layer in effective_layers(sub) for t in layer]
                     + [torch.zeros(1, device=net.coarse.encoding.device)])
    return flat[torch.as_tensor(index, device=flat.device)], desc


def _grid_input(c: fields.ImplicitNetConfig, spec, table: torch.Tensor, x: torch.Tensor):
    """The grid features [N, L·C] the kernel reads: from a bf16 table (K3's
    plain version) or an fp32 one (K2's)."""
    xd = x / c.divide_factor
    if table.dtype == torch.bfloat16:
        return he.hash_encode_bf16_plain(spec, table, xd)
    return he.hash_encode_plain(spec, table, xd)


def sdf_general_reference(net: fields.CombineNet, tables: Dict[str, torch.Tensor],
                          flat: torch.Tensor, desc: np.ndarray, x: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The SDF [N] as the general kernel computes it from ``pack_general``'s
    weights and descriptor (its rows, padding and skip layout), in ``dtype``
    (float64: the reference the kernel's rounding is measured against)."""
    total, feat = None, None
    for i, name in enumerate(("coarse", "fine")):
        sub, d = getattr(net, name), desc[i]
        n, L, F4 = int(d[0]), int(d[3]), int(d[7])
        parts = [positional_encoding(x, sub.cfg.multires)]
        if L:
            parts.append(_grid_input(sub.cfg, sub.spec, tables[name], x))
        if feat is not None:
            parts.append(feat)
        X = torch.cat(parts, -1).to(dtype)
        h = X
        for l in range(n):
            K, N, off = (int(d[DESC_HEAD + l]), int(d[DESC_HEAD + MAX_LAYERS + l]),
                         int(d[DESC_HEAD + 3 * MAX_LAYERS + l]))
            assert h.shape[1] == K
            if l < n - 1:
                w = flat[off:off + K * N].reshape(K, N).to(dtype)
                h = softplus_beta100(h @ w + flat[off + K * N:off + K * N + N].to(dtype))
                if d[DESC_HEAD + 2 * MAX_LAYERS + l + 1]:
                    h = torch.cat([h, X], -1) / np.float32(np.sqrt(2.0))
            else:
                K4 = _ceil4(K)
                s = h @ flat[off:off + K].to(dtype) + flat[off + K4].to(dtype)
                if F4:
                    o = off + K4 + 4
                    feat = (h @ flat[o:o + K * F4].reshape(K, F4).to(dtype)
                            + flat[o + K * F4:o + K * F4 + F4].to(dtype))
        if d[6]:
            s = torch.tanh(s.float()) * 0.05
        total = s if total is None else total + s.to(total.dtype)
    return total


def sdf_packed_reference(net: fields.CombineNet, tables: Dict[str, torch.Tensor],
                         flat: torch.Tensor, x: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The SDF [N] from the packed weights in the kernel's layer order (each
    hidden layer's units in ``unit_order``, the last layer's SDF row
    alone), from K3's features; in ``dtype`` (float64: the reference the
    kernel's rounding is measured against)."""
    pos = 0
    total = None
    for name in ("coarse", "fine"):
        sub = getattr(net, name)
        feats = he.hash_encode_bf16_plain(sub.spec, tables[name],
                                          x / sub.cfg.divide_factor)
        h = torch.cat([positional_encoding(x, sub.cfg.multires), feats], -1).to(dtype)
        dims = sub.cfg.layer_dims
        width = dims[1]
        order = unit_order(width).to(x.device)
        for k_in in dims[:-2]:
            w = flat[pos:pos + k_in * width].reshape(k_in, width).to(dtype)
            b = flat[pos + k_in * width:pos + (k_in + 1) * width].to(dtype)
            pos += (k_in + 1) * width
            hq = softplus_beta100(h @ w + b)       # packed unit order
            h = torch.empty_like(hq)
            h[:, order] = hq
        wl = flat[pos:pos + width].to(dtype)
        bl = flat[pos + width].to(dtype)
        pos += width + 4
        s = h[:, order] @ wl + bl
        total = s if total is None else total + s
    return total


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def density_from_sdf(sdf: torch.Tensor, x: torch.Tensor, voxels: Optional[torch.Tensor],
                     beta: Optional[torch.Tensor], beta_scale=None,
                     voxel_res: int = 64) -> torch.Tensor:
    """The Laplace density [N] of sdf [N] at points x [N, 3]: with the
    learned ``beta`` (volsdf_laplace) or, without it, the voxel counter's
    β (K7's read); times ``beta_scale`` when given."""
    if beta is not None:
        if beta_scale is not None:
            beta = beta * beta_scale
        return density_ops.laplace_density(sdf, beta)
    b = density_ops.grid_predefined_beta(voxels, x, voxel_res)
    if beta_scale is not None:
        b = b * beta_scale
    return density_ops.laplace_density(sdf[:, None], b)[:, 0]


@torch.no_grad()
def sdf_plain(net: fields.CombineNet, tables: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """The SDF [N] that K6 computes, rounded as its kernels round it: the
    grids from ``tables`` (bf16, K3's plain version; fp32 with
    concat_coarse_feature, K2's, as the JAX package's prepass reads
    ``combine_sdf`` there), float32 hidden layers (the library's
    products), each last layer's SDF row and the coarse + fine sum in
    float64, rounded to float32 once (the fine clamp rounds the fine SDF to
    float32 first). ``fields.combine_sdf_packed`` sums that row in float32:
    a wide network's row then rounds past the 2e-5 of the largest density
    that the density's slope leaves (a 256-wide last layer: 2.4e-5)."""
    total, feat = None, None
    for name in ("coarse", "fine"):
        sub = getattr(net, name)
        c = sub.cfg
        grid = (_grid_input(c, sub.spec, tables[name], x) if c.use_grid_feature
                else x.new_zeros((x.shape[0], c.grid_feature_dim)))
        if feat is not None:
            grid = torch.cat([grid, feat], -1)
        inp = fields._mlp_input(sub, x, grid)
        h = inp
        for l, lin in enumerate(sub.lins[:-1]):
            if l in c.skip_in:
                h = torch.cat([h, inp], dim=-1) / np.sqrt(2.0)
            h = softplus_beta100(lin(h))
        if len(sub.lins) - 1 in c.skip_in:
            h = torch.cat([h, inp], dim=-1) / np.sqrt(2.0)
        w, b = effective_layers(sub)[-1]
        s = h.double() @ w[0].double() + b[0].double()
        if name == "coarse" and net.cfg.fine.concat_coarse_feature:
            feat = h @ w[1:].T + b[1:]
        if c.clamp and name == "fine":
            s = (torch.tanh(s.float()) * 0.05).double()
        total = s if total is None else total + s
    return total.float()


@torch.no_grad()
def sdf_density_plain(net: fields.CombineNet, tables: Dict[str, torch.Tensor],
                      x: torch.Tensor, voxels: Optional[torch.Tensor],
                      beta: Optional[torch.Tensor] = None, beta_scale=None,
                      voxel_res: int = 64) -> torch.Tensor:
    """Plain version of K6 at points x [N, 3]: ``sdf_plain``, then
    ``density_from_sdf``."""
    return density_from_sdf(sdf_plain(net, tables, x), x, voxels, beta, beta_scale,
                            voxel_res)


def grid_points(xs: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The kernel's grid index map: flat index n = (i·res + j)·res + k ->
    (xs[i], xs[j], xs[k]) [len(n), 3], the rows of
    ``meshgrid(xs, xs, xs, indexing="ij")``."""
    res = xs.shape[0]
    return torch.stack([xs[n // (res * res)], xs[(n // res) % res], xs[n % res]], -1)


def density_grid_plain(net, tables, res: int, voxels, beta=None, beta_scale=None,
                       voxel_res: int = 64) -> torch.Tensor:
    """Plain version of the grid mode: [res³] over the meshgrid of
    ``linspace(-1, 1, res)``, in PLAIN_GRID_CHUNKS chunks."""
    dev = tables["coarse"].device
    xs = torch.linspace(-1.0, 1.0, res, dtype=torch.float32, device=dev)
    grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    return torch.cat([sdf_density_plain(net, tables, pts.contiguous(), voxels, beta,
                                        beta_scale, voxel_res)
                      for pts in grid.chunk(PLAIN_GRID_CHUNKS)])


def ray_points(o: torch.Tensor, d: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """o + z·d [R·S, 3] for rays o, d [R, 3] and z [R, S]."""
    return (o[:, None, :] + z[..., None] * d[:, None, :]).reshape(-1, 3)


def density_rays_plain(net, tables, o, d, z, voxels, beta=None, beta_scale=None,
                       voxel_res: int = 64) -> torch.Tensor:
    """Plain version of the ray mode: [R, S] at ``ray_points(o, d, z)``."""
    return sdf_density_plain(net, tables, ray_points(o, d, z), voxels, beta, beta_scale,
                             voxel_res).reshape(z.shape)


# ---------------------------------------------------------------------------
# the kernel (csrc/sdf_density.cu)
# ---------------------------------------------------------------------------

def pack_sdf(net: fields.CombineNet) -> SdfPack:
    """The tables (K3's bf16; the fp32 tables themselves for the concat
    variant) and, on a card, the variant's packed weights (and
    descriptor); raises for a network the JAX package cannot run either."""
    concat = net.cfg.fine.concat_coarse_feature
    tables = ({n: getattr(net, n).encoding.detach() for n in ("coarse", "fine")}
              if concat else fields.pack_combine_tables(net))
    if tables["coarse"].device.type == "cpu":
        return SdfPack(tables, None, "concat" if concat else "shipped")
    variant = check_sdf_network(net.cfg)
    if variant == "shipped":
        return SdfPack(tables, pack_sdf_weights(net), variant)
    weights, desc = pack_general(net)
    return SdfPack(tables, weights, variant, desc)


def general_plan(pack: SdfPack) -> Tuple[int, int, int]:
    """(points per tile, shared-memory bytes, floats of weights held in
    shared memory) that the general kernel takes for this pack on the
    current card; (0, -1, 0) when its activations do not fit."""
    tile, nbytes, w_smem = ctypes.c_int(), ctypes.c_int64(), ctypes.c_int()
    rc = _cuda.library().nsl_sdf_density_general_plan(
        np.ascontiguousarray(pack.desc, np.int32).ctypes.data, pack.weights.numel(),
        ctypes.byref(tile), ctypes.byref(nbytes), ctypes.byref(w_smem))
    if rc != 0:
        raise RuntimeError(f"nsl_sdf_density_general_plan: CUDA error {rc}")
    return tile.value, nbytes.value, w_smem.value


@functools.lru_cache(maxsize=8)
def _linspace(res: int, device: str) -> torch.Tensor:
    """The grid's coordinates, torch's own linspace (which fills its second
    half from the end: -1 + i·step is not the same bits)."""
    return torch.linspace(-1.0, 1.0, res, dtype=torch.float32, device=device)


def _scalar(v, dev, name: str) -> Optional[torch.Tensor]:
    if v is None:
        return None
    t = torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1).contiguous()
    _cuda.check(t, name, torch.float32, (1,), device=dev)
    return t


def _launch(net, pack: SdfPack, N: int, out: torch.Tensor, voxels, beta, beta_scale,
            voxel_res: int, xs=None, res: int = 0, o=None, d=None, z=None, S: int = 0):
    variant = check_sdf_network(net.cfg)
    if variant != pack.variant:
        raise ValueError(f"sdf_density: a {pack.variant} pack for a {variant} network")
    dev = out.device
    if pack.weights is None:
        raise ValueError("sdf_density: the pack holds no weights (pack_sdf on the card)")
    general = pack.variant != "shipped"
    if general:
        index, _ = _general_layout(net.cfg)
        _cuda.check(pack.weights, "weights", torch.float32, (index.size,), device=dev)
        if general_plan(pack)[0] == 0:
            raise ValueError("sdf_density: the network's activations do not fit in the "
                             "general kernel's shared memory at 32 points a tile")
    else:
        _cuda.check(pack.weights, "weights", torch.float32,
                    (packed_floats(net.cfg.coarse.layer_dims)
                     + packed_floats(net.cfg.fine.layer_dims),), device=dev)
    tab_dtype = torch.float32 if pack.variant == "concat" else torch.bfloat16
    tabs = {}
    for name in ("coarse", "fine"):
        spec = getattr(net, name).spec
        t = pack.tables[name]
        _cuda.check(t, f"table {name}", tab_dtype,
                    (spec.total_entries, spec.level_dim), device=dev)
        if t.data_ptr() % 16:
            raise ValueError(f"table {name}: the row loads need a 16-byte aligned table")
        tabs[name] = (t, *he._level_tables(spec, 1.0, str(dev)))
    if pack.weights.data_ptr() % 16:
        raise ValueError("weights: the kernel copies them as float4")
    beta_t, scale_t = _scalar(beta, dev, "beta"), _scalar(beta_scale, dev, "beta_scale")
    if beta_t is None and voxels is None:
        raise ValueError("sdf_density: pass the voxel counter or the learned beta")
    if beta_t is None:
        if voxel_res ** 3 >= 2 ** 31:
            raise ValueError(f"voxel_res {voxel_res} exceeds the kernel's 32-bit index")
        _cuda.check(voxels, "voxels", torch.float32, (voxel_res,) * 3, device=dev)
    (tc, mc, sc), (tf, mf, sf) = tabs["coarse"], tabs["fine"]
    mode = "grid" if xs is not None else "rays"
    tail = (_cuda.ptr(xs), res, _cuda.ptr(o), _cuda.ptr(d), _cuda.ptr(z), S,
            None if beta_t is not None else voxels.data_ptr(), voxel_res,
            density_ops.NEG_B_1E4, density_ops.BETA_D, density_ops.BETA_A,
            density_ops.BETA_C, _cuda.ptr(beta_t), _cuda.ptr(scale_t), out.data_ptr(), N)
    grids = (tc.data_ptr(), mc.data_ptr(), sc.data_ptr(), tf.data_ptr(), mf.data_ptr(),
             sf.data_ptr())
    if general:
        desc = np.ascontiguousarray(pack.desc, np.int32)
        _cuda.launch(f"sdf_density_{pack.variant}.{mode}", "nsl_sdf_density_general", N,
                     desc.ctypes.data, pack.weights.data_ptr(), pack.weights.numel(), *grids,
                     int(pack.variant == "concat"), *tail)
    else:
        _cuda.launch(f"sdf_density.{mode}", "nsl_sdf_density", N, pack.weights.data_ptr(),
                     *grids, *tail)
    return out


@torch.no_grad()
def density_grid(net: fields.CombineNet, pack: SdfPack, res: int,
                 voxels: Optional[torch.Tensor], beta: Optional[torch.Tensor] = None,
                 beta_scale=None, voxel_res: int = 64) -> torch.Tensor:
    """K6 grid mode: the density [res³] at every point of the
    ``linspace(-1, 1, res)³`` grid, flat index ``(i·res + j)·res + k``.
    ``beta`` (volsdf_laplace's learned β) or else ``voxels``. Plain version
    on CPU tables, one kernel launch on CUDA ones. Not for
    concat_coarse_feature (the JAX package's ``build_density_cache`` fails
    there with a shape error in ``combine_sdf_packed``)."""
    if net.cfg.fine.concat_coarse_feature:
        raise ValueError("density_grid: concat_coarse_feature has no density cache (the JAX "
                         "package's build_density_cache fails there with a shape error)")
    if not _cuda.on_card("density_grid", pack.tables["coarse"]):
        return density_grid_plain(net, pack.tables, res, voxels, beta, beta_scale, voxel_res)
    dev = pack.tables["coarse"].device
    out = torch.empty((res ** 3,), dtype=torch.float32, device=dev)
    return _launch(net, pack, res ** 3, out, voxels, beta, beta_scale, voxel_res,
                   xs=_linspace(res, str(dev)), res=res)


@torch.no_grad()
def density_rays(net: fields.CombineNet, pack: SdfPack, o: torch.Tensor,
                 d: torch.Tensor, z: torch.Tensor, voxels: Optional[torch.Tensor],
                 beta: Optional[torch.Tensor] = None, beta_scale=None,
                 voxel_res: int = 64) -> torch.Tensor:
    """K6 ray mode: the density [R, S] at o + z·d for rays o, d [R, 3] and
    z [R, S] (the kernel rounds the product and the sum as torch does).
    Plain version on CPU tensors, one kernel launch on CUDA ones."""
    if not _cuda.on_card("density_rays", z):
        return density_rays_plain(net, pack.tables, o, d, z, voxels, beta, beta_scale,
                                  voxel_res)
    R, S = z.shape
    o, d, z = o.detach().contiguous(), d.detach().contiguous(), z.detach().contiguous()
    _cuda.check(o, "o", torch.float32, (R, 3))
    _cuda.check(d, "d", torch.float32, (R, 3), device=o.device)
    _cuda.check(z, "z", torch.float32, (R, S), device=o.device)
    out = torch.empty((R, S), dtype=torch.float32, device=z.device)
    return _launch(net, pack, R * S, out, voxels, beta, beta_scale, voxel_res,
                   o=o, d=d, z=z, S=S)
