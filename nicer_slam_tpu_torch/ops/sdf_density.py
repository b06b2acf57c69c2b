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
prepass). On a CPU tensor both run ``sdf_density_plain``, the composition
the port ran before the kernel: K3 through ``fields.combine_sdf_packed``,
the MLPs, K7's read and the Laplace density. On a CUDA tensor each is one
launch of ``csrc/sdf_density.cu``, which serves the one SDF network that
every shipped configuration uses (``check_sdf_network``) and raises for
any other; it never falls back to the plain version.

The kernel reads the weight-normed layers as their effective weights
``g·v/‖v‖``, computed once per pack (``pack_sdf_weights``, as
``WNLinear.forward`` computes them, so the same bits as the plain
version's) and laid out for its register-blocked products: each hidden
layer transposed ``[in][64]`` with its units in the order
``q -> q//4 + 16·(q % 4)`` (a thread's 4 units are one float4), and of
each last layer only row 0, the SDF. The note at the top of the CUDA
source has the design and its error budget.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

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


class SdfPack(NamedTuple):
    """What K6 reads of the SDF network, packed once per cache build or per
    render: the grids' bf16 tables and, on a card, the packed weights."""

    tables: Dict[str, torch.Tensor]        # fields.pack_combine_tables
    weights: Optional[torch.Tensor]        # pack_sdf_weights (None on the CPU)


def check_sdf_network(cfg: fields.CombineConfig) -> None:
    """Raise ValueError unless the kernel serves this SDF network."""
    for name in ("coarse", "fine"):
        c = getattr(cfg, name)
        dims = c.layer_dims
        hidden = dims[1:-1]
        L, C = KERNEL_GRID[name]
        ok = (c.d_in == 3 and not c.skip_in and c.multires == KERNEL_MULTIRES
              and c.use_grid_feature and not (c.clamp and name == "fine")
              and c.divide_factor == 1.0 and c.num_levels == L and c.level_dim == C
              and len(hidden) == KERNEL_HIDDEN[name]
              and all(h == KERNEL_WIDTH for h in hidden))
        if not ok:
            raise ValueError(
                f"sdf_density kernel serves the shipped SDF network only; got the "
                f"{name} network with layer dims {dims}, skip_in {c.skip_in}, "
                f"multires {c.multires}, grid {c.num_levels} x {c.level_dim} "
                f"(features {c.use_grid_feature}), divide_factor {c.divide_factor}, "
                f"clamp {c.clamp}; expected {KERNEL_HIDDEN[name]} hidden layers of "
                f"{KERNEL_WIDTH}, no skip_in, multires {KERNEL_MULTIRES}, grid "
                f"{L} x {C}, divide_factor 1, no clamp")


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


def sdf_density_plain(net: fields.CombineNet, tables: Dict[str, torch.Tensor],
                      x: torch.Tensor, voxels: Optional[torch.Tensor],
                      beta: Optional[torch.Tensor] = None, beta_scale=None,
                      voxel_res: int = 64) -> torch.Tensor:
    """Plain version of K6 at points x [N, 3]: the SDF from the bf16 tables
    (K3) and the MLPs, then ``density_from_sdf``."""
    sdf = fields.combine_sdf_packed(net, tables, x, "fine")
    return density_from_sdf(sdf, x, voxels, beta, beta_scale, voxel_res)


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
    """The tables (K3's bf16) and, on a card, the packed weights; raises on
    a card for a network the kernel does not serve."""
    tables = fields.pack_combine_tables(net)
    if tables["coarse"].device.type == "cpu":
        return SdfPack(tables, None)
    check_sdf_network(net.cfg)
    return SdfPack(tables, pack_sdf_weights(net))


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
    check_sdf_network(net.cfg)
    dev = out.device
    if pack.weights is None:
        raise ValueError("sdf_density: the pack holds no weights (pack_sdf on the card)")
    _cuda.check(pack.weights, "weights", torch.float32,
                (packed_floats(net.cfg.coarse.layer_dims)
                 + packed_floats(net.cfg.fine.layer_dims),), device=dev)
    tabs = {}
    for name in ("coarse", "fine"):
        spec = getattr(net, name).spec
        t = pack.tables[name]
        _cuda.check(t, f"table {name}", torch.bfloat16,
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
    _cuda.launch("sdf_density.grid" if xs is not None else "sdf_density.rays",
                 "nsl_sdf_density", N, pack.weights.data_ptr(),
                 tc.data_ptr(), mc.data_ptr(), sc.data_ptr(), tf.data_ptr(),
                 mf.data_ptr(), sf.data_ptr(), _cuda.ptr(xs), res, _cuda.ptr(o),
                 _cuda.ptr(d), _cuda.ptr(z), S,
                 None if beta_t is not None else voxels.data_ptr(), voxel_res,
                 density_ops.NEG_B_1E4, density_ops.BETA_D, density_ops.BETA_A,
                 density_ops.BETA_C, _cuda.ptr(beta_t), _cuda.ptr(scale_t),
                 out.data_ptr(), N)
    return out


@torch.no_grad()
def density_grid(net: fields.CombineNet, pack: SdfPack, res: int,
                 voxels: Optional[torch.Tensor], beta: Optional[torch.Tensor] = None,
                 beta_scale=None, voxel_res: int = 64) -> torch.Tensor:
    """K6 grid mode: the density [res³] at every point of the
    ``linspace(-1, 1, res)³`` grid, flat index ``(i·res + j)·res + k``.
    ``beta`` (volsdf_laplace's learned β) or else ``voxels``. Plain version
    on CPU tables, one kernel launch on CUDA ones."""
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
