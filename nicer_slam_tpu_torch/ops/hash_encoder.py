"""Multiresolution hash-grid encoder (counterpart of
nicer_slam_tpu/ops/hash_encoder.py): kernels K1 and K2.

  * ``hash_encode_with_grad`` (K1): features ``[N, L·C]`` and the analytic
    input Jacobian ``dfeat/dx [N, L·C, 3]`` from one gather; used by the
    coarse and fine SDF grids, whose eikonal/normal losses differentiate the
    SDF gradient. ``dfeat`` is an output, so the outer loss needs only a
    first-order backward of this op (table scatter + grad_x through the
    second derivative of smoothstep).
  * ``hash_encode`` (K2): features only; the color grid (16 levels × 2
    channels, 2^24-entry hashed levels) and the SDF grids' plain forward.
  * ``hash_encode_bf16`` (K3): features only, no gradient, from a table
    rounded to bfloat16 (``pack_table_bf16``, ``[T, C]``), the JAX
    package's packed-bf16 inference encode: the SDF grids in the plain
    version of K6 (``ops/sdf_density``); on the card K6's kernel gathers
    the same features itself, with K3's row loader and geometry
    (``csrc/hash_grid.cuh``).
  * ``hash_encode_sharded``: the colour grid under the ``sharded``
    collective mode (``parallel/mesh.py``), from this rank's rows of the
    table: K3 on the rows all-gathered in bf16 forward, K2's backward on
    the same bf16 rows (``hash_encode_bf16_bwd_launch``) and a bf16
    reduce-scatter of the table gradient backward.

Tables are ``[T, C]`` float32 (a corner's C channels are one row), the
transpose of the JAX package's ``[C, T]``; ``slam/checkpoint.py``
transposes at the file boundary, so checkpoints keep the JAX layout.

All share a plain PyTorch version (``hash_encode_plain``), which the
wrapper runs for a CPU tensor, and a CUDA kernel (``csrc/hash_encoder.cu``),
which it launches for a CUDA tensor. The TPU package's row gathers, cell-block tables, sorted
scatters, uint32 channel-pair packing and ICI-only gather modes are TPU workarounds and
have no counterpart here: on the card the backward is an atomic scatter in 64-bit
fixed point (integer adds land in any order with the same sum, so the
table gradient is the same from run to run, as XLA's scatter is), into an
accumulator kept per (device, size) that each call leaves zero
(``fixed_point_scratch``), and a corner is one vector load of a
``[T, C]`` row.

On the card K1/K2 are bound by bytes: the Jacobian and cotangent tiles
they stream and the random corner rows they gather and scatter. A block
is 32 consecutive points × L levels, one warp per level (a level of more
than 8 channels takes a warp per segment of them, and a grid of more than
32 such warps runs as several launches); its output and
cotangent tiles pass through shared memory to move as coalesced runs.
One backward design serves every channel count: it sums the lanes that
share a cell before its atomics (a segment's channels of a row on
adjacent lanes, one request), takes one fixed-point exponent a level from
one maxima pass over the whole grid, and converts the accumulator in one
last pass a grid, over only the rows its scatter marked in a bitmap where
the table is larger than the points reach (the colour grid). The table
scatter is skipped when the table needs no gradient (tracking). K3 is the
same forward kernel with a bf16 row loader; the note at the top of
csrc/hash_encoder.cu has more.

Semantics (reference hashencoder.cu): level l has ``scale =
2^(l·log2 pls)·H − 1`` and resolution ``ceil(scale) + 1``; table sizes use
the allocator's resolution ``ceil(H·pls^l)`` (``make_spec`` keeps both);
dense index ``x + y·res + z·res²`` or hashed ``xor(x·1, y·2654435761,
z·805459861)``, mod the level size, in uint32 arithmetic; smoothstep
weights; inputs outside [0, 1] give 0.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _cuda

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class HashGridSpec(NamedTuple):
    input_dim: int
    num_levels: int
    level_dim: int
    per_level_scale: float
    base_resolution: int
    log2_hashmap_size: int
    offsets: Tuple[int, ...]
    resolutions: Tuple[int, ...]
    scales: Tuple[float, ...]
    dense: Tuple[bool, ...]

    @property
    def total_entries(self) -> int:
        return self.offsets[-1]


def make_spec(input_dim: int = 3, num_levels: int = 16, level_dim: int = 2,
              per_level_scale: float = 2.0, base_resolution: int = 16,
              log2_hashmap_size: int = 19,
              desired_resolution: int | None = None) -> HashGridSpec:
    """As the reference: ``desired_resolution`` overrides per_level_scale;
    the allocator's resolution sizes each level, the kernel's addresses it."""
    if desired_resolution is not None and num_levels > 1:
        per_level_scale = float(np.exp2(
            np.log2(desired_resolution / base_resolution) / (num_levels - 1)))
    max_params = 2 ** log2_hashmap_size
    offsets, resolutions, scales, dense = [0], [], [], []
    S = math.log2(per_level_scale)
    for lvl in range(num_levels):
        alloc_res = int(np.ceil(base_resolution * per_level_scale ** lvl))
        scale = math.exp2(lvl * S) * base_resolution - 1.0
        kern_res = int(math.ceil(scale)) + 1
        params_in_level = min(max_params, alloc_res ** input_dim)
        offsets.append(offsets[-1] + params_in_level)
        resolutions.append(kern_res)
        scales.append(scale)
        dense.append(kern_res ** input_dim <= params_in_level)
    return HashGridSpec(input_dim, num_levels, level_dim, per_level_scale,
                        base_resolution, log2_hashmap_size, tuple(offsets),
                        tuple(resolutions), tuple(scales), tuple(dense))


def init_hash_params(rng: np.random.Generator, spec: HashGridSpec) -> np.ndarray:
    """U(-1e-4, 1e-4) table, drawn from the same numpy stream as the
    reference package (float32, ``[C, T]``), returned as this package's
    ``[T, C]``."""
    table = rng.uniform(-1e-4, 1e-4, (spec.level_dim, spec.total_entries))
    return np.ascontiguousarray(table.astype(np.float32).T)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _level_rows(spec: HashGridSpec, lvl: int, corner: torch.Tensor) -> torch.Tensor:
    """Integer corners [8, N, 3] (int64) -> global table rows [8, N], with
    the uint32 wrap of the reference emulated in int64 masked to 32 bits
    (int64 products wrap mod 2^64, which keeps the low 32 bits exact)."""
    size = spec.offsets[lvl + 1] - spec.offsets[lvl]
    c = corner & _U32
    if spec.dense[lvl]:
        res = spec.resolutions[lvl]
        idx = (c[..., 0] + c[..., 1] * res + c[..., 2] * (res * res)) & _U32
    else:
        idx = c[..., 0] * _PRIMES[0]
        for d in (1, 2):
            idx = idx ^ ((c[..., d] * _PRIMES[d]) & _U32)
        idx = idx & _U32
    return idx % size + spec.offsets[lvl]


_CORNER_BITS = [[(k >> d) & 1 for d in range(3)] for k in range(8)]


def hash_encode_plain(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                      size: float = 1.0, jacobian: bool = False):
    """Plain version of K2 (``jacobian`` False: [N, 3] -> [N, L·C]) and K1
    (-> feats, dfeat/dx [N, L·C, 3]) from a ``[T, C]`` table; autograd
    differentiates every output, second order included."""
    u = (x + size) / (2.0 * size)
    oob = ((u < 0.0) | (u > 1.0)).any(dim=-1)
    bits = torch.tensor(_CORNER_BITS, dtype=torch.int64, device=x.device)
    chain = 1.0 / (2.0 * size)
    outs, douts = [], []
    for lvl in range(spec.num_levels):
        scale = spec.scales[lvl]
        pos = u * scale
        left = torch.floor(pos).detach()
        f = pos - left
        wb = f * f * (3.0 - 2.0 * f)                        # [N, 3]
        wa = 1.0 - wb
        dwb = 6.0 * f * (1.0 - f) * (scale * chain)
        corner = left.to(torch.int64)[None] + bits[:, None, :]   # [8, N, 3]
        rows = _level_rows(spec, lvl, corner)                     # [8, N]
        vals = table[rows]                                        # [8, N, C]
        sels = [torch.where(bits[:, None, d] == 1, wb[None, :, d], wa[None, :, d])
                for d in range(3)]                                # [8, N] each
        w = sels[0] * sels[1] * sels[2]
        outs.append(torch.einsum("kn,knc->nc", w, vals))
        if jacobian:
            dsels = [torch.where(bits[:, None, d] == 1, dwb[None, :, d],
                                 -dwb[None, :, d]) for d in range(3)]
            dws = [dsels[0] * sels[1] * sels[2], dsels[1] * sels[0] * sels[2],
                   dsels[2] * sels[0] * sels[1]]
            douts.append(torch.stack(
                [torch.einsum("kn,knc->nc", dw, vals) for dw in dws], dim=2))
    feats = torch.where(oob[:, None], 0.0, torch.cat(outs, dim=-1))
    if not jacobian:
        return feats
    dfeat = torch.where(oob[:, None, None], 0.0, torch.cat(douts, dim=1))
    return feats, dfeat


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/hash_encoder.cu)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _level_tables(spec: HashGridSpec, size: float, device: str):
    """Per-level kernel constants on the device: int32 [L, 4] {offset, size,
    resolution, dense} and float32 [L, 2] {scale, scale·chain}."""
    meta = np.array([[spec.offsets[l], spec.offsets[l + 1] - spec.offsets[l],
                      spec.resolutions[l], int(spec.dense[l])]
                     for l in range(spec.num_levels)], np.int32)
    chain = 1.0 / (2.0 * size)
    scl = np.array([[s, s * chain] for s in spec.scales], np.float32)
    return (torch.from_numpy(meta).to(device), torch.from_numpy(scl).to(device))


# K1/K2 take any level and channel count: a level's channels are walked in
# segments of at most 8 (one warp each), and a grid of more than 32
# (level, segment) pairs runs as several launches, grad_x summed over them
# in order (csrc/hash_kernels.cuh). K3 (the bf16 rows) takes any even C,
# as the JAX package's packed encode does.


def _check_spec(spec: HashGridSpec, bf16: bool = False):
    """Raise where the JAX package does: a grid over other than 3 inputs,
    and an odd channel count for the bf16 encode (hash_encode_packed
    asserts an even C)."""
    L, C = spec.num_levels, spec.level_dim
    ok_c = C >= 2 and C % 2 == 0 if bf16 else C >= 1
    if spec.input_dim != 3 or not ok_c or L < 1:
        raise ValueError(f"kernel supports input_dim 3, at least one level and "
                         f"{'an even C' if bf16 else 'C >= 1'}, got {spec.input_dim}, "
                         f"{C}, {L}")


def _check_operands(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor):
    _check_spec(spec)
    _cuda.check(x, "x", torch.float32, (x.shape[0], 3))
    _cuda.check(table, "table", torch.float32,
                (spec.total_entries, spec.level_dim), device=x.device)
    if table.data_ptr() % 16:
        raise ValueError("table: the kernel's vector row loads need a 16-byte "
                         "aligned table")


def hash_encode_fwd_launch(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                           size: float, feats: torch.Tensor,
                           dfeat: torch.Tensor | None = None) -> None:
    """One launch of the forward kernel into preallocated outputs: K1 with
    ``dfeat`` [N, L·C, 3], K2 without. Operands as ``_check_operands``."""
    N, L, C = x.shape[0], spec.num_levels, spec.level_dim
    meta, scl = _level_tables(spec, float(size), str(x.device))
    _cuda.check(feats, "feats", torch.float32, (N, L * C), device=x.device)
    if dfeat is not None:
        _cuda.check(dfeat, "dfeat", torch.float32, (N, L * C, 3), device=x.device)
    _cuda.launch("hash_encode_with_grad.fwd" if dfeat is not None else "hash_encode.fwd",
                 "nsl_hash_encode_fwd", N, x.data_ptr(), table.data_ptr(),
                 meta.data_ptr(), scl.data_ptr(), feats.data_ptr(), _cuda.ptr(dfeat),
                 N, L, C, float(size))


# (device, words) -> the backward's fixed-point accumulator, level maxima
# and bitmap, zero between calls
_SCRATCH: Dict[Tuple[str, int], torch.Tensor] = {}


def fixed_point_words(spec: HashGridSpec) -> int:
    """The int64 words of a grid's ``fixed_point_scratch``."""
    T, C, L = spec.total_entries, spec.level_dim, spec.num_levels
    return T * C + max(L, 32) + (T + 63) // 64


def fixed_point_scratch(spec: HashGridSpec, device) -> torch.Tensor:
    """The K1/K2 backward's fixed-point state for a grid's size: ``[T·C +
    max(L, 32) + ceil(T / 64)]`` int64, kept per (device, size) and zeroed
    once, when it is allocated. The first T·C words are the accumulator;
    the max(L, 32) words after them hold the grid's 2·L level maxima of
    the cotangents (uint32 each: one pass over the whole grid, so every
    segment of a level takes the level's one exponent); the last ceil(T /
    64) are a bitmap of the rows a launch touched (the colour grid's
    scatter marks them, and its last pass converts those rows alone). Each
    backward launch with a table gradient leaves all three zero. The
    launches that share it run one after another, on one stream, as the
    paths run."""
    key = (str(torch.device(device)), fixed_point_words(spec))
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH[key] = torch.zeros(key[1], dtype=torch.int64, device=device)
    return buf


def fixed_point_state_is_zero(scratch: torch.Tensor) -> bool:
    """Whether the accumulator, the level maxima and the touched-row bitmap
    of a ``fixed_point_scratch`` are all zero, as every launch must leave
    them."""
    return not bool(scratch.any())


def _fixed_exp(gf: torch.Tensor, gd: torch.Tensor | None, dscale: float, count_bits: int):
    """A level's fixed-point exponent k as the kernel takes it (csrc/
    hash_kernels.cuh fixed_exp) from its cotangents gf [N, C] and gd
    [N, C, 3] (or None): the bound max|gf| + 1.5 |dscale| max sum_d |gd_d|
    in float32, each step rounded; None for a non-finite bound."""
    f32 = np.float32
    mf = f32(gf.abs().max().item()) if gf.numel() else f32(0.0)
    md = f32(0.0)
    if gd is not None and gd.numel():
        a = gd.abs()
        md = f32(((a[..., 0] + a[..., 1]) + a[..., 2]).max().item())
    with np.errstate(over="ignore", invalid="ignore"):
        bound = mf + (f32(1.5) * f32(abs(dscale))) * md
    if not np.isfinite(bound):
        return None
    if bound == 0:
        return 0
    return 61 - count_bits - math.frexp(float(bound))[1]


def hash_table_grad_fixed_plain(spec: HashGridSpec, x: torch.Tensor, g_feat: torch.Tensor,
                                g_dfeat: torch.Tensor | None = None,
                                size: float = 1.0) -> torch.Tensor:
    """Plain version of the table gradient of the K1/K2 backward at every
    C (``hash_bwd_merge_kernel`` in csrc/hash_kernels.cuh), bit for bit:
    g_table [T, C] float32 of the cotangents ``g_feat`` [N, L·C] and
    ``g_dfeat`` [N, L·C, 3] (K1) or None (K2) at points ``x`` [N, 3].

    The same arithmetic in the same order: blocks of 32 points; each
    corner's contribution g_feat w + g_dfeat_0 dw_0 + g_dfeat_1 dw_1 +
    g_dfeat_2 dw_2, each product and sum rounded to float32; the lanes of
    a run (in range and in one cell as the lane before) summed in lane
    order into its head; each head's corner sums rounded once to the
    level's fixed point (2^-k, k from the cotangents' bound) and added as
    int64 (``index_add_``: integer sums in any order); then acc 2^-k as
    float32, NaN in every row and column of a level whose cotangents are
    not finite. The kernel walks a level of more than 8 channels in
    segments, each a warp; the runs and the level's exponent are the same
    in every segment, so the sums are these. Within float32 rounding of
    autograd of ``hash_encode_plain``."""
    N, L, C, T = x.shape[0], spec.num_levels, spec.level_dim, spec.total_entries
    dev, f32 = x.device, torch.float32
    scl = _level_tables(spec, float(size), str(dev))[1].cpu()
    count_bits = 0
    while (1 << count_bits) < 8 * N:
        count_bits += 1
    gf = g_feat.reshape(N, L, C)
    gd = g_dfeat.reshape(N, L, C, 3) if g_dfeat is not None else None
    size32 = float(np.float32(size))
    u = (x + size32) / float(np.float32(2.0) * np.float32(size))
    inr = ((u >= 0.0) & (u <= 1.0)).all(-1)
    bits = torch.tensor(_CORNER_BITS, dtype=torch.int64, device=dev)      # [8, 3]
    B = (N + 31) // 32
    pad = B * 32 - N
    act = torch.cat([inr, torch.zeros(pad, dtype=torch.bool, device=dev)]).view(B, 32)
    acc = torch.zeros(T * C, dtype=torch.int64, device=dev)
    ks = []
    for lvl in range(L):
        s32, ds32 = float(scl[lvl, 0]), float(scl[lvl, 1])
        k = _fixed_exp(gf[:, lvl], gd[:, lvl] if gd is not None else None, ds32, count_bits)
        ks.append(k)
        if k is None:
            continue
        pos = u * s32
        left = torch.floor(pos)
        f = pos - left
        wb = f * f * (3.0 - 2.0 * f)
        wa = 1.0 - wb
        dwb = 6.0 * f * (1.0 - f) * ds32
        sels = [torch.where(bits[:, None, d] == 1, wb[None, :, d], wa[None, :, d])
                for d in range(3)]                                         # [8, N]
        dsels = [torch.where(bits[:, None, d] == 1, dwb[None, :, d], -dwb[None, :, d])
                 for d in range(3)]
        w = sels[0] * sels[1] * sels[2]
        t = gf[None, :, lvl] * w[..., None]                                # [8, N, C]
        if gd is not None:
            dws = (dsels[0] * sels[1] * sels[2], dsels[1] * sels[0] * sels[2],
                   dsels[2] * sels[0] * sels[1])
            for d in range(3):
                t = t + gd[None, :, lvl, :, d] * dws[d][..., None]
        t = torch.cat([t.permute(1, 0, 2), t.new_zeros(pad, 8, C)]).view(B, 32, 8, C)
        lf = torch.cat([left.to(torch.int64),
                        torch.zeros((pad, 3), dtype=torch.int64, device=dev)]).view(B, 32, 3)
        # runs: lanes in one cell as the lane before, summed in lane order
        cont = torch.zeros_like(act)
        cont[:, 1:] = act[:, 1:] & act[:, :-1] & (lf[:, 1:] == lf[:, :-1]).all(-1)
        head = act & ~cont
        run = t.clone()
        for p in range(1, 32):
            run[:, p] = torch.where(cont[:, p, None, None], run[:, p - 1] + t[:, p], t[:, p])
        last = act & ~torch.cat([cont[:, 1:], torch.zeros_like(cont[:, :1])], 1)
        # each head's corner sums: one fixed-point add a row and channel
        bi, li = torch.nonzero(last, as_tuple=True)
        hb, hl = torch.nonzero(head, as_tuple=True)       # the same runs, in order
        q = torch.round(run[bi, li].double() * 2.0 ** k).to(torch.int64)     # [n, 8, C]
        rows = _level_rows(spec, lvl, lf[hb, hl][:, None, :] + bits[None])    # [n, 8]
        acc.index_add_(0, (rows[..., None] * C + torch.arange(C, device=dev)).reshape(-1),
                       q.reshape(-1))
    g = acc.view(T, C).to(f32)
    for lvl, k in enumerate(ks):
        r0, r1 = spec.offsets[lvl], spec.offsets[lvl + 1]
        g[r0:r1] = (float("nan") if k is None
                    else (g[r0:r1].double() * 2.0 ** -k).to(f32))
    return g


def hash_encode_bwd_launch(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                           size: float, jacobian: bool, g_feat: torch.Tensor,
                           g_dfeat: torch.Tensor | None, g_table: torch.Tensor | None,
                           g_x: torch.Tensor | None) -> None:
    """One launch of the backward kernel (K1's if ``jacobian``, else K2's):
    writes ``g_table`` [T, C], summed in fixed point so that it is the same
    bit for bit from run to run, and ``g_x`` [N, 3]; either may be None (not
    needed). ``g_dfeat`` None leaves out the Jacobian's cotangent."""
    N, L, C, T = x.shape[0], spec.num_levels, spec.level_dim, spec.total_entries
    meta, scl = _level_tables(spec, float(size), str(x.device))
    _cuda.check(g_feat, "g_feat", torch.float32, (N, L * C), device=x.device)
    if g_dfeat is not None:
        _cuda.check(g_dfeat, "g_dfeat", torch.float32, (N, L * C, 3), device=x.device)
    scratch = None
    if g_table is not None:
        _cuda.check(g_table, "g_table", torch.float32, tuple(table.shape), device=x.device)
        scratch = fixed_point_scratch(spec, x.device)
    if g_x is not None:
        _cuda.check(g_x, "g_x", torch.float32, (N, 3), device=x.device)
    try:
        _cuda.launch("hash_encode_with_grad.bwd" if jacobian else "hash_encode.bwd",
                     "nsl_hash_encode_bwd", N, x.data_ptr(), table.data_ptr(),
                     meta.data_ptr(), scl.data_ptr(), g_feat.data_ptr(),
                     _cuda.ptr(g_dfeat), _cuda.ptr(g_table), _cuda.ptr(g_x),
                     _cuda.ptr(scratch), N, L, C, float(size), T)
    except RuntimeError:
        # a launch that failed may have left sums behind: the next call
        # starts from fresh zero accumulators
        _SCRATCH.clear()
        raise


class _HashEncodeCUDA(torch.autograd.Function):
    """K1 (jacobian=True) / K2 (jacobian=False) on the card."""

    @staticmethod
    def forward(ctx, x, table, spec, size, jacobian):
        N, L, C = x.shape[0], spec.num_levels, spec.level_dim
        feats = torch.empty((N, L * C), dtype=torch.float32, device=x.device)
        dfeat = (torch.empty((N, L * C, 3), dtype=torch.float32, device=x.device)
                 if jacobian else None)
        hash_encode_fwd_launch(spec, table, x, size, feats, dfeat)
        ctx.save_for_backward(x, table)
        ctx.spec, ctx.size, ctx.jacobian = spec, float(size), jacobian
        ctx.set_materialize_grads(False)
        return (feats, dfeat) if jacobian else feats

    @staticmethod
    @once_differentiable
    def backward(ctx, g_feat, g_dfeat=None):
        x, table = ctx.saved_tensors
        need_x, need_t = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        spec = ctx.spec
        N, L, C = x.shape[0], spec.num_levels, spec.level_dim
        if not (need_x or need_t) or (g_feat is None and g_dfeat is None):
            return None, None, None, None, None
        g_feat = (torch.zeros((N, L * C), dtype=torch.float32, device=x.device)
                  if g_feat is None else g_feat.contiguous())
        if g_dfeat is not None:
            g_dfeat = g_dfeat.contiguous()
        g_table = torch.empty_like(table) if need_t else None
        g_x = (torch.empty((N, 3), dtype=torch.float32, device=x.device)
               if need_x else None)
        hash_encode_bwd_launch(spec, table, x, ctx.size, ctx.jacobian, g_feat, g_dfeat,
                               g_table, g_x)
        return g_x, g_table, None, None, None


def _dispatch(spec, table, x, size, jacobian):
    if x.device.type == "cpu":
        return hash_encode_plain(spec, table, x, size, jacobian)
    if x.device.type != "cuda":
        raise ValueError(f"hash encode: unsupported device {x.device}")
    _check_operands(spec, table, x)
    return _HashEncodeCUDA.apply(x, table, spec, float(size), jacobian)


def hash_encode(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                size: float = 1.0) -> torch.Tensor:
    """K2: [N, 3] -> [N, L·C]. Plain version on CPU, kernel on CUDA."""
    return _dispatch(spec, table, x, size, jacobian=False)


def pack_table_bf16(table: torch.Tensor) -> torch.Tensor:
    """K3's table: ``[T, C]`` float32 -> ``[T, C]`` bfloat16, rounded to
    nearest-even (as the JAX package's ``astype(bfloat16)``)."""
    return table.detach().to(torch.bfloat16).contiguous()


def hash_encode_bf16_plain(spec: HashGridSpec, packed: torch.Tensor,
                           x: torch.Tensor, size: float = 1.0) -> torch.Tensor:
    """Plain version of K3: the K2 plain version on the widened table."""
    return hash_encode_plain(spec, packed.to(x.dtype), x, size)


def hash_encode_bf16(spec: HashGridSpec, packed: torch.Tensor, x: torch.Tensor,
                     size: float = 1.0) -> torch.Tensor:
    """K3: [N, 3] -> [N, L·C] from a ``pack_table_bf16`` table. No
    gradient: refuses inputs that require one. Plain version on CPU,
    kernel on CUDA."""
    if x.requires_grad or packed.requires_grad:
        raise ValueError("hash_encode_bf16 has no backward: call it on inputs "
                         "that require no gradient")
    if x.device.type == "cpu":
        return hash_encode_bf16_plain(spec, packed, x, size)
    if x.device.type != "cuda":
        raise ValueError(f"hash_encode_bf16: unsupported device {x.device}")
    _check_bf16_operands(spec, packed, x)
    meta, scl = _level_tables(spec, float(size), str(x.device))
    N, L, C = x.shape[0], spec.num_levels, spec.level_dim
    feats = torch.empty((N, L * C), dtype=torch.float32, device=x.device)
    _cuda.launch("hash_encode_bf16", "nsl_hash_encode_bf16_fwd", N, x.data_ptr(),
                 packed.data_ptr(), meta.data_ptr(), scl.data_ptr(), feats.data_ptr(),
                 N, L, C, float(size))
    return feats


def _check_bf16_operands(spec: HashGridSpec, packed: torch.Tensor, x: torch.Tensor):
    _check_spec(spec, bf16=True)
    _cuda.check(x, "x", torch.float32, (x.shape[0], 3))
    _cuda.check(packed, "packed", torch.bfloat16, (spec.total_entries, spec.level_dim),
                device=x.device)
    if packed.data_ptr() % 16:
        raise ValueError("packed: the kernel's row loads need a 16-byte aligned table")


# ---------------------------------------------------------------------------
# The sharded colour encode (the JAX package's "sharded" collective mode,
# nicer_slam_tpu/ops/hash_encoder.py:681-781): K3 forward and K2's backward
# on the bf16 rows the ranks all-gathered
# ---------------------------------------------------------------------------

def hash_encode_bf16_bwd_plain(spec: HashGridSpec, packed: torch.Tensor, x: torch.Tensor,
                               g_feat: torch.Tensor, size: float = 1.0,
                               table_grad: bool = True, x_grad: bool = True):
    """Plain version of K2's backward on bf16 rows: (g_table [T, C]
    float32, g_x [N, 3]) of ``sum(g_feat · hash_encode_plain(widened
    table, x))``, either None where not asked for."""
    with torch.enable_grad():
        table = packed.detach().to(torch.float32).requires_grad_(table_grad)
        xx = x.detach().requires_grad_(x_grad)
        wrt = [t for t, need in ((table, table_grad), (xx, x_grad)) if need]
        if not wrt:
            return None, None
        grads = list(torch.autograd.grad(hash_encode_plain(spec, table, xx, size), wrt,
                                         g_feat))
    return (grads.pop(0) if table_grad else None), (grads.pop(0) if x_grad else None)


def hash_encode_bf16_bwd_launch(spec: HashGridSpec, packed: torch.Tensor, x: torch.Tensor,
                                size: float, g_feat: torch.Tensor,
                                g_table: torch.Tensor | None,
                                g_x: torch.Tensor | None) -> None:
    """One launch of K2's backward on a ``[T, C]`` bf16 table into
    preallocated outputs: ``g_table`` [T, C] float32 (summed in fixed point
    in ``fixed_point_scratch``, bit for bit run to run) and ``g_x`` [N, 3];
    either may be None."""
    _check_bf16_operands(spec, packed, x)
    N, L, C, T = x.shape[0], spec.num_levels, spec.level_dim, spec.total_entries
    meta, scl = _level_tables(spec, float(size), str(x.device))
    _cuda.check(g_feat, "g_feat", torch.float32, (N, L * C), device=x.device)
    scratch = None
    if g_table is not None:
        _cuda.check(g_table, "g_table", torch.float32, (T, C), device=x.device)
        scratch = fixed_point_scratch(spec, x.device)
    if g_x is not None:
        _cuda.check(g_x, "g_x", torch.float32, (N, 3), device=x.device)
    try:
        _cuda.launch("hash_encode_bf16.bwd", "nsl_hash_encode_bf16_bwd", N, x.data_ptr(),
                     packed.data_ptr(), meta.data_ptr(), scl.data_ptr(), g_feat.data_ptr(),
                     _cuda.ptr(g_table), _cuda.ptr(g_x), _cuda.ptr(scratch), N, L, C,
                     float(size), T)
    except RuntimeError:
        _SCRATCH.clear()
        raise


class _HashEncodeSharded(torch.autograd.Function):
    """The colour grid from row shards: the forward gathers the whole
    table in bf16 and encodes with K3; the backward takes K2's backward on
    the same bf16 rows and reduce-scatters the bf16-rounded table gradient
    to the shards (the JAX package's _gcv_sharded_fwd / _gcv_sharded_bwd).
    The gathered table ([T, C] bf16) is the only whole copy of the table on
    a rank, kept from the forward to the backward's kernel."""

    @staticmethod
    def forward(ctx, x, shard_table, spec, size, shard):
        from ..parallel import mesh

        full = mesh.gather_table_rows(shard_table.detach().to(torch.bfloat16), shard)
        x = x.detach()
        feats = hash_encode_bf16(spec, full, x, size)
        ctx.save_for_backward(x)
        # an intermediate, kept on ctx so that the backward can free it
        # before the reduce-scatter
        ctx.full = full
        ctx.spec, ctx.size, ctx.shard = spec, float(size), shard
        return feats

    @staticmethod
    @once_differentiable
    def backward(ctx, g_feat):
        from ..parallel import mesh

        (x,) = ctx.saved_tensors
        full, ctx.full = ctx.full, None
        need_x, need_t = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        spec, size = ctx.spec, ctx.size
        g_feat = g_feat.contiguous()
        if x.device.type == "cpu":
            g_table, g_x = hash_encode_bf16_bwd_plain(spec, full, x, g_feat, size,
                                                      need_t, need_x)
        else:
            g_table = (torch.empty((spec.total_entries, spec.level_dim), dtype=torch.float32,
                                   device=x.device) if need_t else None)
            g_x = torch.empty_like(x) if need_x else None
            if need_t or need_x:
                hash_encode_bf16_bwd_launch(spec, full, x, size, g_feat, g_table, g_x)
        del full
        g_shard = None
        if need_t:
            # bf16 reduce-scatter straight back to this rank's rows; the
            # gathered table and the float32 whole are freed first
            g_bf16 = g_table.to(torch.bfloat16)
            del g_table
            g_shard = mesh.reduce_scatter_rows(g_bf16, ctx.shard).to(torch.float32)
        return g_x, g_shard, None, None, None


def hash_encode_sharded(spec: HashGridSpec, shard_table: torch.Tensor, x: torch.Tensor,
                        shard, size: float = 1.0) -> torch.Tensor:
    """The colour encode of the ``sharded`` collective mode: ``x`` [N, 3]
    (this rank's points) -> [N, L·C] from this rank's contiguous rows
    ``shard_table`` [T / W, C] of a grid split over W = ``shard.world``
    ranks (``parallel.mesh.shard_color_grid``). Every rank must call it,
    and its backward, together. Plain versions on CPU, K3 and K2's
    backward on bf16 rows on CUDA."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hash_encode_sharded: unsupported device {x.device}")
    _check_spec(spec, bf16=True)
    if shard_table.shape[0] * shard.world != spec.total_entries:
        raise ValueError(f"hash_encode_sharded: {shard_table.shape[0]} rows x {shard.world} "
                         f"ranks is not the grid's {spec.total_entries}")
    return _HashEncodeSharded.apply(x, shard_table, spec, float(size), shard)


def hash_encode_with_grad(spec: HashGridSpec, table: torch.Tensor,
                          x: torch.Tensor, size: float = 1.0):
    """K1: [N, 3] -> (feats [N, L·C], dfeat/dx [N, L·C, 3]), the chain
    factor scale/(2·size) included. Plain version on CPU, kernel on CUDA;
    the kernel's backward skips the table scatter when the table needs no
    gradient (tracking)."""
    return _dispatch(spec, table, x, size, jacobian=True)
