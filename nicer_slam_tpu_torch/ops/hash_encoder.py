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

Tables are ``[T, C]`` float32 (a corner's C channels are one row), the
transpose of the JAX package's ``[C, T]``; ``slam/checkpoint.py``
transposes at the file boundary, so checkpoints keep the JAX layout.

All share a plain PyTorch version (``hash_encode_plain``), which the
wrapper runs for a CPU tensor, and a CUDA kernel (``csrc/hash_encoder.cu``),
which it launches for a CUDA tensor. The TPU package's row gathers, cell-block tables, sorted
scatters, uint32 channel-pair packing and ICI modes are TPU workarounds and have no
counterpart here: on the card the backward is an atomic scatter in 64-bit
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
cotangent tiles pass through shared memory to move as coalesced runs,
lanes that share a corner row merge their gradients before one row of atomics,
and the table scatter is skipped when the table needs no gradient
(tracking). K3 is the same forward kernel with a bf16 row loader; the
note at the top of csrc/hash_encoder.cu has more.

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


# (device, words) -> the backward's fixed-point accumulator, zero between calls
_SCRATCH: Dict[Tuple[str, int], torch.Tensor] = {}


def fixed_point_scratch(spec: HashGridSpec, device) -> torch.Tensor:
    """The K1/K2 backward's fixed-point accumulator of a grid's size:
    ``[T·C + 32]`` int64, kept per (device, size) and zeroed once, when it
    is allocated. Each backward launch with a table gradient leaves its
    first T·C words zero (its last pass converts each row's sum and sets
    the row back to 0); the last 32 words hold the cotangent maxima of a
    slice of at most 32 (level, segment) pairs and are zeroed at the start
    of the next. The launches that share it run one after another, on one
    stream, as the paths run."""
    key = (str(torch.device(device)), spec.total_entries * spec.level_dim + 32)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH[key] = torch.zeros(key[1], dtype=torch.int64, device=device)
    return buf


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
    _check_spec(spec, bf16=True)
    N, L, C = x.shape[0], spec.num_levels, spec.level_dim
    _cuda.check(x, "x", torch.float32, (N, 3))
    _cuda.check(packed, "packed", torch.bfloat16, (spec.total_entries, C),
                device=x.device)
    if packed.data_ptr() % 16:
        raise ValueError("packed: the kernel's row loads need a 16-byte aligned table")
    meta, scl = _level_tables(spec, float(size), str(x.device))
    feats = torch.empty((N, L * C), dtype=torch.float32, device=x.device)
    _cuda.launch("hash_encode_bf16", "nsl_hash_encode_bf16_fwd", N, x.data_ptr(),
                 packed.data_ptr(), meta.data_ptr(), scl.data_ptr(), feats.data_ptr(),
                 N, L, C, float(size))
    return feats


def hash_encode_with_grad(spec: HashGridSpec, table: torch.Tensor,
                          x: torch.Tensor, size: float = 1.0):
    """K1: [N, 3] -> (feats [N, L·C], dfeat/dx [N, L·C, 3]), the chain
    factor scale/(2·size) included. Plain version on CPU, kernel on CUDA;
    the kernel's backward skips the table scatter when the table needs no
    gradient (tracking)."""
    return _dispatch(spec, table, x, size, jacobian=True)
