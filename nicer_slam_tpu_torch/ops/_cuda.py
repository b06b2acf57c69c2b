"""Build, load and launch the hand-written Hopper kernels (``csrc/*.cu``).

The kernels are compiled with ``nvcc`` for ``sm_90a`` into ONE shared library
with a plain C interface and loaded through ``ctypes`` — no PyTorch headers,
so a build takes seconds. The build happens on first use, into
``<repo>/build/kernels/``, from the sources in the checkout only: one ``nvcc``
per source, all started together, then one link. The library name carries a
hash of the sources and flags, so an edited source rebuilds.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`launch` raises on a
non-zero code and counts the launch per kernel in a plain integer, so a run
can show that the main path went through each kernel.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

# kernel name -> launches since the last reset (forward and backward kernels
# are separate entries)
KERNELS = ("hash_encode_with_grad.fwd", "hash_encode_with_grad.bwd",
           "hash_encode.fwd", "hash_encode.bwd", "hash_encode_bf16", "hash_encode_bf16.bwd",
           "composite.fwd", "composite.bwd",
           "weights_topk.fwd", "weights_topk.bwd", "topk_rgb.fwd", "topk_rgb.bwd",
           "importance_sample", "importance_sample_given",
           "voxels.scatter", "voxels.beta", "sdf_density.grid", "sdf_density.rays",
           "sdf_density_general.grid", "sdf_density_general.rays",
           "sdf_density_concat.rays", "tsdf.integrate")
_launches: Dict[str, int] = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argtypes (all return int = cudaError_t)
_SIGNATURES = {
    # x, table [T, C], lvl_meta, lvl_scale, feats, dfeat, N, L, C, size, stream
    "nsl_hash_encode_fwd": [_P] * 6 + [_I64, _I, _I, _F, _P],
    # x, table, meta, scale, g_feat, g_dfeat, g_table, g_x [N, 3],
    # scratch [T·C + max(L, 32) + ceil(T / 64)] int64, N, L, C, size, T, stream
    "nsl_hash_encode_bwd": [_P] * 9 + [_I64, _I, _I, _F, _I64, _P],
    # z, density, rgb, normals, weights, rgb_out, depth_out, normal_out,
    # R, S, stream
    "nsl_composite_fwd": [_P] * 8 + [_I64, _I, _P],
    # z, density, rgb, normals, picks, g_weights, g_rgb_out, g_depth,
    # g_normal_out, g_topk_w, g_wsum, g_density, g_rgb, g_normals, R, S, Kc,
    # stream
    "nsl_composite_bwd": [_P] * 14 + [_I64, _I, _I, _P],
    # x, table [T, C] bf16, meta, scale, feats, N, L, C, size, stream
    "nsl_hash_encode_bf16_fwd": [_P] * 5 + [_I64, _I, _I, _F, _P],
    # x, table [T, C] bf16, meta, scale, g_feat, g_table, g_x, scratch,
    # N, L, C, size, T, stream
    "nsl_hash_encode_bf16_bwd": [_P] * 8 + [_I64, _I, _I, _F, _I64, _P],
    # z, density, normals, weights, depth_out, normal_out, topk_w, wsum,
    # picks, R, S, Kc, stream
    "nsl_weights_topk_fwd": [_P] * 9 + [_I64, _I, _I, _P],
    # topk_w, wsum, rgb, out, R, Kc, stream
    "nsl_topk_rgb_fwd": [_P] * 4 + [_I64, _I, _P],
    # topk_w, wsum, rgb, g_out, g_topk_w, g_wsum, g_rgb, R, Kc, stream
    "nsl_topk_rgb_bwd": [_P] * 7 + [_I64, _I, _P],
    # rays_o, rays_d, cache, t_rand, perm, eik_idx, z_out, z_eik,
    # R, res, Ne, Ns, Nextra, bound, near, far_max, t_step, u_step, stream
    "nsl_importance_sample": [_P] * 8 + [_I64, _I, _I, _I, _I, _F, _F, _F,
                                         _F, _F, _P],
    # z, near, far, density, perm, eik_idx, z_out, z_eik, R, chunk, Ne, Ns,
    # Nextra, u_step, stream
    "nsl_importance_sample_given": [_P] * 8 + [_I64, _I64, _I, _I, _I, _F, _P],
    # the same two with the rows in a global scratch [n_rows, row floats]
    # (rows, n_rows before the stream)
    "nsl_importance_sample_global": [_P] * 8 + [_I64, _I, _I, _I, _I, _F, _F, _F,
                                                _F, _F, _P, _I64, _P],
    "nsl_importance_sample_given_global": [_P] * 8 + [_I64, _I64, _I, _I, _I, _F, _P,
                                                      _I64, _P],
    # x, counter, N, res, stream
    "nsl_voxel_scatter": [_P, _P, _I64, _I, _P],
    # x, counter, beta, N, res, -b·1e-4, d, a, c, stream
    "nsl_voxel_beta": [_P, _P, _P, _I64, _I, _F, _F, _F, _F, _P],
    # weights, table_c, meta_c, scl_c, table_f, meta_f, scl_f, xs, res, o, d,
    # z, S, counter, vres, -b·1e-4, d, a, c, beta, beta_scale, out, N, stream
    "nsl_sdf_density": [_P] * 8 + [_I] + [_P] * 3 + [_I, _P, _I] + [_F] * 4 + [_P] * 3
                       + [_I64, _P],
    # desc (host int32 [2, 73]), weights, w_floats, table_c, meta_c, scl_c,
    # table_f, meta_f, scl_f, f32_tables, xs, res, o, d, z, S, counter, vres,
    # -b·1e-4, d, a, c, beta, beta_scale, out, N, stream
    "nsl_sdf_density_general": [_P, _P, _I64] + [_P] * 6 + [_I, _P, _I] + [_P] * 3
                               + [_I, _P, _I] + [_F] * 4 + [_P] * 3 + [_I64, _P],
    # desc, w_floats, tile out, bytes out, smem-weight floats out (no stream)
    "nsl_sdf_density_general_plan": [_P, _I64, _P, _P, _P],
    # desc (host int32 [2, 9 + 4 cap]), cap, ext (device int32, or NULL),
    # act (device float32 scratch, or NULL), then nsl_sdf_density_general's
    # weights .. stream
    "nsl_sdf_density_general_ext": [_P, _I, _P, _P, _P, _I64] + [_P] * 6 + [_I, _P, _I]
                                   + [_P] * 3 + [_I, _P, _I] + [_F] * 4 + [_P] * 3
                                   + [_I64, _P],
    # desc, cap, w_floats, tile out, bytes out, smem-weight floats out, ext
    # ints out (host, or NULL), ext count out, activation floats out (no
    # stream)
    "nsl_sdf_density_general_ext_plan": [_P, _I, _I64] + [_P] * 6,
    # tsdf, weight, depth, w2c, K, xs, ys, zs, res, H, W, trunc, depth_max,
    # stream
    "nsl_tsdf_integrate": [_P] * 8 + [_I] * 3 + [_F] * 2 + [_P],
}

# entry points that return an int64 and take no stream: the K5 sampler's
# scratch rows (floats of a ray's rows, 0 without scratch; Ne, Ns, Nextra)
# and the warps that share them (R)
_QUERIES = {
    "nsl_importance_sample_rows": [_I, _I, _I],
    "nsl_importance_sample_row_warps": [_I64],
}

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the Hopper kernels "
                       "are built from csrc/ on first use")


def _sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnicer_slam_kernels_{h.hexdigest()[:16]}.so")


def _check_run(cmd, proc, out, err) -> None:
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{out}\n{err}")


def build() -> str:
    """Compile csrc/*.cu into the shared library unless it is already built
    (one nvcc per source, in parallel, then a link); returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{path}.{os.getpid()}"
    nvcc = nvcc_path()
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{stem}.{os.path.basename(src)}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    results = [(cmd, proc, *proc.communicate()) for cmd, _, proc in jobs]
    for res in results:
        _check_run(*res)
    cmd = [nvcc, *LINK_FLAGS, "-o", f"{stem}.tmp", *(obj for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _check_run(cmd, proc, proc.stdout, proc.stderr)
    os.replace(f"{stem}.tmp", path)
    for _, obj, _ in jobs:
        os.remove(obj)
    return path


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in _QUERIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int64
        _lib = lib
    return _lib


def launch(kernel: str, entry: str, work: int, *args) -> None:
    """Call the C entry point ``entry`` on the current stream, raise on a
    CUDA error, and count one launch of ``kernel`` (an entry point launches
    nothing when its ``work`` count, the rows it covers, is 0)."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(), entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    if work > 0:
        _launches[kernel] += 1


def on_card(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one
    (the kernel runs); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def ptr(t: Optional[torch.Tensor]):
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          device: Optional[torch.device] = None) -> None:
    """Validate a kernel operand: CUDA, dtype, shape, contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0
