"""SDF -> density conversion (counterpart of nicer_slam_tpu/ops/density.py):
kernel K7.

  * Laplace density α·(0.5 + 0.5·sign(sdf)·expm1(−|sdf|/β)), α = 1/β.
  * Grid-predefined β from a 64³ voxel visit counter:
    ``β(x) = a·exp(−b·1e−4·count(x)·d) + c``; points with any |x_d| > 0.99
    count 0.

K7 is the counter's scatter (``update_voxels``) and its β read
(``grid_predefined_beta``) (csrc/voxels.cu), one thread per point: where
ray-ordered points put neighbouring lanes of a warp in one voxel, the
scatter merges those lanes into one float atomic of the group's size; the
read is a gather. Adds of small integers are exact below 2^24, so the
kernel's counter equals the plain version's bit for bit. ``update_voxels`` returns
a new tensor, as the reference's functional update does; the 64³ copy is
1 MB. Neither takes a gradient: the counter is a visit count.
"""

from __future__ import annotations

import torch

from . import _cuda

BETA_A = 0.01207724805
BETA_B = 0.0116544676
BETA_C = 0.0023639156
BETA_D = 5.37538


def laplace_density(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-sdf.abs() / beta))


def learned_beta(beta_param: torch.Tensor, beta_min: float = 1e-4) -> torch.Tensor:
    return beta_param.abs() + beta_min


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _voxel_index(x: torch.Tensor, voxel_res: int):
    boundary = (x.abs() > 0.99).any(dim=-1)
    u = (x + 1.0) / 2.0
    idx = (u * voxel_res).to(torch.int64).clamp(0, voxel_res - 1)
    return idx, boundary


def voxel_counts_at(voxels: torch.Tensor, x: torch.Tensor,
                    voxel_res: int = 64) -> torch.Tensor:
    """Visit count per point [N]; boundary points get 0."""
    idx, boundary = _voxel_index(x, voxel_res)
    counts = voxels[idx[:, 0], idx[:, 1], idx[:, 2]]
    return torch.where(boundary, torch.zeros_like(counts), counts)


def grid_predefined_beta_plain(voxels: torch.Tensor, x: torch.Tensor,
                               voxel_res: int = 64) -> torch.Tensor:
    """Plain version of K7's read: β per point [N,1]."""
    count = voxel_counts_at(voxels, x.detach(), voxel_res)
    beta = BETA_A * torch.exp(-BETA_B * 1e-4 * count * BETA_D) + BETA_C
    return beta[:, None]


def update_voxels_plain(voxels: torch.Tensor, x: torch.Tensor,
                        voxel_res: int = 64) -> torch.Tensor:
    """Plain version of K7's scatter: one visit per non-boundary point."""
    idx, boundary = _voxel_index(x.detach(), voxel_res)
    ones = (~boundary).to(voxels.dtype)
    return voxels.index_put((idx[:, 0], idx[:, 1], idx[:, 2]), ones,
                            accumulate=True)


# ---------------------------------------------------------------------------
# K7 (csrc/voxels.cu)
# ---------------------------------------------------------------------------

def _operands(voxels: torch.Tensor, x: torch.Tensor, voxel_res: int, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if voxel_res ** 3 >= 2 ** 31:
        raise ValueError(f"{name}: voxel_res {voxel_res} exceeds the kernel's 32-bit index")
    x = x.detach().contiguous()
    _cuda.check(x, "x", torch.float32, (x.shape[0], 3))
    _cuda.check(voxels, "voxels", torch.float32, (voxel_res,) * 3, device=x.device)
    return x


def grid_predefined_beta(voxels: torch.Tensor, x: torch.Tensor,
                         voxel_res: int = 64) -> torch.Tensor:
    """K7 read: β per point [N,1] from the voxel counter. Plain version on
    CPU, kernel on CUDA; no gradient."""
    if x.device.type == "cpu":
        return grid_predefined_beta_plain(voxels, x, voxel_res)
    x = _operands(voxels, x, voxel_res, "grid_predefined_beta")
    beta = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    _cuda.launch("voxels.beta", "nsl_voxel_beta", x.shape[0], x.data_ptr(),
                 voxels.data_ptr(), beta.data_ptr(), x.shape[0], voxel_res,
                 float(torch.tensor(-BETA_B * 1e-4, dtype=torch.float32)),
                 BETA_D, BETA_A, BETA_C)
    return beta


def update_voxels(voxels: torch.Tensor, x: torch.Tensor,
                  voxel_res: int = 64) -> torch.Tensor:
    """K7 scatter: a new counter with one visit added per non-boundary
    point. Plain version on CPU, kernel on CUDA."""
    if x.device.type == "cpu":
        return update_voxels_plain(voxels, x, voxel_res)
    x = _operands(voxels, x, voxel_res, "update_voxels")
    out = voxels.detach().clone()
    _cuda.launch("voxels.scatter", "nsl_voxel_scatter", x.shape[0], x.data_ptr(),
                 out.data_ptr(), x.shape[0], voxel_res)
    return out
