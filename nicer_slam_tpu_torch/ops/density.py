"""SDF -> density conversion (counterpart of nicer_slam_tpu/ops/density.py).

  * Laplace density α·(0.5 + 0.5·sign(sdf)·expm1(−|sdf|/β)), α = 1/β.
  * Grid-predefined β from a 64³ voxel visit counter:
    ``β(x) = a·exp(−b·1e−4·count(x)·d) + c``; points with any |x_d| > 0.99
    count 0.

``update_voxels`` is a plain ``index_put`` scatter-add here (K7 in
ROADMAP.md, still to be written as a kernel). It returns a new tensor, as
the reference's functional update does; the 64³ copy is 1 MB.
"""

from __future__ import annotations

import torch

BETA_A = 0.01207724805
BETA_B = 0.0116544676
BETA_C = 0.0023639156
BETA_D = 5.37538


def laplace_density(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-sdf.abs() / beta))


def learned_beta(beta_param: torch.Tensor, beta_min: float = 1e-4) -> torch.Tensor:
    return beta_param.abs() + beta_min


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


def grid_predefined_beta(voxels: torch.Tensor, x: torch.Tensor,
                         voxel_res: int = 64) -> torch.Tensor:
    """β per point [N,1] from the voxel counter."""
    count = voxel_counts_at(voxels, x, voxel_res)
    beta = BETA_A * torch.exp(-BETA_B * 1e-4 * count * BETA_D) + BETA_C
    return beta[:, None]


def update_voxels(voxels: torch.Tensor, x: torch.Tensor,
                  voxel_res: int = 64) -> torch.Tensor:
    """Scatter-add one visit per non-boundary point."""
    idx, boundary = _voxel_index(x.detach(), voxel_res)
    ones = (~boundary).to(voxels.dtype)
    return voxels.index_put((idx[:, 0], idx[:, 1], idx[:, 2]), ones,
                            accumulate=True)
