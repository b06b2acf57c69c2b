"""NaN-safe norm/normalize (counterpart of nicer_slam_tpu/ops/safe_math.py).

Rays entirely in free space give exactly-zero compositing weights, so
normal-map and smoothness differences can be exactly zero; these helpers
keep the gradient of the norm at zero finite (and zero) there.
"""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    zero = sq <= 1e-30
    sq_safe = torch.where(zero, torch.ones_like(sq), sq)
    return torch.where(zero, torch.zeros_like(sq), torch.sqrt(sq_safe))


def safe_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / (safe_norm(x, dim=dim, keepdim=True) + eps)
