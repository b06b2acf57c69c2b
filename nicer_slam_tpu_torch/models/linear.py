"""Weight-normalised linear layers with the reference's geometric init
(counterpart of nicer_slam_tpu/models/linear.py).

``W = g · v / ‖v‖_row`` is written out with the parameters ``v``, ``g``,
``b`` themselves (torch's weight-norm parametrization would rename them), so
a module's state_dict keys are the JAX npz keys. Initialisation draws from a
numpy Generator in the same order as the JAX package, so one seed gives
identical weights in both.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class WNLinear(nn.Module):
    """y = x @ W.T + b, with W = g·v/‖v‖ (rows) when ``g`` is present."""

    def __init__(self, init: Dict[str, np.ndarray]):
        super().__init__()
        self.v = nn.Parameter(torch.from_numpy(np.ascontiguousarray(init["v"])))
        if "g" in init:
            self.g = nn.Parameter(torch.from_numpy(np.ascontiguousarray(init["g"])))
        else:
            self.g = None
        self.b = nn.Parameter(torch.from_numpy(np.ascontiguousarray(init["b"])))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.v
        if self.g is not None:
            norm = torch.sqrt((self.v * self.v).sum(dim=1, keepdim=True))
            w = self.v * (self.g / norm)
        return x @ w.T + self.b


def _wrap_weight_norm(w: np.ndarray, b: np.ndarray, weight_norm: bool):
    if weight_norm:
        return {"v": w, "g": np.linalg.norm(w, axis=1, keepdims=True), "b": b}
    return {"v": w, "b": b}


def init_linear_default(rng: np.random.Generator, d_in: int, d_out: int,
                        weight_norm: bool = True) -> Dict[str, np.ndarray]:
    """torch nn.Linear default: U(-k, k), k = 1/sqrt(d_in)."""
    bound = 1.0 / np.sqrt(d_in)
    w = rng.uniform(-bound, bound, (d_out, d_in)).astype(np.float32)
    b = rng.uniform(-bound, bound, (d_out,)).astype(np.float32)
    return _wrap_weight_norm(w, b, weight_norm)


def init_linear_geometric(rng: np.random.Generator, d_in: int, d_out: int,
                          layer: int, num_layers: int, *, multires: int,
                          skip_layer: bool, dims0: int, bias: float,
                          inside_outside: bool,
                          weight_norm: bool = True) -> Dict[str, np.ndarray]:
    """Geometric initialisation (base_networks.py:127-146)."""
    if layer == num_layers - 2:
        mean = np.sqrt(np.pi) / np.sqrt(d_in)
        if inside_outside:
            mean, b_val = -mean, bias
        else:
            b_val = -bias
        w = mean + 1e-4 * rng.standard_normal((d_out, d_in))
        b = np.full((d_out,), b_val, dtype=np.float32)
    elif multires > 0 and layer == 0:
        w = np.zeros((d_out, d_in), dtype=np.float32)
        w[:, :3] = np.sqrt(2.0) / np.sqrt(d_out) * rng.standard_normal((d_out, 3))
        b = np.zeros((d_out,), dtype=np.float32)
    elif multires > 0 and skip_layer:
        w = np.sqrt(2.0) / np.sqrt(d_out) * rng.standard_normal((d_out, d_in))
        w[:, -(dims0 - 3):] = 0.0
        b = np.zeros((d_out,), dtype=np.float32)
    else:
        w = np.sqrt(2.0) / np.sqrt(d_out) * rng.standard_normal((d_out, d_in))
        b = np.zeros((d_out,), dtype=np.float32)
    return _wrap_weight_norm(w.astype(np.float32), b.astype(np.float32),
                             weight_norm)


def softplus_beta100(x: torch.Tensor) -> torch.Tensor:
    """nn.Softplus(beta=100), linear above beta·x > 20."""
    return F.softplus(x, beta=100.0, threshold=20.0)
