"""NeRF positional encoding (counterpart of nicer_slam_tpu/ops/embedder.py).

Output order is the reference's: [x, sin(x·2^0), cos(x·2^0), ...,
sin(x·2^(m-1)), cos(x·2^(m-1))].
"""

from __future__ import annotations

import torch


def positional_encoding_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[..., D] -> [..., D*(1+2*multires)]."""
    if multires <= 0:
        return x
    parts = [x]
    for i in range(multires):
        xf = x * (2.0 ** i)
        parts.append(torch.sin(xf))
        parts.append(torch.cos(xf))
    return torch.cat(parts, dim=-1)


def positional_encoding_grad_contract(x: torch.Tensor, multires: int,
                                      cot: torch.Tensor) -> torch.Tensor:
    """``sum_j cot_j * dPE_j/dx`` -> [..., D]. The PE Jacobian is
    block-diagonal, so the contraction is elementwise."""
    if multires <= 0:
        return cot
    D = x.shape[-1]
    c = cot.reshape(*x.shape[:-1], 1 + 2 * multires, D)
    g = c[..., 0, :]
    for i in range(multires):
        f = 2.0 ** i
        xf = x * f
        g = g + c[..., 1 + 2 * i, :] * (f * torch.cos(xf))
        g = g + c[..., 2 + 2 * i, :] * (-f * torch.sin(xf))
    return g
