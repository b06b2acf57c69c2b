"""Building blocks of the preprocessing networks (the mono prior, DPT and
GMFlow) and the flat weight layout they share with the JAX package.

The JAX package keeps each network's parameters as a nested tree of dicts
and lists and stores it flat: one npz key per leaf, the path joined by
``/`` (``enc/0/c1/w``), convolutions HWIO, dense layers ``[in, out]``,
norms ``g``/``b`` (``nicer_slam_tpu/models/dpt.py`` ``_load_flat_into``).
The port's modules mirror that tree attribute by attribute, so a module's
``state_dict`` key with ``.`` for ``/`` is the flat key. Convolution
weights live OIHW and dense weights ``[out, in]`` here: a 4-d leaf is
transposed HWIO <-> OIHW and a 2-d leaf ``[in, out]`` <-> ``[out, in]`` at
the boundary (no other leaf of the three networks has 2 or 4 dimensions).

The networks run in NCHW and take and give NHWC at their public functions,
as the JAX package does. Convolutions, products and softmaxes are PyTorch
library calls (cuDNN/cuBLAS on the card): the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TF-SAME padding of an NCHW tensor for a k x k window at stride s: the
    odd pixel of the total goes below and to the right."""
    ih, iw = x.shape[-2:]
    ph = max((math.ceil(ih / s) - 1) * s + k - ih, 0)
    pw = max((math.ceil(iw / s) - 1) * s + k - iw, 0)
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), value=value)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """``lax.reduce_window(max, "SAME")``: -inf padding, TF-SAME."""
    return F.max_pool2d(pad_same(x, k, s, float("-inf")), k, s)


class Conv(nn.Module):
    """A convolution with the JAX package's leaves ``w`` (and ``b``).
    ``padding`` "SAME" is TF-SAME; an int pads that many pixels on every
    side. ``standardize``: timm's StdConv2dSame (each filter to zero mean
    and unit variance, eps 1e-6, before the convolution)."""

    def __init__(self, ci: int, co: int, k: int, bias: bool = True, stride: int = 1,
                 padding="SAME", standardize: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(co, ci, k, k))
        self.b = nn.Parameter(torch.zeros(co)) if bias else None
        self.stride, self.padding, self.standardize = stride, padding, standardize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        if self.standardize:
            mu = w.mean(dim=(1, 2, 3), keepdim=True)
            var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
            w = (w - mu) * torch.rsqrt(var + 1e-6)
        pad = self.padding
        if pad == "SAME":
            x, pad = pad_same(x, w.shape[-1], self.stride), 0
        return F.conv2d(x, w, self.b, self.stride, pad)


class Dense(nn.Module):
    """``x @ w + b`` with the JAX package's ``[in, out]`` w stored ``[out, in]``."""

    def __init__(self, ci: int, co: int, bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(co, ci))
        self.b = nn.Parameter(torch.zeros(co)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.w, self.b)


class Norm(nn.Module):
    """The affine leaves ``g``/``b`` of a group or layer norm."""

    def __init__(self, c: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(c))
        self.b = nn.Parameter(torch.zeros(c))

    def group(self, x: torch.Tensor, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
        return F.group_norm(x, groups, self.g, self.b, eps)

    def layer(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.g, self.b, eps)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# resizing as the JAX package resizes
# ---------------------------------------------------------------------------

def _triangle_weights(n_in: int, n_out: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")``'s weights along one axis,
    ``[n_in, n_out]`` in the image's float type (``jax._src.image.scale.compute_weight_mat``): half-pixel
    centres, a triangle filter widened by the factor when shrinking
    (antialiasing), each output's weights normalised to sum 1 over the input
    (which clamps at the border)."""
    inv = 1.0 / (n_out / n_in)
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=dtype) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=dtype)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW resize with ``jax.image.resize(..., "bilinear")``'s semantics
    (antialiased when it shrinks; an axis whose size stays is left alone)."""
    H, W = x.shape[-2:]
    if H != h:
        wy = _triangle_weights(H, h, x.dtype).to(x.device)
        x = torch.einsum("bchw,hH->bcHw", x, wy)
    if W != w:
        wx = _triangle_weights(W, w, x.dtype).to(x.device)
        x = torch.einsum("bchw,wW->bchW", x, wx)
    return x


def resize_align_corners(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW bilinear resize with align-corners sampling, in the JAX package's
    arithmetic (``dpt._resize_ac``: two lerps along x, then one along y)."""
    H, W = x.shape[-2:]
    ys = torch.linspace(0.0, H - 1.0, h, dtype=x.dtype) if h > 1 else torch.zeros(1, dtype=x.dtype)
    xs = torch.linspace(0.0, W - 1.0, w, dtype=x.dtype) if w > 1 else torch.zeros(1, dtype=x.dtype)
    ys, xs = ys.to(x.device), xs.to(x.device)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
    wy = (ys - y0)[None, None, :, None]
    wx = (xs - x0)[None, None, None, :]
    rows0, rows1 = x[:, :, y0], x[:, :, y1]
    top = rows0[..., x0] * (1 - wx) + rows0[..., x1] * wx
    bot = rows1[..., x0] * (1 - wx) + rows1[..., x1] * wx
    return top * (1 - wy) + bot * wy


# ---------------------------------------------------------------------------
# the flat layout
# ---------------------------------------------------------------------------

def _to_jax_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)      # OIHW -> HWIO
    if a.ndim == 2:
        return a.T                          # [out, in] -> [in, out]
    return a


def _from_jax_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)      # HWIO -> OIHW
    if a.ndim == 2:
        return a.T
    return a


def to_flat(module: nn.Module) -> Dict[str, np.ndarray]:
    """The module's weights in the JAX package's flat layout (float32)."""
    return {k.replace(".", "/"): np.ascontiguousarray(
                _to_jax_layout(v.detach().cpu().float().numpy()))
            for k, v in module.state_dict().items()}


def load_flat_npz(module: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a flat-layout npz (or dict) into the module: every key of the
    module must be there with its shape, and no other key."""
    keys = set(flat.files if hasattr(flat, "files") else flat.keys())
    state = module.state_dict()
    want = {k.replace(".", "/"): k for k in state}
    missing, unexpected = sorted(set(want) - keys), sorted(keys - set(want))
    if missing or unexpected:
        raise KeyError(f"{type(module).__name__}: flat weights missing {missing[:5]} "
                       f"({len(missing)}), unexpected {unexpected[:5]} ({len(unexpected)})")
    new = {}
    for fk, sk in want.items():
        a = _from_jax_layout(np.asarray(flat[fk], np.float32))
        if tuple(a.shape) != tuple(state[sk].shape):
            raise ValueError(f"{fk}: shape {a.shape[::-1] if a.ndim in (2, 4) else a.shape}"
                             f" does not fit {tuple(state[sk].shape)}")
        new[sk] = torch.from_numpy(np.array(a, order="C"))
    module.load_state_dict(new)
    return module


def init_seeded(module: nn.Module, seed: int) -> nn.Module:
    """Random weights from a ``torch.Generator``, drawn as the JAX package's
    ``_init_conv``/``_init_dense`` draw theirs: convolution and dense
    weights normal with std sqrt(2 / fan_in), biases 0, norm scales 1 (and
    the ViT's position embedding and class token 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim in (2, 4):
                fan_in = int(np.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=g) * math.sqrt(2.0 / fan_in))
            elif name.endswith(".g"):
                p.fill_(1.0)
            else:
                p.zero_()
    return module
