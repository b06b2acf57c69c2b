"""GMFlow optical flow (counterpart of nicer_slam_tpu/models/gmflow.py, the
reference's gmflow_sintel settings: attn_splits 2, global correlation and
propagation, upsample factor 8, 6 blocks, 1 head, FFN expansion 4, 128
feature channels).

  * CNN encoder: 7x7/2 convolution and affine-free InstanceNorm, residual
    stages of 64/96/128 channels at /2, /4, /8, a 1x1 output convolution.
  * Transformer: blocks of a self-attention layer and a cross-attention
    layer with an FFN over [source, message], attention inside 2 x 2
    windows, DETR sine positions added per window.
  * Global correlation softmax matching, then self-attention propagation
    of the flow, then RAFT's convex x8 upsampling.

The module tree mirrors the JAX package's parameter tree, so
``load_flat_npz`` reads the npz that ``tools/convert_gmflow.py`` writes and
``to_flat`` writes one back. At 680 x 1200 (padded to 704 x 1216) the /8
map holds 13,376 tokens and the global correlation is a [13,376, 13,376]
float32 matrix (716 MB), formed once per pair.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv, Dense, Norm, init_seeded, load_flat_npz, nchw, nhwc,
                     to_flat)

__all__ = ["GMFlow", "GMFlowInference", "init_seeded", "load_flat_npz", "to_flat"]


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm of an NCHW map (biased variance)."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


class ResBlock(nn.Module):
    """GMFlow's residual block: plain convolutions padded 1 on every side."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, bias=False, stride=stride, padding=1)
        self.conv2 = Conv(cout, cout, 3, bias=False, padding=1)
        if stride != 1 or cin != cout:
            self.down = Conv(cin, cout, 1, bias=False, stride=stride)

    def forward(self, x):
        y = torch.relu(instance_norm(self.conv1(x)))
        y = torch.relu(instance_norm(self.conv2(y)))
        if hasattr(self, "down"):
            x = instance_norm(self.down(x))
        return torch.relu(x + y)


class Backbone(nn.Module):
    def __init__(self, dim: int = 128):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, bias=False, stride=2, padding=3)
        self.layer1 = nn.ModuleList([ResBlock(64, 64), ResBlock(64, 64)])
        self.layer2 = nn.ModuleList([ResBlock(64, 96, 2), ResBlock(96, 96)])
        self.layer3 = nn.ModuleList([ResBlock(96, 128, 2), ResBlock(128, 128)])
        self.conv2 = Conv(128, dim, 1)

    def forward(self, x):
        y = torch.relu(instance_norm(self.conv1(x)))                  # /2
        for blk in (*self.layer1, *self.layer2, *self.layer3):         # /4, /8
            y = blk(y)
        return self.conv2(y)


class TransformerLayer(nn.Module):
    """``source`` attends to ``target`` ([B, N, D] tokens of one window);
    with ``ffn``, an FFN (no biases) over [source, message]."""

    def __init__(self, dim: int = 128, ffn: bool = True, expansion: int = 4):
        super().__init__()
        self.q, self.k, self.v = Dense(dim, dim), Dense(dim, dim), Dense(dim, dim)
        self.merge, self.norm1 = Dense(dim, dim), Norm(dim)
        if ffn:
            self.mlp0 = Dense(dim * 2, dim * 2 * expansion, bias=False)
            self.mlp2 = Dense(dim * 2 * expansion, dim, bias=False)
            self.norm2 = Norm(dim)

    def forward(self, source, target):
        D = source.shape[-1]
        att = torch.einsum("bnd,bmd->bnm", self.q(source), self.k(target)) / math.sqrt(D)
        msg = torch.softmax(att, dim=-1) @ self.v(target)
        msg = self.norm1.layer(self.merge(msg), 1e-5)
        if hasattr(self, "mlp0"):
            y = self.mlp2(F.gelu(self.mlp0(torch.cat([source, msg], dim=-1))))
            msg = self.norm2.layer(y, 1e-5)
        return source + msg


class _Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.self_attn = TransformerLayer(dim, ffn=False)
        self.cross_attn_ffn = TransformerLayer(dim, ffn=True)


def sine_position(h: int, w: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """DETR's normalised sine positions [h, w, dim] (float64 -> float32, as
    the JAX package computes them)."""
    npf = dim // 2
    scale = 2.0 * np.pi
    eps = 1e-6
    y_embed = np.cumsum(np.ones((h, w)), axis=0)
    x_embed = np.cumsum(np.ones((h, w)), axis=1)
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = temperature ** (2 * (np.arange(npf) // 2) / npf)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                     axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


def _split_windows(x: torch.Tensor, ns: int) -> torch.Tensor:
    """[B, H, W, C] -> [B·ns·ns, H/ns, W/ns, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, ns, H // ns, ns, W // ns, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * ns * ns, H // ns, W // ns, C)


def _merge_windows(x: torch.Tensor, ns: int, H: int, W: int) -> torch.Tensor:
    B = x.shape[0] // (ns * ns)
    x = x.reshape(B, ns, ns, H // ns, W // ns, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


class GMFlow(nn.Module):
    """The GMFlow network, the JAX package's ``init_gmflow`` tree."""

    def __init__(self, dim: int = 128, num_blocks: int = 6, upsample_factor: int = 8):
        super().__init__()
        self.uf = upsample_factor
        self.backbone = Backbone(dim)
        self.blocks = nn.ModuleList(_Block(dim) for _ in range(num_blocks))
        self.prop = nn.ModuleDict({"q": Dense(dim, dim), "k": Dense(dim, dim)})
        self.upsampler = nn.ModuleList([Conv(2 + dim, 256, 3),
                                        Conv(256, upsample_factor ** 2 * 9, 1)])

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                attn_splits: int = 2) -> torch.Tensor:
        """[B, H, W, 3] pair in [0, 1] (H, W multiples of 32) -> flow
        [B, H, W, 2] in pixels, 0 -> 1."""
        B, H, W, _ = img0.shape
        f = nhwc(self.backbone(nchw(torch.cat([img0, img1], dim=0) * 2.0 - 1.0)))
        h, w, D = f.shape[1], f.shape[2], f.shape[3]
        ns = attn_splits
        pos = torch.from_numpy(sine_position(h // ns, w // ns, D)).to(f.device, f.dtype)
        f = _merge_windows(_split_windows(f, ns) + pos[None], ns, h, w)
        f0, f1 = f[:B], f[B:]

        def windowed(layer, src, tgt):
            s = _split_windows(src, ns).reshape(B * ns * ns, -1, D)
            t = _split_windows(tgt, ns).reshape(B * ns * ns, -1, D)
            out = layer(s, t).reshape(B * ns * ns, h // ns, w // ns, D)
            return _merge_windows(out, ns, h, w)

        for blk in self.blocks:
            f0n = windowed(blk.self_attn, f0, f0)
            f1n = windowed(blk.self_attn, f1, f1)
            f0, f1 = (windowed(blk.cross_attn_ffn, f0n, f1n),
                      windowed(blk.cross_attn_ffn, f1n, f0n))

        # global correlation softmax matching
        t0, t1 = f0.reshape(B, h * w, D), f1.reshape(B, h * w, D)
        prob = torch.softmax(torch.einsum("bnd,bmd->bnm", t0, t1) / math.sqrt(D), dim=-1)
        ys, xs = torch.meshgrid(torch.arange(h, device=f.device),
                                torch.arange(w, device=f.device), indexing="ij")
        grid = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(f.dtype)
        flow = prob @ grid - grid[None]
        del prob
        # self-attention flow propagation
        att = torch.einsum("bnd,bmd->bnm", self.prop["q"](t0), self.prop["k"](t0)) / math.sqrt(D)
        flow = (torch.softmax(att, dim=-1) @ flow).reshape(B, h, w, 2)
        del att

        # convex upsampling: a softmax over 9 neighbours per output pixel
        uf = self.uf
        mask = self.upsampler[1](torch.relu(self.upsampler[0](
            nchw(torch.cat([flow, f0], dim=-1)))))
        mask = torch.softmax(nhwc(mask).reshape(B, h, w, 9, uf * uf), dim=3)
        fpad = F.pad(flow * uf, (0, 0, 1, 1, 1, 1))
        neigh = torch.stack([fpad[:, dy:dy + h, dx:dx + w]
                             for dy in range(3) for dx in range(3)], dim=3)
        up = (mask[..., None] * neigh[:, :, :, :, None, :]).sum(dim=3)
        up = up.reshape(B, h, w, uf, uf, 2).permute(0, 1, 3, 2, 4, 5)
        return up.reshape(B, h * uf, w * uf, 2)[:, :H, :W]


def widths_from_flat(flat) -> Dict[str, int]:
    """GMFlow's widths as a flat checkpoint holds them."""
    blocks = {k.split("/")[1] for k in flat.files if k.startswith("blocks/")}
    return dict(dim=int(flat["backbone/conv2/w"].shape[3]), num_blocks=len(blocks))


class GMFlowInference:
    """The checkpoint-backed pairwise flow of extract_flows, on ``device``:
    both frames zero-padded to a multiple of ``pad_to``, the flow cropped."""

    def __init__(self, ckpt_path: str, device="cuda", pad_to: int = 32):
        self.device, self.pad_to = torch.device(device), pad_to
        with np.load(ckpt_path, allow_pickle=False) as flat:
            self.model = load_flat_npz(GMFlow(**widths_from_flat(flat)), flat)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, img0: np.ndarray, img1: np.ndarray) -> np.ndarray:
        H, W = img0.shape[:2]
        pad = ((0, -H % self.pad_to), (0, -W % self.pad_to), (0, 0))

        def dev(img):
            return torch.from_numpy(np.pad(img, pad).astype(np.float32)).to(self.device)[None]

        flow = self.model(dev(img0), dev(img1))[0, :H, :W]
        return flow.cpu().numpy().astype(np.float32)
