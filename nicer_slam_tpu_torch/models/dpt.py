"""DPT-hybrid (ViT-B + ResNetV2-50) monocular depth/normal networks
(counterpart of nicer_slam_tpu/models/dpt.py, the Omnidata vitb_rn50_384
models of the reference's extract_monocular_cues.py).

A ResNetV2 backbone (weight-standardised TF-SAME convolutions, GroupNorm,
stages of 3/4/9 bottlenecks at /4, /8, /16), its /16 map patch-embedded
into a 12-block ViT-B tapped after blocks 8 and 11, "project" readouts
(the class token concatenated to every token, Linear + GELU), the
act_postprocess convolutions, the layer_rn projections, four RefineNet
fusion blocks with align-corners x2 upsampling, and the task head (ReLU
depth, or normals clamped to [0, 1]).

The module tree mirrors the JAX package's parameter tree, so
``load_flat_npz`` reads the npz that ``tools/convert_omnidata.py`` writes
from the official checkpoints and ``to_flat`` writes one back.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv, Dense, Norm, init_seeded, load_flat_npz, max_pool_same, nchw,
                     nhwc, resize_align_corners, resize_bilinear, to_flat)

__all__ = ["DPT", "DPTInference", "init_seeded", "load_flat_npz", "to_flat"]

RESNET_LAYERS = (3, 4, 9)          # vit_base_r50_s16_384 backbone
RESNET_WIDTHS = ((64, 256), (128, 512), (256, 1024))
VIT_TAPS = (8, 11)


def _std_conv(ci, co, k, stride=1):
    return Conv(ci, co, k, bias=False, stride=stride, standardize=True)


class Bottleneck(nn.Module):
    """timm's non-preactivation ResNetV2 bottleneck."""

    def __init__(self, cin: int, cmid: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1, self.norm1 = _std_conv(cin, cmid, 1), Norm(cmid)
        self.conv2, self.norm2 = _std_conv(cmid, cmid, 3, stride), Norm(cmid)
        self.conv3, self.norm3 = _std_conv(cmid, cout, 1), Norm(cout)
        if stride != 1 or cin != cout:
            self.down, self.down_norm = _std_conv(cin, cout, 1, stride), Norm(cout)

    def forward(self, x):
        y = torch.relu(self.norm1.group(self.conv1(x)))
        y = torch.relu(self.norm2.group(self.conv2(y)))
        y = self.norm3.group(self.conv3(y))
        if hasattr(self, "down"):
            x = self.down_norm.group(self.down(x))
        return torch.relu(x + y)


class ResNetStages(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem, self.stem_norm = _std_conv(3, 64, 7, 2), Norm(64)
        cin = 64
        for si, (n_blocks, (cmid, cout)) in enumerate(zip(RESNET_LAYERS, RESNET_WIDTHS)):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(cin, cmid, cout, 2 if (bi == 0 and si > 0) else 1))
                cin = cout
            setattr(self, f"stage{si}", nn.ModuleList(blocks))

    def forward(self, x):
        """(s0 [/4, 256], s1 [/8, 512], s2 [/16, 1024]), NCHW."""
        y = torch.relu(self.stem_norm.group(self.stem(x)))
        y = max_pool_same(y, 3, 2)
        outs = []
        for si in range(len(RESNET_LAYERS)):
            for blk in getattr(self, f"stage{si}"):
                y = blk(y)
            outs.append(y)
        return tuple(outs)


class ViTBlock(nn.Module):
    def __init__(self, dim: int = 768, mlp: int = 3072, heads: int = 12):
        super().__init__()
        self.heads = heads
        self.ln1, self.ln2 = Norm(dim), Norm(dim)
        self.qkv, self.proj = Dense(dim, dim * 3), Dense(dim, dim)
        self.fc1, self.fc2 = Dense(dim, mlp), Dense(mlp, dim)

    def forward(self, x):
        B, N, D = x.shape
        h = self.heads
        qkv = self.qkv(self.ln1.layer(x, 1e-6)).reshape(B, N, 3, h, D // h)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        att = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(D // h)
        att = torch.softmax(att, dim=-1)
        y = torch.einsum("bhnm,bmhd->bnhd", att, v).reshape(B, N, D)
        x = x + self.proj(y)
        y = self.fc2(F.gelu(self.fc1(self.ln2.layer(x, 1e-6))))
        return x + y


class _RCU(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1, self.conv2 = Conv(f, f, 3), Conv(f, f, 3)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(torch.relu(x))))


class _Fusion(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.rcu1, self.rcu2, self.out = _RCU(f), _RCU(f), Conv(f, f, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        x = resize_align_corners(x, x.shape[2] * 2, x.shape[3] * 2)
        return self.out(x)


class DPT(nn.Module):
    """The DPT-hybrid network, the JAX package's ``init_dpt`` tree."""

    def __init__(self, out_channels: int = 1, features: int = 256, dim: int = 768,
                 depth: int = 12):
        super().__init__()
        self.out_channels = out_channels
        self.resnet = ResNetStages()
        self.patch_embed = Conv(1024, dim, 1)
        self.pos_embed = nn.Parameter(torch.zeros(1, 24 * 24 + 1, dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.blocks = nn.ModuleList(ViTBlock(dim) for _ in range(depth))
        self.readout = nn.ModuleList(Dense(2 * dim, dim) for _ in range(2))
        self.act_post = nn.ModuleDict({
            "proj3": Conv(dim, dim, 1), "proj4": Conv(dim, dim, 1),
            # the DPT downsample conv pads 1 on every side, not TF-SAME
            "down4": Conv(dim, dim, 3, stride=2, padding=1)})
        self.layer_rn = nn.ModuleList(Conv(ci, features, 3, bias=False)
                                      for ci in (256, 512, dim, dim))
        self.fusion = nn.ModuleList(_Fusion(features) for _ in range(4))
        self.head = nn.ModuleList([Conv(features, features // 2, 3),
                                   Conv(features // 2, 32, 3), Conv(32, out_channels, 1)])

    def _readout(self, t, ro, th, tw):
        cls_t = t[:, :1].expand(-1, t.shape[1] - 1, -1)
        y = F.gelu(ro(torch.cat([t[:, 1:], cls_t], dim=-1)))
        return y.transpose(1, 2).reshape(t.shape[0], -1, th, tw)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img [B, H, W, 3] in [0, 1] (H, W multiples of 32) -> [B, H, W, C]."""
        B, H, W, _ = img.shape
        s0, s1, s2 = self.resnet(nchw((img - 0.5) / 0.5))
        tok = self.patch_embed(s2)                                    # /16
        th, tw = tok.shape[2], tok.shape[3]
        tok = tok.flatten(2).transpose(1, 2)
        tok = torch.cat([self.cls_token.expand(B, -1, -1), tok], dim=1)
        pos = self.pos_embed
        if pos.shape[1] != tok.shape[1]:
            side = int(np.sqrt(pos.shape[1] - 1))
            grid = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
            grid = resize_bilinear(grid, th, tw).flatten(2).transpose(1, 2)
            pos = torch.cat([pos[:, :1], grid], dim=1)
        tok = tok + pos
        taps = []
        for i, blk in enumerate(self.blocks):
            tok = blk(tok)
            if i in VIT_TAPS:
                taps.append(tok)
        t3 = self._readout(taps[0], self.readout[0], th, tw)
        t4 = self._readout(taps[1], self.readout[1], th, tw)
        f16 = self.act_post["proj3"](t3)
        f32 = self.act_post["down4"](self.act_post["proj4"](t4))
        r1, r2, r3, r4 = (conv(x) for conv, x in zip(self.layer_rn, (s0, s1, f16, f32)))
        y = self.fusion[0](r4)
        for blk, r in zip(self.fusion[1:], (r3, r2, r1)):
            y = blk(y[:, :, :r.shape[2], :r.shape[3]], r)
        y = self.head[0](y)
        y = resize_align_corners(y, H, W)
        y = self.head[2](torch.relu(self.head[1](y)))
        y = torch.relu(y) if self.out_channels == 1 else torch.clamp(y, 0.0, 1.0)
        return nhwc(y)


def widths_from_flat(flat) -> Dict[str, int]:
    """DPT's widths as a flat checkpoint holds them."""
    blocks = {k.split("/")[1] for k in flat.files if k.startswith("blocks/")}
    return dict(out_channels=int(flat["head/2/w"].shape[3]),
                features=int(flat["head/0/w"].shape[2]),
                dim=int(flat["patch_embed/w"].shape[3]), depth=len(blocks))


class DPTInference:
    """The checkpoint-backed depth or normal backend of
    extract_monocular_cues, on ``device``: the frame resized to
    input_size² (JAX's antialiased bilinear), the network, the output
    resized back; depth min-max normalised to [0, 1], normals [3, H, W]."""

    def __init__(self, ckpt_path: str, task: str = "depth", device="cuda",
                 input_size: int = 384):
        self.task, self.input_size = task, input_size
        self.device = torch.device(device)
        with np.load(ckpt_path, allow_pickle=False) as flat:
            widths = widths_from_flat(flat)
            want = 1 if task == "depth" else 3
            if widths["out_channels"] != want:
                raise ValueError(f"{ckpt_path}: {widths['out_channels']} output channels, "
                                 f"the {task} head has {want}")
            self.model = load_flat_npz(DPT(**widths), flat).to(self.device).eval()

    @torch.no_grad()
    def __call__(self, img: np.ndarray) -> np.ndarray:
        H, W = img.shape[:2]
        s = self.input_size
        x = nchw(torch.from_numpy(np.ascontiguousarray(img, np.float32))
                 .to(self.device)[None])
        y = self.model(nhwc(resize_bilinear(x, s, s)))
        y = resize_bilinear(nchw(y), H, W)[0].cpu().numpy()       # [C, H, W]
        if self.task == "depth":
            d = y[0]
            lo, hi = d.min(), max(d.max(), d.min() + 1e-6)
            return ((d - lo) / (hi - lo)).astype(np.float32)
        return y.astype(np.float32)
