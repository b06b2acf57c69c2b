"""The self-trained RGB-only monocular depth/normal prior (counterpart of
nicer_slam_tpu/models/mono_prior.py): a small UNet, widths 24/48/96, trained
from scratch on procedurally generated rooms and shipped as
``mono_prior.npz`` at the repository root. Its cues are RGB -> geometry
predictions; no GT depth is read.

Outputs follow the on-disk cue contract of
``preprocess/extract_monocular_cues.py``: depth in [0, 1] (the SSI loss is
scale and shift invariant) and camera-frame normals stored as (n + 1) / 2.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import (Conv, init_seeded, load_flat_npz, max_pool_same, nchw, nhwc,
                     resize_bilinear, to_flat)

__all__ = ["MonoPrior", "MonoPriorInference", "init_seeded", "load_flat_npz", "to_flat"]

_WIDTHS = (24, 48, 96)


class _Block(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.c1 = Conv(ci, co, 3)
        self.c2 = Conv(co, co, 3)

    def forward(self, x):
        return torch.relu(self.c2(torch.relu(self.c1(x))))


class MonoPrior(nn.Module):
    """The UNet: two 3x3 convolutions per level, 2x2 max pools down, JAX's
    bilinear x2 up with the skip concatenated, a sigmoid depth head and a
    normalised normal head (flat keys ``enc/i``, ``dec/i``, ``head_*``)."""

    def __init__(self):
        super().__init__()
        ws = _WIDTHS
        self.enc = nn.ModuleList(_Block(ci, co) for ci, co in zip((3,) + ws[:-1], ws))
        self.dec = nn.ModuleList(_Block(ws[i + 1] + ws[i], ws[i])
                                 for i in range(len(ws) - 2, -1, -1))
        self.head_depth = Conv(ws[0], 1, 3)
        self.head_normal = Conv(ws[0], 3, 3)

    def forward(self, img: torch.Tensor):
        """img [B, H, W, 3] in [0, 1] (H, W multiples of 4) -> (depth
        [B, H, W] in [0, 1], unit normals [B, H, W, 3], camera frame)."""
        x = nchw(img * 2.0 - 1.0)
        skips = []
        for i, blk in enumerate(self.enc):
            x = blk(x)
            if i < len(self.enc) - 1:
                skips.append(x)
                x = max_pool_same(x, 2, 2)
        for blk, skip in zip(self.dec, reversed(skips)):
            x = resize_bilinear(x, skip.shape[2], skip.shape[3])
            x = blk(torch.cat([x, skip], dim=1))
        depth = torch.sigmoid(self.head_depth(x))[:, 0]
        n = nhwc(self.head_normal(x))
        return depth, n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-8)


class MonoPriorInference:
    """The cue backend of extract_monocular_cues: RGB [H, W, 3] in [0, 1] ->
    (depth [H, W] in [0, 1], normal01 [3, H, W] in [0, 1]), on ``device``.
    The frame is edge-padded to a multiple of 4 and the outputs cropped."""

    def __init__(self, ckpt_path: str, device="cuda"):
        self.device = torch.device(device)
        with np.load(ckpt_path) as flat:
            self.model = load_flat_npz(MonoPrior(), flat).to(self.device).eval()

    @torch.no_grad()
    def __call__(self, img: np.ndarray):
        H, W = img.shape[:2]
        x = np.pad(img, ((0, -H % 4), (0, -W % 4), (0, 0)), mode="edge")
        d, n = self.model(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                          .to(self.device)[None])
        d = d[0, :H, :W].cpu().numpy().astype(np.float32)
        n = n[0, :H, :W].cpu().numpy()
        n01 = ((n + 1.0) / 2.0).transpose(2, 0, 1).astype(np.float32)
        return d, n01
