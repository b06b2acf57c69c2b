"""LPIPS perceptual distance (AlexNet variant) in PyTorch (counterpart of
nicer_slam_tpu/models/lpips.py).

The reference reports PSNR/SSIM/LPIPS for rendering eval
(code/evaluation/eval_rendering.py:43-47,134-170, `lpips.LPIPS(net="alex")`).
This is the same computation (Zhang et al. 2018):

  x -> scaling layer -> AlexNet conv features (5 taps, post-ReLU)
    -> per-tap channel-unit-normalize -> squared diff
    -> learned 1x1 "lin" weights -> spatial mean -> sum over taps

Weights: the flat npz that tools/convert_lpips.py writes from the official
checkpoints (keys ``conv/<i>/w`` HWIO, ``conv/<i>/b``, ``lin/<i>/w``
[1,1,C,1]). Without it, `LPIPSMetric` falls back to a DETERMINISTIC
randomly-initialized AlexNet with uniform lin weights, drawn from numpy in
the JAX package's order (``dpt._init_conv`` per layer), so both packages
build the same network from the same seed. Random-feature distances are
rank-correlated with learned ones but NOT numerically comparable to
official LPIPS values; the metric is then labeled "lpips_randfeat".

The convolutions and max pools are PyTorch library calls (cuDNN on the
card): the JAX package leaves them to XLA, so there is no hand-written
kernel to port. Run them without TF32 (the evaluation CLIs turn it off)
to stay within float32 rounding of the CPU.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# scaling layer constants (PerceptualSimilarity lpips/lpips.py ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet feature geometry: (kernel, stride, pad, cin, cout, pool_before)
_ALEX = (
    (11, 4, 2, 3, 64, False),
    (5, 1, 2, 64, 192, True),
    (3, 1, 1, 192, 384, True),
    (3, 1, 1, 384, 256, False),
    (3, 1, 1, 256, 256, False),
)


def init_lpips(rng_seed: int = 0) -> Dict[str, Any]:
    """The random-feature parameter tree as numpy, in the JAX package's
    layout (conv weights HWIO): the same draws as its ``init_lpips``."""
    rng = np.random.default_rng(rng_seed)
    p: Dict[str, Any] = {"conv": [], "lin": []}
    for (k, s, pad, ci, co, _) in _ALEX:
        std = np.sqrt(2.0 / (k * k * ci))
        p["conv"].append({"w": rng.normal(0, std, (k, k, ci, co)).astype(np.float32),
                          "b": np.zeros((co,), np.float32)})
        # fallback lin weights: uniform average over channels (replaced by
        # the learned weights when a converted checkpoint is loaded)
        p["lin"].append({"w": np.full((1, 1, co, 1), 1.0 / co, np.float32)})
    return p


def load_flat_into(params: Dict[str, Any], flat) -> Dict[str, Any]:
    """Load an npz's 'conv/0/w'-style flat keys into the nested param tree
    (the keys the JAX package's ``dpt._load_flat_into`` reads)."""
    for key in flat.files:
        node, path = params, key.split("/")
        for k in path[:-1]:
            node = node[int(k)] if isinstance(node, list) else node[k]
        last = int(path[-1]) if isinstance(node, list) else path[-1]
        node[last] = np.asarray(flat[key], np.float32)
    return params


class LPIPS(nn.Module):
    """AlexNet-LPIPS: ``forward(img0, img1)`` on [B,H,W,3] images in [0,1]
    gives the [B] perceptual distance."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        self.convs = nn.ModuleList()
        for (k, s, pad, ci, co, _), p in zip(_ALEX, params["conv"]):
            conv = nn.Conv2d(ci, co, k, stride=s, padding=pad)
            with torch.no_grad():
                # HWIO -> OIHW
                conv.weight.copy_(torch.tensor(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))))
                conv.bias.copy_(torch.tensor(np.asarray(p["b"], np.float32)))
            self.convs.append(conv)
        for i, p in enumerate(params["lin"]):
            self.register_buffer(f"lin{i}", torch.tensor(
                np.asarray(p["w"], np.float32).reshape(-1)))
        self.register_buffer("shift", torch.tensor(_SHIFT.reshape(1, 3, 1, 1)))
        self.register_buffer("scale", torch.tensor(_SCALE.reshape(1, 3, 1, 1)))

    def features(self, x: torch.Tensor):
        """x [B,3,H,W] normalized; the 5 post-ReLU tap activations."""
        taps = []
        for (k, s, pad, ci, co, pool), conv in zip(_ALEX, self.convs):
            if pool:
                x = F.max_pool2d(x, 3, 2)          # 3x3, stride 2, VALID
            x = F.relu(conv(x))
            taps.append(x)
        return taps

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        def norm_input(im):
            x = im.permute(0, 3, 1, 2) * 2.0 - 1.0
            return (x - self.shift) / self.scale

        # each image through the network on its own, as the JAX package
        # does: an image against itself is then exactly 0
        t0 = self.features(norm_input(img0))
        t1 = self.features(norm_input(img1))
        total = 0.0
        for i, (a, b) in enumerate(zip(t0, t1)):
            # official normalize_tensor: feat / (||feat||_channels + 1e-10)
            na = a / (torch.sqrt((a * a).sum(1, keepdim=True)) + 1e-10)
            nb = b / (torch.sqrt((b * b).sum(1, keepdim=True)) + 1e-10)
            d = (na - nb) ** 2
            total = total + torch.einsum("bchw,c->b", d, getattr(self, f"lin{i}")) / (
                d.shape[2] * d.shape[3])
        return total


def lpips_from_params(params: Dict[str, Any]) -> LPIPS:
    """The port's module from an LPIPS parameter tree as numpy, e.g. the
    JAX package's ``init_lpips()`` or ``LPIPSMetric.params`` passed through
    ``np.asarray`` leaf by leaf ({"conv": [{"w" HWIO, "b"}], "lin": [{"w"
    [1,1,C,1]}]})."""
    return LPIPS(params).eval()


class LPIPSMetric:
    """Callable (img0, img1 in [0,1] HWC numpy) -> float, on ``device``.

    Loads a converted checkpoint (tools/convert_lpips.py) when present;
    otherwise deterministic random features (metric_name "lpips_randfeat")."""

    def __init__(self, ckpt_path: Optional[str] = None, device="cpu"):
        params = init_lpips()
        if ckpt_path and os.path.exists(ckpt_path):
            with np.load(ckpt_path) as flat:
                params = load_flat_into(params, flat)
            self.metric_name = "lpips"
        else:
            self.metric_name = "lpips_randfeat"
        self.device = torch.device(device)
        self.net = lpips_from_params(params).to(self.device)

    def to(self, device) -> "LPIPSMetric":
        self.device = torch.device(device)
        self.net.to(self.device)
        return self

    @torch.no_grad()
    def __call__(self, img0: np.ndarray, img1: np.ndarray) -> float:
        a = torch.as_tensor(np.asarray(img0, np.float32), device=self.device)[None]
        b = torch.as_tensor(np.asarray(img1, np.float32), device=self.device)[None]
        return float(self.net(a, b)[0])
