"""Train the RGB-only monocular prior (models/mono_prior.py) on procedural
room scenes with closed-form depth and normals (counterpart of
tools/train_mono_prior.py).

  python -m nicer_slam_tpu_torch.training.train_mono_prior --steps 3000 \\
      --n-scenes 60 --frames-per-scene 8 --out mono_prior.npz [--device cuda|cpu]

Scenes are randomised variants of the synthetic generator's room (the
sphere count, centres and radii drawn per scene, the same procedural albedo
family), rendered by the port's copy of the generator, so the prior learns
RGB -> geometry for this scene family from scratch. Loss: mean |depth -
depth_gt| + 0.5 · mean (1 - n · n_gt); Adam (lr 3e-4, optax's defaults:
b2 0.999, eps 1e-8). The weights start as the JAX package's
``init_mono_prior(seed)`` draws them (``init_weights``: one numpy
Generator) and the batches are drawn from another (seed + 1), so both
tools see the same data in the same order. The output is the JAX
package's flat layout (``models/layers.to_flat``), which both packages'
mono prior load.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np
import torch

from ..datasets import synthetic as syn
from ..models.layers import load_flat_npz, to_flat
from ..models.mono_prior import _WIDTHS, MonoPrior


def render_dataset(n_scenes: int, frames_per_scene: int, H: int, W: int, seed: int = 0):
    """Randomised procedural scenes -> (rgb [N, H, W, 3], depth01 [N, H, W],
    normal_cam [N, H, W, 3])."""
    rng = np.random.default_rng(seed)
    rgbs, deps, nrms = [], [], []
    orig = syn.SPHERES
    try:
        for s in range(n_scenes):
            n_sph = rng.integers(2, 6)
            spheres = []
            for _ in range(n_sph):
                c = rng.uniform(-0.55, 0.55, 3)
                r = rng.uniform(0.12, 0.3)
                spheres.append((c, float(r)))
            syn.SPHERES = spheres
            f = 0.9 * W
            K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
            start = rng.integers(0, 120)
            poses = syn.camera_trajectory(start + frames_per_scene * 11)
            for i in range(frames_per_scene):
                c2w = poses[start + i * 11]
                rgb, z, n_cam, _ = syn.render_frame(H, W, K, c2w)
                rgbs.append(rgb)
                deps.append(np.clip(z / 2.5, 0, 1).astype(np.float32))
                nrms.append(n_cam)
            if (s + 1) % 10 == 0:
                print(f"rendered {s + 1}/{n_scenes} scenes", flush=True)
    finally:
        syn.SPHERES = orig
    return np.stack(rgbs), np.stack(deps), np.stack(nrms)


def init_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's ``init_mono_prior(seed)`` in its flat layout:
    convolutions HWIO, normal with std sqrt(2 / (kh kw ci)), biases 0,
    drawn from one numpy Generator in its order."""
    rng = np.random.default_rng(seed)
    flat = {}

    def conv(name, ci, co):
        std = np.sqrt(2.0 / (3 * 3 * ci))
        flat[f"{name}/w"] = rng.normal(0, std, (3, 3, ci, co)).astype(np.float32)
        flat[f"{name}/b"] = np.zeros((co,), np.float32)

    cin = 3
    for i, w in enumerate(_WIDTHS):
        conv(f"enc/{i}/c1", cin, w)
        conv(f"enc/{i}/c2", w, w)
        cin = w
    ws = list(_WIDTHS)
    for j, i in enumerate(range(len(ws) - 2, -1, -1)):
        conv(f"dec/{j}/c1", ws[i + 1] + ws[i], ws[i])
        conv(f"dec/{j}/c2", ws[i], ws[i])
    conv("head_depth", _WIDTHS[0], 1)
    conv("head_normal", _WIDTHS[0], 3)
    return flat


def losses(model: MonoPrior, x, d, n):
    """(loss, depth L1, normal term) of one batch."""
    pd, pn = model(x)
    l_d = (pd - d).abs().mean()
    l_n = (1.0 - (pn * n).sum(-1)).mean()
    return l_d + 0.5 * l_n, l_d, l_n


def train(steps: int = 3000, n_scenes: int = 60, frames_per_scene: int = 8, H: int = 96,
          W: int = 128, batch: int = 8, lr: float = 3e-4, seed: int = 0,
          out: str = "mono_prior.npz", device="cuda") -> List[dict]:
    """Render the scenes, train, write ``out``; returns every step's losses."""
    dev = torch.device(device)
    rgb, dep, nrm = render_dataset(n_scenes, frames_per_scene, H, W, seed)
    N = rgb.shape[0]
    print(f"dataset: {N} frames at {H}x{W}", flush=True)
    data = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
            for a in (rgb, dep, nrm)]
    model = load_flat_npz(MonoPrior(), init_weights(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed + 1)
    history = []
    for it in range(steps):
        idx = torch.from_numpy(rng.integers(0, N, batch)).to(dev)
        loss, ld, ln = losses(model, *(a[idx] for a in data))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        history.append({"loss": loss.item(), "depth": ld.item(), "normal": ln.item()})
        if it % 200 == 0 or it == steps - 1:
            print(f"step {it}: loss {history[-1]['loss']:.4f} depth "
                  f"{history[-1]['depth']:.4f} normal {history[-1]['normal']:.4f}", flush=True)
    np.savez(out, **to_flat(model))
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB)", flush=True)
    return history


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--n-scenes", type=int, default=60)
    p.add_argument("--frames-per-scene", type=int, default=8)
    p.add_argument("--H", type=int, default=96)
    p.add_argument("--W", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--out", default="mono_prior.npz")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    return train(a.steps, a.n_scenes, a.frames_per_scene, a.H, a.W, a.batch, a.lr,
                 out=a.out, device=a.device)


if __name__ == "__main__":
    main()
