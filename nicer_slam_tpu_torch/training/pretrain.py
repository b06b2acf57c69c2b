"""Produce pretrain.npz, the fine SDF MLP's geometric prior (counterpart of
tools/pretrain.py).

The reference hard-loads ``pretrain.pth`` (the fine-level MLP's weights)
but ships neither it nor its recipe; this reproduces its effect. Both SDF
networks of a configuration, with their hash grids, regress the analytic
SDF of procedural rooms (a box room with sphere and box furniture, a new
room every 200 steps) at points drawn uniformly in [-1, 1]³: loss =
mean |sdf - target| + 0.05 · mean (|∇sdf| - 1)² through
``combine_get_outputs`` (K1's forward and backward on the card, the
eikonal term's second order through the MLPs), one Adam (b2 0.99, eps
1e-15) over every parameter. Only the fine MLP is written, as
``fine_lin{i}_{v,g,b}``, which both packages' runners read
(``slam/runner.py`` ``_init_fine_mlp``).

The draws (the networks' init, the rooms, the points) come from one numpy
Generator seeded 0, in the JAX tool's order, so both tools see the same
rooms and points.

  python -m nicer_slam_tpu_torch.training.pretrain --out pretrain.npz \\
      [--steps 2000] [--batch 32768] [--conf confs/replica/runconf_replica_2.conf] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..config import parse_file
from ..models import fields

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CONF = os.path.join(REPO, "confs", "replica", "runconf_replica_2.conf")


def random_scene_sdf(rng: np.random.Generator, n_obj: int = 6):
    """A closure [N, 3] -> the free-space-positive SDF of a random room."""
    room_r = rng.uniform(0.75, 0.92)
    objs = []
    for _ in range(int(rng.integers(2, n_obj + 1))):
        c = rng.uniform(-0.55, 0.55, 3)
        r = rng.uniform(0.08, 0.3)
        kind = rng.integers(0, 2)
        objs.append((kind, c, r))

    def sdf(x):
        d = room_r - np.abs(x).max(axis=-1)
        for kind, c, r in objs:
            if kind == 0:
                od = np.linalg.norm(x - c, axis=-1) - r
            else:
                od = (np.abs(x - c) - r).max(axis=-1)
            d = np.minimum(d, od)
        return d

    return sdf


def make_networks(conf: str, rng: np.random.Generator) -> fields.CombineNet:
    """The configuration's coarse and fine SDF networks, initialised from
    ``rng`` as the JAX package's ``init_combine``."""
    c = parse_file(conf)
    cfg = fields.combine_config_from_conf(c.get_config("model.implicit_network"),
                                          c.get_int("model.feature_vector_size"))
    return fields.CombineNet(cfg, rng)


def make_optimizer(net: fields.CombineNet, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.99), eps=1e-15)


def train_step(net: fields.CombineNet, opt: torch.optim.Optimizer, pts: torch.Tensor,
               target: torch.Tensor):
    """One step of the recipe; returns (loss, sdf L1, eikonal) as tensors."""
    sdf, _, grad = fields.combine_get_outputs(net, pts, "fine")
    data = (sdf[:, 0] - target).abs().mean()
    eik = ((grad.norm(dim=-1) - 1.0) ** 2).mean()
    loss = data + 0.05 * eik
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach(), data.detach(), eik.detach()


def fine_mlp_arrays(net: fields.CombineNet) -> Dict[str, np.ndarray]:
    """The fine MLP as pretrain.npz holds it: ``fine_lin{i}_{v,g,b}``."""
    return {f"fine_lin{i}_{k}": p.detach().cpu().numpy()
            for i, lin in enumerate(net.fine.lins) for k, p in lin.named_parameters()}


def train(steps: int = 2000, batch: int = 32768, lr: float = 2e-3, conf: str = DEFAULT_CONF,
          out: str = "pretrain.npz", device="cuda", log_every: int = 100) -> List[dict]:
    """Run the recipe and write ``out``; returns every step's losses."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    net = make_networks(conf, rng).to(dev)
    opt = make_optimizer(net, lr)
    history = []
    t0 = time.time()
    scene = random_scene_sdf(rng)
    for i in range(steps):
        if i % 200 == 0:
            scene = random_scene_sdf(rng)   # rotate rooms
        pts = rng.uniform(-1, 1, (batch, 3)).astype(np.float32)
        target = scene(pts).astype(np.float32)
        loss, data, eik = train_step(net, opt, torch.from_numpy(pts).to(dev),
                                     torch.from_numpy(target).to(dev))
        history.append({"loss": float(loss), "sdf_l1": float(data), "eik": float(eik)})
        if i % log_every == 0:
            print(f"step {i}: loss {history[-1]['loss']:.4f} sdf-l1 "
                  f"{history[-1]['sdf_l1']:.4f} eik {history[-1]['eik']:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    arrays = fine_mlp_arrays(net)
    np.savez(out, **arrays)
    print(f"wrote {out} ({len(arrays)} arrays)", flush=True)
    return history


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", type=str, default="pretrain.npz")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--conf", type=str, default=DEFAULT_CONF)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    a = p.parse_args(argv)
    return train(a.steps, a.batch, a.lr, a.conf, a.out, "cpu" if a.cpu else a.device)


if __name__ == "__main__":
    main()
