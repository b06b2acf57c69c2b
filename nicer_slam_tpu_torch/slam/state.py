"""The mapping optimizer and the tracking Adam (counterpart of
nicer_slam_tpu/slam/state.py).

Mapping: one Adam(betas=(0.9, 0.99), eps=1e-15) over six groups:

  group            lr
  fine grid        lr * lr_factor_for_fine_grid
  coarse grid      lr * lr_factor_for_coarse_grid
  color grid       lr * lr_factor_for_color_grid
  color MLP        lr
  density (beta)   learning_rate_beta
  coarse MLP       lr

The color MLP group holds the exposure MLP too (``exp_lins``, with
model_exposure). The fine SDF MLP and the rendering net's per-image or
exposure codes (``embeddings``) are frozen (requires_grad off), as in the
JAX package; the fine MLP's weights come from the pretrain file. The reference's optax Adam steps every group on every
iteration, a zero gradient included, so momentum keeps moving a group that
got no gradient (the color grid in the ``base`` color stage, the fine grid
in the ``coarse`` stage); ``fill_missing_grads`` gives torch's Adam, which
skips a parameter whose ``.grad`` is None, the same behaviour. Under the
``sharded`` collective mode (``parallel/mesh.shard_color_grid``, called
before the optimizer is built) the color grid group holds this rank's
rows of the table, so its moments and filled gradients take the shard's
shape; its learning rate stays the group's.

Tracking uses a hand-rolled Adam (torch defaults betas=(0.9, 0.999),
eps=1e-8) whose learning rate changes per step; BA uses a fresh Adam
stepped once, i.e. ``-lr·g/(|g| + eps)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.scene_model import SceneModel


# the Adam groups of the JAX package's optax.multi_transform (its
# make_optimizer); its seventh, set_to_zero for the frozen parameters (the
# fine MLP, the per-image or exposure codes), keeps no state
ADAM_GROUPS = ("fine_grid", "coarse_grid", "color_grid", "color_mlp", "coarse_mlp",
               "density")


class OptimConfig(NamedTuple):
    learning_rate: float = 0.002
    learning_rate_beta: float = 2.0e-3
    lr_factor_for_fine_grid: float = 1.0
    lr_factor_for_coarse_grid: float = 1.0
    lr_factor_for_color_grid: float = 1.0


def param_groups(cfg: OptimConfig, model: SceneModel):
    """[(group name, [params], lr)] in the reference's group order; freezes
    the fine MLP and the per-image codes as a side effect."""
    for p in model.implicit.fine.lins.parameters():
        p.requires_grad_(False)
    if hasattr(model.render, "embeddings"):
        model.render.embeddings.requires_grad_(False)
    lr = cfg.learning_rate
    groups = [("fine_grid", [model.implicit.fine.encoding],
               lr * cfg.lr_factor_for_fine_grid),
              ("coarse_grid", [model.implicit.coarse.encoding],
               lr * cfg.lr_factor_for_coarse_grid)]
    if model.render.cfg.use_grid_feature:
        groups.append(("color_grid", [model.render.encoding],
                       lr * cfg.lr_factor_for_color_grid))
    color_mlp = list(model.render.lins.parameters())
    if hasattr(model.render, "exp_lins"):
        color_mlp += list(model.render.exp_lins.parameters())
    groups.append(("color_mlp", color_mlp, lr))
    if hasattr(model, "density"):
        groups.append(("density", list(model.density.parameters()),
                       cfg.learning_rate_beta))
    groups.append(("coarse_mlp", list(model.implicit.coarse.lins.parameters()), lr))
    return groups


def make_optimizer(cfg: OptimConfig, model: SceneModel) -> torch.optim.Adam:
    return torch.optim.Adam(
        [{"params": ps, "lr": lr, "name": name}
         for name, ps, lr in param_groups(cfg, model)],
        betas=(0.9, 0.99), eps=1e-15)


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """Zero gradient for every optimized parameter that got none."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    step: int


def adam_init(x: torch.Tensor) -> AdamState:
    return AdamState(torch.zeros_like(x), torch.zeros_like(x), 0)


def adam_update(state: AdamState, grad: torch.Tensor, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    step = state.step + 1
    m = b1 * state.m + (1 - b1) * grad
    v = b2 * state.v + (1 - b2) * grad * grad
    # bias corrections in float32, as the reference computes them
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
    update = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
    return update, AdamState(m, v, step)


def fresh_adam_single_step(grad: torch.Tensor, lr: float,
                           eps: float = 1e-8) -> torch.Tensor:
    """First bias-corrected step of a fresh Adam: -lr·g/(|g| + eps)."""
    return -lr * grad / (grad.abs() + eps)
