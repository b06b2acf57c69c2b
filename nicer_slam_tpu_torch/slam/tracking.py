"""Camera tracking: the per-frame pose optimisation (counterpart of
nicer_slam_tpu/slam/tracking.py).

Per iteration: sample pixels of the frame, render, RGB-L1 loss, gradient
with respect to the 7-dof camera tensor [qw qx qy qz tx ty tz] only (the
map parameters take no gradient, so K1/K2 skip their table scatter), one
Adam step with StepLR from the pre-update step count, and the post-step
pose of the minimum pre-step loss is kept. Without a density cache the
prepass is exact; the map does not move while tracking, so the SDF network
is packed for it once per frame. Every ray renders with frame index 0, as
in the JAX package (its per-image and exposure codes are frame 0's). The loop is a Python loop; the
best-candidate bookkeeping stays on the device, so an iteration does not
wait for the host.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..models import scene_model as sm
from ..models.losses import LossConfig, compute_losses
from ..ops import sdf_density
from ..utils.camera import camera_from_tensor
from .state import adam_init, adam_update


class TrackConfig(NamedTuple):
    num_iters: int = 100
    num_pixels: int = 1024
    cam_lr: float = 0.005
    Hedge: int = 0
    Wedge: int = 0
    lr_step_size: int = 50
    lr_gamma: float = 0.95
    rot_lr_scale: float = 1.0
    motion_prior_w: float = 0.0
    motion_prior_rot_w: float = 0.0
    motion_prior_spring: float = 0.0


class TrackDraws(NamedTuple):
    """The random draws of one tracking iteration."""

    pix: torch.Tensor            # [R] int64 in [0, (H-2Hedge)(W-2Wedge))
    render: sm.RenderDraws


def make_track_draws(scene_cfg: sm.SceneConfig, track_cfg: TrackConfig,
                     gen: torch.Generator, device) -> TrackDraws:
    Hc = scene_cfg.H - 2 * track_cfg.Hedge
    Wc = scene_cfg.W - 2 * track_cfg.Wedge
    R = track_cfg.num_pixels
    pix = torch.randint(0, Hc * Wc, (R,), generator=gen, device=device)
    return TrackDraws(pix, sm.make_render_draws(scene_cfg, R, gen, device,
                                                is_mapping=False))


def _uv_from_pix(pix, H, W, Hedge, Wedge):
    Wc = W - 2 * Wedge
    y = pix // Wc + Hedge
    x = pix % Wc + Wedge
    return torch.stack([x, y], dim=-1).to(torch.float32), y * W + x


def track_frame(scene_cfg: sm.SceneConfig, track_cfg: TrackConfig,
                loss_cfg: LossConfig, model: sm.SceneModel,
                voxels: torch.Tensor, full_rgb_u8: torch.Tensor,
                intrinsics: torch.Tensor, init_q: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                density_cache: Optional[torch.Tensor] = None,
                draws: Optional[List[TrackDraws]] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (best_q, final_q, {"losses": [iters], "best_loss": []}).
    ``draws`` (one per iteration) replaces the draws from ``gen``."""
    H, W = scene_cfg.H, scene_cfg.W
    R = track_cfg.num_pixels
    dev = init_q.device
    init_q = init_q.detach()
    q = init_q
    opt = adam_init(q)
    best_loss = torch.tensor(1e10, dtype=torch.float32, device=dev)
    best_q = init_q
    losses = []
    requires = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(False)
    pack = sdf_density.pack_sdf(model.implicit) if density_cache is None else None
    try:
        for it in range(track_cfg.num_iters):
            d = (draws[it] if draws is not None
                 else make_track_draws(scene_cfg, track_cfg, gen, dev))
            uv, flat_idx = _uv_from_pix(d.pix, H, W, track_cfg.Hedge,
                                        track_cfg.Wedge)
            gt = {
                "rgb": full_rgb_u8[flat_idx].to(torch.float32) / 255.0,
                "depth": torch.zeros((R, 1), device=dev),
                "normal": torch.zeros((R, 3), device=dev),
                "gt_depth": torch.zeros((R, 1), device=dev),
                "mask": torch.ones((R, 1), device=dev),
            }
            q7 = q.detach().requires_grad_(True)
            batch = sm.RayBatch(
                uv=uv, kf_slot=torch.zeros((R,), dtype=torch.int64, device=dev),
                poses=camera_from_tensor(q7)[None], intrinsics=intrinsics[None],
                frame_ids=torch.zeros((1,), dtype=torch.int64, device=dev),
                slot_valid=torch.ones((1,), dtype=torch.bool, device=dev),
                ray_valid=torch.ones((R,), dtype=torch.bool, device=dev))
            out = sm.render_rays(scene_cfg, model, voxels, batch, d.render,
                                 stage="fine", color_stage="highfreq",
                                 training=True, is_mapping=False,
                                 density_cache=density_cache, sdf_pack=pack)
            loss = compute_losses(loss_cfg, out, gt, batch, stage="fine",
                                  num_slots=1)["loss"]
            if track_cfg.motion_prior_w or track_cfg.motion_prior_rot_w:
                dq = q7 - init_q
                loss = loss + (track_cfg.motion_prior_rot_w * (dq[:4] ** 2).sum()
                               + track_cfg.motion_prior_w * (dq[4:] ** 2).sum())
            (grad,) = torch.autograd.grad(loss, q7)
            loss = loss.detach()
            lr = track_cfg.cam_lr * track_cfg.lr_gamma ** (opt.step // track_cfg.lr_step_size)
            update, opt = adam_update(opt, grad, lr)
            if track_cfg.rot_lr_scale != 1.0:
                scale = torch.ones_like(update)
                scale[:4] = track_cfg.rot_lr_scale
                update = update * scale
            q_new = q + update
            if track_cfg.motion_prior_spring:
                q_new = q_new - track_cfg.motion_prior_spring * (q_new - init_q)
            better = loss < best_loss
            best_loss = torch.where(better, loss, best_loss)
            best_q = torch.where(better, q_new, best_q)
            q = q_new
            losses.append(loss)
    finally:
        for p, r in zip(model.parameters(), requires):
            p.requires_grad_(r)
    return best_q, q, {"losses": torch.stack(losses), "best_loss": best_loss}
