"""Mapping: one map-optimisation step over a keyframe window (counterpart
of nicer_slam_tpu/slam/mapping.py).

Rays live in one flat [R] array; ray r belongs to keyframe slot
r // (R // n_valid) (the reference's equal integer split, remainder rays
masked). Each step samples pixels, gathers ground truth from the device
FrameStore, renders, evaluates the loss stack, steps the 6-group Adam and,
with bundle adjustment, takes the fresh-Adam sign step on the slot poses.

With a ``shard`` (``parallel.mesh.RayShard``, the counterpart of the JAX
package's ``shard_rays``) the step is one rank's part of a ray-parallel
step: the draws are the global ones, this rank renders its slice of rays,
the voxel counter's visits and the per-ray outputs are exchanged in the
forward, and the gradients are summed over the ranks before the Adam and
BA steps (parallel/mesh.py says how).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models import scene_model as sm
from ..models.losses import LossConfig, compute_losses
from ..ops import sdf_density
from ..ops.ray_sampling import perm_slice
from ..utils.camera import camera_from_tensor
from .state import fill_missing_grads, fresh_adam_single_step


class MapConfig(NamedTuple):
    num_pixels: int = 8192
    max_slots: int = 32
    BA_cam_lr: float = 0.001


class MapBatchRefs(NamedTuple):
    """Per-iteration slot data (device tensors)."""

    slot_rows: torch.Tensor     # [Smax] int64 FrameStore row per slot
    frame_ids: torch.Tensor     # [Smax] int64 global frame id per slot
    n_valid: int                # number of valid slots
    intrinsics: torch.Tensor    # [Smax,4,4]
    edge_idii: Optional[torch.Tensor] = None   # [E] int64 slot index
    edge_idjj: Optional[torch.Tensor] = None   # [E] int64 slot index
    flow_imgs: Optional[torch.Tensor] = None   # [E, HW, 2] float16
    flow_occ: Optional[torch.Tensor] = None    # [E, HW] bool (True = usable)
    slot_conf: Optional[torch.Tensor] = None   # [Smax] per-slot loss weight


class MapDraws(NamedTuple):
    pix: torch.Tensor          # [R] int64 in [0, H*W)
    render: sm.RenderDraws


def make_map_draws(scene_cfg: sm.SceneConfig, map_cfg: MapConfig,
                   gen: torch.Generator, device) -> MapDraws:
    R = map_cfg.num_pixels
    pix = torch.randint(0, scene_cfg.H * scene_cfg.W, (R,), generator=gen,
                        device=device)
    return MapDraws(pix, sm.make_render_draws(scene_cfg, R, gen, device,
                                              is_mapping=True))


def slot_confidence(kfs, frame_idx: int, max_slots: int, keyframe_every: int,
                    track_residual, floor: float = 0.3, recency_kf: float = 2.0,
                    residual_beta: float = 0.0) -> np.ndarray:
    """Host-side per-slot loss confidence: floor at pose age 0 ramping to 1
    over recency_kf keyframe periods, optionally divided down for frames
    whose tracking residual was above the window median; frame 0 stays 1."""
    conf = np.ones((max_slots,), np.float32)
    res = [track_residual[kf] for kf in kfs if kf in track_residual]
    med = float(np.median(res)) if res else 0.0
    ramp_span = max(keyframe_every * recency_kf, 1.0)
    for s, kf in enumerate(kfs[:max_slots]):
        if kf == 0:
            continue
        w = floor + (1.0 - floor) * min((frame_idx - kf) / ramp_span, 1.0)
        r = track_residual.get(kf)
        if residual_beta > 0 and r is not None and med > 0:
            w /= 1.0 + residual_beta * max(r / med - 1.0, 0.0)
        conf[s] = w
    return conf


def _ray_slots(R: int, n_valid: int, device):
    """Equal per-slot allocation with the remainder masked."""
    per = R // max(n_valid, 1)
    r = torch.arange(R, dtype=torch.int64, device=device)
    slot = torch.clamp(r // max(per, 1), max=n_valid - 1)
    return slot, r < per * n_valid


def shard_render_draws(draws: sm.RenderDraws, R: int, lo: int, hi: int) -> sm.RenderDraws:
    """The draws of rays lo .. hi - 1 of a mapping step's R: the per-ray
    rows, the prepass chunks' extra bins, the eikonal points of those rays
    (uniform points 10 lo .. 10 hi) and their neighbour offsets, which pair
    with the uniform points and then the rays' near points."""
    nei = draws.eik_nei
    return sm.RenderDraws(
        t_rand=draws.t_rand[lo:hi], perm=perm_slice(draws.perm, R, lo, hi),
        eik_idx=draws.eik_idx[lo:hi], eik_uniform=draws.eik_uniform[10 * lo:10 * hi],
        eik_nei=torch.cat([nei[10 * lo:10 * hi], nei[10 * R + lo:10 * R + hi]]))


def _gather_outputs(out: Dict[str, torch.Tensor], shard, n: int) -> Dict[str, torch.Tensor]:
    """The loss stack's inputs over all ranks' rays from this rank's ``out``
    of n rays: per-ray outputs gathered along their ray axis (the eikonal
    gradients as the uniform points' then the near points', the global
    order), the SDF at the cameras marked replicated."""
    from ..parallel import mesh

    g = {}
    for k, v in out.items():
        if k in ("rgb_values", "depth_values", "normal_map", "sdf") or k.startswith(
                "warp_gt_rgb_"):
            g[k] = mesh.gather_rays(v, shard, 0)
        elif k == "flow" or k.startswith(("warp_sampled_rgb_", "warp_mask_")):
            g[k] = mesh.gather_rays(v, shard, 1)
        elif k in ("grad_theta", "grad_theta_nei"):
            g[k] = torch.cat([mesh.gather_rays(v[:10 * n], shard, 0),
                              mesh.gather_rays(v[10 * n:], shard, 0)])
        elif k == "cam_sdf":
            g[k] = mesh.replicated(v, shard)
        elif k == "voxels":
            g[k] = v
    return g


class FrameData(NamedTuple):
    """The FrameStore's device arrays."""

    rgb: torch.Tensor        # [C, HW, 3] uint8
    depth: torch.Tensor      # [C, HW] f16
    normal: torch.Tensor     # [C, HW, 3] f16
    gt_depth: torch.Tensor   # [C, HW] f16
    mask: torch.Tensor       # [C, HW] bool


def map_step(scene_cfg: sm.SceneConfig, map_cfg: MapConfig,
             loss_cfg: LossConfig, model: sm.SceneModel,
             optimizer: torch.optim.Optimizer, voxels: torch.Tensor,
             poses_q: torch.Tensor, refs: MapBatchRefs, store: FrameData,
             draws: MapDraws, density_cache: Optional[torch.Tensor] = None,
             beta_scale: Optional[float] = None, *, stage: str,
             color_stage: str, ba: bool, is_first_frame: bool = False,
             shard=None) -> tuple:
    """One mapping iteration; updates ``model`` in place through
    ``optimizer``. Returns (voxels, poses_q, terms). Without a
    ``density_cache`` the prepass is exact. With a ``shard`` this rank
    renders its slice of the rays and every rank ends the step with the
    same parameters and poses; ``terms["allreduce_bytes"]`` holds the
    bytes this rank sent in the step's collectives (``mesh.sent_bytes()``
    has them by purpose). Under the ``sharded`` mode the colour grid is
    this rank's rows (``mesh.shard_color_grid``, before the optimizer is
    built) and its gradient arrives summed by the reduce-scatter."""
    H, W = scene_cfg.H, scene_cfg.W
    R = map_cfg.num_pixels
    Smax = map_cfg.max_slots
    dev = poses_q.device

    slot, ray_valid = _ray_slots(R, refs.n_valid, dev)
    pix = draws.pix
    rows = refs.slot_rows[slot]
    uv = torch.stack([(pix % W).to(torch.float32),
                      (pix // W).to(torch.float32)], dim=-1)
    gt = {
        "rgb": store.rgb[rows, pix].to(torch.float32) / 255.0,
        "depth": store.depth[rows, pix].to(torch.float32)[:, None],
        "normal": store.normal[rows, pix].to(torch.float32),
        "gt_depth": store.gt_depth[rows, pix].to(torch.float32)[:, None],
        "mask": store.mask[rows, pix].to(torch.float32)[:, None],
    }
    if refs.edge_idii is not None:
        flow_gt = refs.flow_imgs[:, pix, :].to(torch.float32)      # [E,R,2]
        flow_mask = refs.flow_occ[:, pix]                          # [E,R]
        edges = sm.FlowEdges(idii=refs.edge_idii, idjj=refs.edge_idjj,
                             valid=torch.ones_like(refs.edge_idii, dtype=torch.bool))
    else:
        flow_gt = flow_mask = edges = None
    full_rgb = store.rgb[refs.slot_rows] if scene_cfg.use_warp_loss else None
    # the slots' monocular depth masks the warp patches of ps > 1
    full_depth = (store.depth[refs.slot_rows]
                  if scene_cfg.use_warp_loss and any(p > 1 for p in scene_cfg.patchsizes)
                  else None)
    slot_valid = torch.arange(Smax, device=dev) < refs.n_valid
    ray_weight = refs.slot_conf[slot] if refs.slot_conf is not None else None

    q = poses_q.detach().requires_grad_(ba)
    batch = sm.RayBatch(uv=uv, kf_slot=slot, poses=camera_from_tensor(q),
                        intrinsics=refs.intrinsics, frame_ids=refs.frame_ids,
                        slot_valid=slot_valid, ray_valid=ray_valid,
                        ray_weight=ray_weight)
    bs = (None if beta_scale is None
          else torch.tensor(beta_scale, dtype=torch.float32, device=dev))
    # without a density cache the prepass is exact: the SDF network packed
    # once for this iteration's K6 launch
    pack = sdf_density.pack_sdf(model.implicit) if density_cache is None else None
    render = dict(stage=stage, color_stage=color_stage, training=True, is_mapping=True,
                  edges=edges, full_rgb=full_rgb, full_depth=full_depth,
                  density_cache=density_cache, sdf_pack=pack, beta_scale=bs)
    if shard is None:
        out = sm.render_rays(scene_cfg, model, voxels, batch, draws.render, **render)
    else:
        from ..parallel import mesh

        lo, hi = shard.rays(R)
        mesh.reset_sent()
        mine = batch._replace(
            uv=uv[lo:hi], kf_slot=slot[lo:hi], ray_valid=ray_valid[lo:hi],
            ray_weight=None if ray_weight is None else ray_weight[lo:hi])
        out = _gather_outputs(
            sm.render_rays(scene_cfg, model, voxels, mine,
                           shard_render_draws(draws.render, R, lo, hi),
                           count_sum=mesh.sum_counts, **render),
            shard, hi - lo)
    terms = compute_losses(loss_cfg, out, gt, batch, stage=stage,
                           is_first_frame=is_first_frame, num_slots=Smax,
                           flow_gt=flow_gt, flow_mask=flow_mask, edges=edges)
    optimizer.zero_grad(set_to_none=True)
    terms["loss"].backward()
    fill_missing_grads(optimizer)
    if shard is not None:
        params = [p for group in optimizer.param_groups for p in group["params"]]
        if ba and q.grad is None:
            q.grad = torch.zeros_like(q)
        mesh.allreduce_grads(params + ([q] if ba else []), shard,
                             mesh.bf16_tables(model, shard), mesh.sharded_tables(model, shard))
        # every collective of the step: gathers and reduce-scatters too
        terms["allreduce_bytes"] = torch.tensor(float(sum(mesh.sent_bytes().values())))
    optimizer.step()
    new_q = poses_q
    if ba:
        new_q = (q + fresh_adam_single_step(q.grad, map_cfg.BA_cam_lr)).detach()
    terms = {k: v.detach() for k, v in terms.items()}
    return out["voxels"], new_q, terms
