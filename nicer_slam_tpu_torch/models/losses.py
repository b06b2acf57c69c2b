"""The SLAM loss stack (counterpart of nicer_slam_tpu/models/losses.py).

RGB L1, scale/shift-invariant monocular depth, normal L1 + cosine,
eikonal, smoothness, optical flow, warp, GT depth (frame-0 metric anchor)
and the camera free-space hinge, on the flat-ray layout.

``_masked_mean`` is reproduced exactly as the reference package has it: the
numerator selects with ``mask != 0`` (binarising fractional weights) while
the denominator sums the weights themselves.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..config import Config

from ..ops.safe_math import safe_norm, safe_normalize
from .scene_model import FlowEdges, RayBatch


class LossConfig(NamedTuple):
    rgb_loss_weight: float = 1.0
    eikonal_weight: float = 0.0
    smooth_weight: float = 0.0
    depth_weight: float = 0.0
    normal_l1_weight: float = 0.0
    normal_cos_weight: float = 0.0
    gt_depth_weight: float = 0.0
    flow_weight: float = 0.0
    warp_loss_weight: float = 0.0
    warp_loss_type: str = "l1"
    assign_scale_shift_init: bool = False
    assign_scale: float = 20.0
    full_depth_mask: bool = False
    cam_freespace_w: float = 0.0
    cam_freespace_margin: float = 0.05


def loss_config_from_conf(conf: Config, full_depth_mask: bool = False) -> LossConfig:
    return LossConfig(
        rgb_loss_weight=conf.get_float("rgb_loss_weight", 1.0),
        eikonal_weight=conf.get_float("eikonal_weight", 0.0),
        smooth_weight=conf.get_float("smooth_weight", 0.005)
        if "smooth_weight" in conf else 0.0,
        depth_weight=conf.get_float("depth_weight", 0.0),
        normal_l1_weight=conf.get_float("normal_l1_weight", 0.0),
        normal_cos_weight=conf.get_float("normal_cos_weight", 0.0),
        gt_depth_weight=conf.get_float("gt_depth_weight", 0.0),
        flow_weight=conf.get_float("flow_weight", 0.0),
        warp_loss_weight=conf.get_float("warp_loss_weight", 0.0),
        warp_loss_type=conf.get_string("warp_loss_type", "l1"),
        assign_scale_shift_init=conf.get_bool("assign_scale_shift_init", False),
        assign_scale=conf.get_float("assign_scale", 20.0),
        full_depth_mask=full_depth_mask,
        cam_freespace_w=conf.get_float("cam_freespace_w", 0.0),
        cam_freespace_margin=conf.get_float("cam_freespace_margin", 0.05),
    )


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    # select before reduce: a masked inf/NaN never reaches the sum
    m = torch.broadcast_to(mask, x.shape)
    num = torch.where(m != 0, x, torch.zeros_like(x)).sum()
    return num / m.to(x.dtype).sum().clamp_min(1.0)


def _segment_sum(v: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of ``v`` [R] per segment id ``seg`` [R] in [0, n): a one-hot
    select and a sum over the rows, whose order is fixed, where index_add's
    float atomics on the card would land in any order and change the last
    bits from run to run. n is the window's slot count (at most ~15), so
    the [R, n] select is small; a value outside its segment never enters
    another's sum (select, not multiply)."""
    onehot = seg[:, None] == torch.arange(n, device=seg.device)
    return torch.where(onehot, v[:, None], 0.0).sum(0)


def ssi_depth_loss(pred, target, mask, seg_ids, num_segments, alpha: float = 0.5):
    """ScaleAndShiftInvariantLoss(alpha=0.5, scales=1) on the flat layout
    (MiDaS.py:121-140): per-slot least-squares scale/shift (no gradient),
    data term plus the consecutive-ray gradient term."""
    a00 = _segment_sum(mask * pred * pred, seg_ids, num_segments)
    a01 = _segment_sum(mask * pred, seg_ids, num_segments)
    a11 = _segment_sum(mask, seg_ids, num_segments)
    b0 = _segment_sum(mask * pred * target, seg_ids, num_segments)
    b1 = _segment_sum(mask * target, seg_ids, num_segments)
    det = a00 * a11 - a01 * a01
    valid = det != 0
    safe_det = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    scale = torch.where(valid, (a11 * b0 - a01 * b1) / safe_det, zero).detach()
    shift = torch.where(valid, (-a01 * b0 + a00 * b1) / safe_det, zero).detach()
    pred_ssi = scale[seg_ids] * pred + shift[seg_ids]

    res = pred_ssi - target
    msum = mask.sum()
    msum_safe = msum.clamp_min(1.0)
    zero_s = torch.zeros_like(msum)
    data = torch.where(msum > 0, (mask * res * res).sum() / (2.0 * msum_safe), zero_s)
    diff = mask * (pred_ssi - target)
    pair = (seg_ids[1:] == seg_ids[:-1]).to(pred.dtype)
    grad = (diff[1:] - diff[:-1]).abs() * mask[1:] * mask[:-1] * pair
    reg = torch.where(msum > 0, grad.sum() / msum_safe, zero_s)
    return data + alpha * reg


def eikonal_loss(grad_theta):
    return ((safe_norm(grad_theta, dim=1) - 1.0) ** 2).mean()


def smooth_loss(g1, g2):
    n1 = g1 / (safe_norm(g1, dim=1, keepdim=True) + 1e-5)
    n2 = g2 / (safe_norm(g2, dim=1, keepdim=True) + 1e-5)
    return safe_norm(n1 - n2, dim=-1).mean()


def normal_losses(normal_pred, normal_gt, mask):
    ng = safe_normalize(normal_gt, dim=-1) * mask
    np_ = safe_normalize(normal_pred, dim=-1) * mask
    l1 = (np_ - ng).abs().sum(dim=-1).mean()
    cos = (1.0 - (np_ * ng).sum(dim=-1)).mean()
    return l1, cos


def compute_losses(cfg: LossConfig, outputs: Dict[str, torch.Tensor],
                   gt: Dict[str, torch.Tensor], batch: RayBatch, *,
                   stage: str = "fine", is_first_frame: bool = False,
                   num_slots: int = 1, flow_gt: Optional[torch.Tensor] = None,
                   flow_mask: Optional[torch.Tensor] = None,
                   edges: Optional[FlowEdges] = None) -> Dict[str, torch.Tensor]:
    rgb_pred = outputs["rgb_values"]
    depth_pred = outputs["depth_values"][:, 0]
    normal_pred = outputs["normal_map"]
    dev = rgb_pred.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    rw = batch.ray_valid.to(torch.float32)
    if batch.ray_weight is not None:
        rw = rw * batch.ray_weight
    ff = 1.0 if is_first_frame else 0.0

    terms: Dict[str, torch.Tensor] = {}
    terms["rgb_loss"] = _masked_mean((rgb_pred - gt["rgb"]).abs(), rw[:, None])

    sdf = outputs["sdf"]
    sign_change = (sdf > 0.0).any(dim=-1) & (sdf < 0.0).any(dim=-1)
    mask = (sign_change & (gt["mask"][:, 0] > 0.5)).to(torch.float32) * rw

    # warp at patch size 1 is always L1 (loss.py:132-155)
    if cfg.warp_loss_weight > 0 and stage == "fine" and "warp_sampled_rgb_1" in outputs:
        wmask = outputs["warp_mask_1"]                          # [S,R,1]
        if batch.ray_weight is not None:
            wmask = wmask.to(torch.float32) * rw[None, :, None]
        diff = (outputs["warp_sampled_rgb_1"] - outputs["warp_gt_rgb_1"][None]).abs()
        terms["warp_loss"] = _masked_mean(diff, wmask[..., None]) * (1.0 - ff)
    else:
        terms["warp_loss"] = zero

    has_eik = "grad_theta" in outputs
    terms["eikonal_loss"] = (eikonal_loss(outputs["grad_theta"])
                             if cfg.eikonal_weight > 0 and has_eik else zero)
    terms["smooth_loss"] = (smooth_loss(outputs["grad_theta"], outputs["grad_theta_nei"])
                            if cfg.smooth_weight > 0 and has_eik else zero)

    if cfg.depth_weight > 0:
        depth_mask = rw if cfg.full_depth_mask else mask
        terms["depth_loss"] = ssi_depth_loss(
            depth_pred, gt["depth"][:, 0] * 50.0 + 0.5, depth_mask,
            batch.kf_slot, num_slots)
    else:
        terms["depth_loss"] = zero

    gt_depth_weight = cfg.gt_depth_weight
    depth_real_gt = gt["gt_depth"][:, 0]
    if cfg.assign_scale_shift_init:
        # frame 0 rebinds the term to mono_depth * assign_scale at weight 10
        if is_first_frame:
            depth_real_gt = gt["depth"][:, 0] * cfg.assign_scale
        gt_depth_weight = ff * 10.0
        gt_depth_on = True
    else:
        gt_depth_on = cfg.gt_depth_weight > 0
    if gt_depth_on:
        gt_depth_mask = (gt["gt_depth"][:, 0] > 0).to(torch.float32) * rw
        terms["gt_depth_loss"] = _masked_mean((depth_pred - depth_real_gt).abs(),
                                              gt_depth_mask)
    else:
        terms["gt_depth_loss"] = zero

    if cfg.normal_l1_weight > 0 or cfg.normal_cos_weight > 0:
        terms["normal_l1"], terms["normal_cos"] = normal_losses(
            normal_pred, gt["normal"], mask[:, None])
    else:
        terms["normal_l1"] = terms["normal_cos"] = zero

    if cfg.flow_weight > 0 and "flow" in outputs and flow_gt is not None:
        e_mask = ((batch.kf_slot[None, :] == edges.idii[:, None])
                  & edges.valid[:, None] & flow_mask).to(torch.float32) * rw[None, :]
        terms["flow_loss"] = _masked_mean((outputs["flow"] - flow_gt).abs(),
                                          e_mask[..., None])
    else:
        terms["flow_loss"] = zero

    if cfg.cam_freespace_w > 0 and "cam_sdf" in outputs:
        sv = batch.slot_valid.to(torch.float32)
        hinge = (cfg.cam_freespace_margin - outputs["cam_sdf"]).clamp_min(0.0)
        terms["cam_freespace_loss"] = (hinge * sv).sum() / sv.sum().clamp_min(1.0)
    else:
        terms["cam_freespace_loss"] = zero

    terms["loss"] = (
        cfg.flow_weight * terms["flow_loss"]
        + cfg.depth_weight * terms["depth_loss"]
        + cfg.rgb_loss_weight * terms["rgb_loss"]
        + cfg.smooth_weight * terms["smooth_loss"]
        + cfg.normal_l1_weight * terms["normal_l1"]
        + cfg.warp_loss_weight * terms["warp_loss"]
        + cfg.eikonal_weight * terms["eikonal_loss"]
        + cfg.normal_cos_weight * terms["normal_cos"]
        + gt_depth_weight * terms["gt_depth_loss"]
        + cfg.cam_freespace_w * terms["cam_freespace_loss"])
    return terms
