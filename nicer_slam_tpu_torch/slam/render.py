"""Full-image rendering in fixed-size ray chunks, the vis and eval path
(counterpart of nicer_slam_tpu/slam/render.py).

Every pixel of the frame is one ray; the rays go through ``render_rays``
in chunks of ``chunk`` rays (the conf's ``train.split_n_pixels``), the
tail padded to a full chunk, under ``torch.no_grad()``. Without a density
cache the render takes the exact prepass: one K6 launch per chunk
evaluates the SDF network and the density at all ``N_samples_eval``
prepass samples of every ray, from bf16 tables and weights packed once
per render.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models import scene_model as sm
from ..ops import sdf_density


@torch.no_grad()
def render_image(scene_cfg: sm.SceneConfig, model: sm.SceneModel,
                 voxels: torch.Tensor, c2w: np.ndarray, K: np.ndarray,
                 frame_idx: int = 0, chunk: int = 8192) -> Dict[str, np.ndarray]:
    """(rgb [H,W,3], depth [H,W], camera-space normal [H,W,3]) as numpy."""
    H, W = scene_cfg.H, scene_cfg.W
    dev = voxels.device
    total = H * W
    pix = torch.arange(total, device=dev)
    uv_all = torch.stack([pix % W, pix // W], -1).to(torch.float32)
    # an eval render draws nothing: no jitter, and render_rays takes the
    # extra bins from a linspace
    draws = sm.RenderDraws(t_rand=None, perm=None,
                           eik_idx=torch.zeros((chunk,), dtype=torch.int64, device=dev))
    batch = sm.RayBatch(
        uv=None,
        kf_slot=torch.zeros((chunk,), dtype=torch.int64, device=dev),
        poses=torch.as_tensor(c2w, dtype=torch.float32, device=dev)[None],
        intrinsics=torch.as_tensor(K, dtype=torch.float32, device=dev)[None],
        frame_ids=torch.tensor([frame_idx], dtype=torch.int64, device=dev),
        slot_valid=torch.ones((1,), dtype=torch.bool, device=dev),
        ray_valid=torch.ones((chunk,), dtype=torch.bool, device=dev))
    pack = sdf_density.pack_sdf(model.implicit)
    keys = ("rgb_values", "depth_values", "normal_map")
    outs = {k: [] for k in keys}
    for start in range(0, total, chunk):
        end = min(start + chunk, total)
        uv = uv_all[start:end]
        if end - start < chunk:
            uv = torch.cat([uv, uv.new_zeros((chunk - (end - start), 2))])
        res = sm.render_rays(scene_cfg, model, voxels, batch._replace(uv=uv), draws,
                             stage="fine", color_stage="highfreq", training=False,
                             is_mapping=False, sdf_pack=pack)
        for k in keys:
            outs[k].append(res[k][: end - start].cpu())
    out = {k: torch.cat(v).numpy() for k, v in outs.items()}
    return {"rgb": out["rgb_values"].reshape(H, W, 3),
            "depth": out["depth_values"].reshape(H, W),
            "normal": out["normal_map"].reshape(H, W, 3)}
