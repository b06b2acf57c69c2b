#!/usr/bin/env python3
"""The operations of K8 (the 64-wide MLP products that the JAX package
leaves to XLA and the port to ``torch.matmul``) in one flagship mapping
iteration, counted from ``nicer_slam_tpu_torch/models/fields.py`` itself,
and the least time the card could take for them.

  python3 tools/torch_k8_ops.py [--conf confs/replica/runconf_replica_2.conf] [--rays 64]

A mapping iteration runs the MLPs as ``models/scene_model.render_rays``
does: ``fields.combine_get_outputs`` (both SDF networks, their 65 outputs
and the analytic gradient) at every sample of every ray,
``fields.rendering_forward`` at the top-Kc samples of every ray (every
sample without colour top-k), and ``fields.combine_gradient`` at the 22
eikonal points of every ray (10 uniform and one near point, and a
neighbour of each); then the backward of a loss over all of their outputs
(the second-order path of the SDF gradients included). This script runs
exactly that on the CPU for ``--rays`` rays of the conf's networks under
``torch.utils.flop_counter.FlopCounterMode`` (matrix products, forward and
backward) and scales to the conf's mapping rays: every count is linear in
the rays. The hash grids are shrunk to 2^12 rows a level (their tables do
not enter the products; the MLPs' input widths are the conf's). The bound
is the operations at the card's float32 rate outside the tensor cores,
67 TFLOP/s (H100 SXM data sheet), since the port's products run in full
float32 (``allow_tf32`` off).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FP32_OPS_PER_S = 67e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf", default=os.path.join(ROOT, "confs", "replica",
                                                   "runconf_replica_2.conf"))
    ap.add_argument("--rays", type=int, default=64)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from nicer_slam_tpu_torch.config import parse_file
    from nicer_slam_tpu_torch.models import fields
    from nicer_slam_tpu_torch.models import scene_model as sm

    torch.manual_seed(0)
    c = parse_file(args.conf)
    rays = c.get_config("train").get_int("mapping_num_pixels")
    res = c.get_config("dataset").get_list("img_res")
    cfg = sm.scene_config_from_conf(c.get_config("model"), tuple(res), 2)
    small = lambda g: g._replace(logmap=min(g.logmap, 12))
    cfg = cfg._replace(combine=cfg.combine._replace(coarse=small(cfg.combine.coarse),
                                                    fine=small(cfg.combine.fine)))
    if cfg.render.use_grid_feature:
        cfg = cfg._replace(render=cfg.render._replace(
            color_logmap=min(cfg.render.color_logmap, 12)))
    rng = np.random.default_rng(0)
    implicit = fields.CombineNet(cfg.combine, rng)
    render = fields.RenderingNet(cfg.render, rng)

    R = args.rays
    S = cfg.sampler.total_samples
    Kc = cfg.color_topk if 0 < cfg.color_topk < S else S
    x = torch.rand(R * S, 3) * 1.6 - 0.8
    eik = torch.rand(22 * R, 3) * 1.6 - 0.8
    dirs = torch.nn.functional.normalize(torch.randn(R * Kc, 3), dim=-1)
    counts = {}
    with FlopCounterMode(display=False) as fwd_mode:
        sdf, feat, grad = fields.combine_get_outputs(implicit, x, "fine")
        pick = torch.arange(R * Kc) * (S // Kc)
        rgb = fields.rendering_forward(render, x[pick], grad[pick], dirs, feat[pick],
                                       "highfreq")
        grad_theta = fields.combine_gradient(implicit, eik, "fine")
    counts["forward"] = fwd_mode.get_total_flops()
    loss = (sdf.sum() + feat.sum() + grad.square().sum() + rgb.sum()
            + grad_theta.square().sum())
    params = [p for p in list(implicit.parameters()) + list(render.parameters())
              if p.requires_grad]
    with FlopCounterMode(display=False) as bwd_mode:
        torch.autograd.grad(loss, params, allow_unused=True)
    counts["backward"] = bwd_mode.get_total_flops()
    scale = rays / R
    total = scale * (counts["forward"] + counts["backward"])
    out = {
        "conf": os.path.relpath(args.conf, ROOT), "mapping_rays": rays, "samples": S,
        "colour_samples_a_ray": Kc, "eikonal_points_a_ray": 22, "counted_rays": R,
        "forward_ops": scale * counts["forward"], "backward_ops": scale * counts["backward"],
        "total_ops": total, "bound_ms": total / FP32_OPS_PER_S * 1e3,
        "fp32_ops_per_s": FP32_OPS_PER_S,
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
