"""Novel-view rendering evaluation (counterpart of
nicer_slam_tpu/evaluation/eval_rendering.py; reference:
code/evaluation/eval_rendering.py).

Rebuilds the runner from a finished run (is_continue), selects eval views —
``interpolate``: every 100th input frame starting at 2
(scene_dataset.py:311); ``extrapolate``: a held-out eval scan whose GT
poses are sim(3)-prealigned into the SLAM frame via the est-vs-gt
trajectories (scene_dataset.py:345-370) — renders them in chunks, and
reports PSNR/SSIM/LPIPS to csv. The renders run on the runner's device
(the port's kernels on the card), and so does LPIPS; PSNR and SSIM are
numpy on the host.

Usage: python -m nicer_slam_tpu_torch.evaluation.eval_rendering --conf <conf>
       [--eval_method interpolate|extrapolate] [--root_dir .]
       [--exps_folder exps] [--timestamp latest] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils import metrics as M
from ..utils.camera import prealign_cameras_apply_another_np


def eval_views_interpolate(n_images: int) -> List[int]:
    return list(range(2, n_images, 100))


def prealign_eval_poses(est_pose_all: Dict[int, np.ndarray],
                        gt_pose_all: List[np.ndarray],
                        eval_gt_poses: np.ndarray) -> np.ndarray:
    """Map held-out GT eval poses into the SLAM (estimated) frame
    (scene_dataset.py:345-370)."""
    keys = sorted(est_pose_all.keys())
    est = np.stack([est_pose_all[k] for k in keys])[:, :3, :4]
    gt = np.stack([np.asarray(gt_pose_all[k]) for k in keys])[:, :3, :4]
    aligned, _ = prealign_cameras_apply_another_np(
        gt, est, np.asarray(eval_gt_poses)[:, :3, :4])
    out = np.tile(np.eye(4, dtype=np.float32)[None],
                  (aligned.shape[0], 1, 1))
    out[:, :3, :4] = aligned
    return out


def evaluate_rendering(runner, eval_method: str = "interpolate",
                       eval_dataset=None, out_dir: Optional[str] = None
                       ) -> Dict[str, float]:
    H, W = runner.H, runner.W
    rows = []
    if eval_method == "interpolate":
        idxs = eval_views_interpolate(runner.n_images)
        get_pose = lambda i: runner.est_pose_all.get(
            i, runner.dataset.gt_pose_all[i])
        get_rgb = lambda i: runner.dataset.frame(i)["rgb"].reshape(H, W, 3)
        get_K = lambda i: runner.dataset.intrinsics_all[i]
    elif eval_method == "extrapolate":
        assert eval_dataset is not None
        idxs = list(range(len(eval_dataset.gt_pose_all)))
        eval_poses = prealign_eval_poses(
            runner.est_pose_all, runner.dataset.gt_pose_all,
            np.stack(eval_dataset.gt_pose_all))
        get_pose = lambda i: eval_poses[i]
        get_rgb = lambda i: eval_dataset.frame(i)["rgb"].reshape(H, W, 3)
        get_K = lambda i: eval_dataset.intrinsics_all[i]
    else:
        raise ValueError(eval_method)

    for i in idxs:
        out = runner.render_full_image(i, pose=np.asarray(get_pose(i)))
        gt_rgb = get_rgb(i)
        row = {
            "frame": i,
            "psnr": M.psnr(out["rgb"], gt_rgb),
            "ssim": M.ssim(out["rgb"], gt_rgb),
            "lpips": M.lpips(out["rgb"], gt_rgb, device=runner.device),
        }
        rows.append(row)
        runner.dataset.clean(i)

    agg = {
        "psnr": float(np.mean([r["psnr"] for r in rows])),
        "ssim": float(np.mean([r["ssim"] for r in rows])),
        "lpips": (float(np.mean([r["lpips"] for r in rows]))
                  if rows and rows[0]["lpips"] is not None else None),
        # "lpips" with converted official weights, "lpips_randfeat" when
        # running on the documented random-feature fallback (models/lpips.py)
        "lpips_metric": getattr(M._lpips_fn, "metric_name", "lpips"),
        "n_views": len(rows),
        "eval_method": eval_method,
    }

    out_dir = out_dir or os.path.join(runner.rundir, "eval_rendering")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{eval_method}.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=["frame", "psnr", "ssim", "lpips"])
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(out_dir, f"{eval_method}.log"), "w") as f:
        json.dump(agg, f, indent=2)
    return agg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--conf", type=str, required=True)
    p.add_argument("--eval_method", type=str, default="interpolate",
                   choices=["interpolate", "extrapolate"])
    p.add_argument("--scan_id", type=int, default=-1)
    p.add_argument("--exps_folder", type=str, default="exps")
    p.add_argument("--root_dir", type=str, default=".")
    p.add_argument("--timestamp", type=str, default="latest")
    p.add_argument("--checkpoint", type=str, default="latest")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cpu runs the kernels' plain versions)")
    a = p.parse_args(argv)

    import torch

    from ..slam.runner import SLAMRunner

    # float32 convolutions and matmuls in full float32, as the reference
    # package's XLA ones
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runner = SLAMRunner(conf=a.conf, exps_folder_name=a.exps_folder,
                        is_continue=True, timestamp=a.timestamp,
                        checkpoint=a.checkpoint, scan_id=a.scan_id,
                        root_dir=a.root_dir, quiet=True, device=a.device)
    eval_ds = None
    if a.eval_method == "extrapolate":
        from ..datasets.scene_dataset import SLAMDataset

        c = runner.conf
        eval_ds = SLAMDataset(
            data_dir=c.get_string("dataset.data_dir") + "_eval",
            img_res=c.get_list("dataset.img_res"),
            scan_id=runner.scan_id, n_images=100)
    agg = evaluate_rendering(runner, a.eval_method, eval_ds)
    print(json.dumps(agg, indent=2))


if __name__ == "__main__":
    main()
