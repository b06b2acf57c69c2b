"""Camera trajectory evaluation CLI (counterpart of
nicer_slam_tpu/evaluation/eval_cam.py; reference: code/evaluation/eval_cam.py).

Loads PoseParameters/latest, rescales to world units, sim(3)-prealigns the
estimated trajectory to GT, reports rotation/translation errors and
Horn-aligned ATE RMSE, exports a TUM trajectory + alignment sim3 + plot.

Usage: python -m nicer_slam_tpu_torch.evaluation.eval_cam --output <run_dir>
       [--no_plot]
The run dir is <exps>/<expname>_<scan>/<timestamp>/ (contains checkpoints/).
It reads a run of either package (the pose files are the same) and runs
on the host: numpy only.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..slam import checkpoint as ckpt
from . import ate


def evaluate_run(run_dir: str, make_plot: bool = True,
                 world_scale: float = 1.0, gt_traj: str | None = None):
    pose_dir = os.path.join(run_dir, "checkpoints", "PoseParameters")
    est_pose_all, gt_pose_all, frame_idx = ckpt.load_poses(pose_dir)

    keys = sorted(est_pose_all.keys())
    est = np.stack([est_pose_all[k] for k in keys]).astype(np.float64)
    if gt_traj is not None:
        # reference-format TUM GT file (gt_trajs/gt_<ds>_<scene>.txt,
        # eval_cam.py:444-459's evo_ape input): the timestamp column is the
        # frame index — match est frames by it; frames missing from the GT
        # file are dropped from the comparison.
        gt_all, ts = ate.read_tum_trajectory(gt_traj, return_timestamps=True)
        by_frame = {int(round(t)): gt_all[i] for i, t in enumerate(ts)}
        keys = [k for k in keys if int(k) in by_frame]
        if not keys:
            raise ValueError(
                f"no est frames match timestamps in {gt_traj}")
        est = np.stack([est_pose_all[k] for k in keys]).astype(np.float64)
        gt = np.stack([by_frame[int(k)] for k in keys]).astype(np.float64)
    else:
        gt = np.stack([np.asarray(gt_pose_all[k])
                       for k in keys]).astype(np.float64)
    if world_scale != 1.0:
        est[:, :3, 3] *= world_scale
        gt[:, :3, 3] *= world_scale

    aligned34, sim3 = ate.prealign_cameras(est, gt)
    aligned = np.tile(np.eye(4)[None], (aligned34.shape[0], 1, 1))
    aligned[:, :3, :4] = aligned34
    errors = ate.camera_alignment_errors(aligned34, gt[:, :3, :4])
    metrics = ate.evaluate_ate(gt, est, with_scale=True)
    metrics.update(errors)
    # raw alignment-free orientation drift — the sim3 rot_error_deg above
    # is ill-conditioned on short arcs (see ate.rotation_drift docstring)
    metrics.update(ate.rotation_drift(gt, est))
    metrics["n_frames"] = len(keys)

    out_dir = os.path.join(run_dir, "eval_cam")
    os.makedirs(out_dir, exist_ok=True)
    ate.write_tum_trajectory(os.path.join(out_dir, "traj.txt"), est,
                             timestamps=keys)
    # 4x4 sim3 matrix like the reference's
    # alignment_transformation_sim3.npy (eval_cam.py:444-459)
    T = np.eye(4)
    T[:3, :3] = sim3["s0"] / sim3["s1"] * sim3["R"]
    T[:3, 3] = sim3["t0"] - (sim3["s0"] / sim3["s1"]) * (sim3["R"] @ sim3["t1"])
    np.save(os.path.join(out_dir, "alignment_transformation_sim3.npy"), T)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)

    if make_plot:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axp = plt.subplots(figsize=(6, 6))
            axp.plot(gt[:, 0, 3], gt[:, 2, 3], "k-", label="ground truth")
            axp.plot(aligned[:, 0, 3], aligned[:, 2, 3], "b-",
                     label="estimated (aligned)")
            axp.legend()
            axp.set_title(f"ATE RMSE {metrics['ate_rmse']:.4f}")
            fig.savefig(os.path.join(out_dir, "plot.png"), dpi=90)
            plt.close(fig)
        except Exception:
            pass
    return metrics


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output", type=str, required=True,
                   help="run directory containing checkpoints/")
    p.add_argument("--no_plot", action="store_true")
    p.add_argument("--world_scale", type=float, default=1.0,
                   help="multiply translations (e.g. scale_mat[0,0]) to "
                        "report metric units")
    p.add_argument("--gt_traj", type=str, default=None,
                   help="reference-format TUM GT trajectory "
                        "(gt_trajs/gt_<dataset>_<scene>.txt); overrides the "
                        "checkpoint's recorded GT poses")
    a = p.parse_args(argv)
    m = evaluate_run(a.output, make_plot=not a.no_plot,
                     world_scale=a.world_scale, gt_traj=a.gt_traj)
    print(json.dumps(m, indent=2))


if __name__ == "__main__":
    main()
