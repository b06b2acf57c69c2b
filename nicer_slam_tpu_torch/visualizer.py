"""Offline run visualizer (counterpart of the JAX package's visualizer.py;
reference: visualizer.py).

Loads the run's PoseParameters checkpoint, the eval_cam sim(3) alignment if
present, and the per-frame ``vis/surface_%04d.ply`` meshes; renders a
composited frame per mesh (estimated vs GT trajectory over the current
reconstruction) and optionally an mp4.

Usage: python -m nicer_slam_tpu_torch.visualizer --output <run_dir> [--save_rendering]
       [--render_every_frame] [--no_gt_traj]

It reads the checkpoints of either package through this package's
slam/checkpoint.py and runs on the host (numpy and matplotlib).
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output", type=str, required=True,
                   help="run dir (contains checkpoints/ and vis/)")
    p.add_argument("--save_rendering", action="store_true",
                   help="also write vis.mp4")
    p.add_argument("--render_every_frame", action="store_true")
    p.add_argument("--no_gt_traj", action="store_true")
    a = p.parse_args(argv)

    from .slam import checkpoint as ckpt
    from .utils.viz import SLAMFrontend

    est_pose_all, gt_pose_all, _ = ckpt.load_poses(
        os.path.join(a.output, "checkpoints", "PoseParameters"))
    sim3_path = os.path.join(a.output, "eval_cam",
                             "alignment_transformation_sim3.npy")
    sim3 = np.load(sim3_path) if os.path.exists(sim3_path) else np.eye(4)

    keys = sorted(est_pose_all.keys())
    est = [sim3 @ np.asarray(est_pose_all[k]) for k in keys]
    gt = None if a.no_gt_traj else [np.asarray(g) for g in gt_pose_all]

    meshes = sorted(glob(os.path.join(a.output, "vis", "surface_*.ply")))
    frontend = SLAMFrontend(os.path.join(a.output, "vis_frames"),
                            gt_c2w_list=gt)
    if not meshes:
        for i, pose in enumerate(est):
            frontend.update_pose(i, pose)
        frontend.render(title=f"{len(est)} frames")
    else:
        mesh_ids = [int(os.path.basename(m).split("_")[1].split(".")[0])
                    for m in meshes]
        for mesh_path, mid in zip(meshes, mesh_ids):
            frontend.update_mesh(mesh_path)
            for i, k in enumerate(keys):
                if k <= mid:
                    frontend.update_pose(i, est[i])
            frontend.est = frontend.est[: sum(1 for k in keys if k <= mid)]
            frontend.render(title=f"frame {mid}")
    if a.save_rendering:
        out = frontend.make_video(os.path.join(a.output, "vis.mp4"))
        print("video:", out)
    print(f"rendered {frontend.frame_no} frames to {frontend.save_dir}")


if __name__ == "__main__":
    main()
