"""Export reference-format TUM ground-truth trajectories from a processed
VolSDF scan directory (counterpart of scripts/export_gt_trajs.py).

The reference ships its GT trajectories as data files
(``gt_trajs/gt_<dataset>_<scene>.txt``: ``t tx ty tz qx qy qz qw`` with the
timestamp column = frame index, read by eval_cam). This regenerates an
equivalent file for any converted scan (Replica / 7-Scenes / Azure /
synthetic) from its cameras.npz, so ``eval_cam --gt_traj`` has a
reference-format input. Numpy only: no device work.

By default poses are exported in the original world frame (scale_mat
applied, the reference's gt_trajs convention); ``--cube`` exports the
normalized-cube frame instead. Either works for ATE: eval_cam
sim(3)-aligns with scale correction.

Usage:
  python -m nicer_slam_tpu_torch.evaluation.export_gt_trajs \
      --data_dir Datasets/processed/Replica --scan_id 2 \
      --out gt_replica_room0.txt [--n_images 2000] [--cube]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..datasets.scene_dataset import SLAMDataset
from .ate import write_tum_trajectory


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--scan_id", type=int, default=1)
    ap.add_argument("--n_images", type=int, default=0,
                    help="0 = all frames in cameras.npz")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cube", action="store_true",
                    help="export normalized-cube-frame poses (skip scale_mat)")
    args = ap.parse_args(argv)

    n_images = args.n_images
    if not n_images:
        cam_file = os.path.join(args.data_dir, f"scan{args.scan_id}", "cameras.npz")
        with np.load(cam_file) as cam:
            n_images = sum(1 for k in cam.files if k.startswith("world_mat_"))
    # img_res is irrelevant for poses; a tiny value avoids image decoding
    ds = SLAMDataset(data_dir=args.data_dir, img_res=[8, 8],
                     scan_id=args.scan_id, n_images=n_images)
    n = len(ds.gt_pose_all)
    poses = np.stack([np.asarray(ds.gt_pose_all[i], dtype=np.float64)
                      for i in range(n)])
    if not args.cube:
        # cube->world: cameras.npz stores P = world_mat @ scale_mat, the
        # loader decomposes P into cube-frame c2w; the original world pose
        # is scale_mat @ c2w_cube (scale_mat maps cube->world)
        S = np.asarray(ds.get_scale_mat(), dtype=np.float64)
        poses = np.einsum("ij,njk->nik", S, poses)
        # renormalize the rotation (scale_mat's isotropic scale lands in R);
        # dividing by S[0,0] is a rotation only for an isotropic-diagonal S
        s = float(S[0, 0])
        if not np.allclose(S[:3, :3], s * np.eye(3), atol=1e-6 * abs(s)):
            raise ValueError(
                f"scale_mat is not isotropic-diagonal (S[:3,:3]=\n{S[:3, :3]});"
                " world-frame export would produce non-orthonormal rotations —"
                " orthonormalize explicitly or export with --cube")
        poses[:, :3, :3] /= s

    write_tum_trajectory(args.out, poses, timestamps=np.arange(n, dtype=float))
    print(f"wrote {n} poses -> {args.out}")


if __name__ == "__main__":
    main()
