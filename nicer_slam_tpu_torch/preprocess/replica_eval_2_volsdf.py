"""Convert held-out Replica extrapolation views into the SLAM scan's scaled
coordinate system (counterpart of nicer_slam_tpu/preprocess/
replica_eval_2_volsdf.py; reference: preprocess/replica_eval_2_volsdf.py) —
no device work: images are copied and cameras written. The
scale_mat is REUSED from the corresponding training scan so eval poses land
in the same cube frame.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import copy_or_convert_image, make_K4, write_cameras_npz

SCENES = ["room0", "room1", "room2", "office0", "office1", "office2",
          "office3", "office4"]


def convert_scene(data_root: str, out_path: str, train_scan_dir: str) -> None:
    os.makedirs(out_path, exist_ok=True)
    scale_mat = np.load(os.path.join(train_scan_dir, "cameras.npz"))["scale_mat_0"]
    poses = np.loadtxt(os.path.join(data_root, "traj.txt")).reshape(-1, 4, 4)
    K4 = make_K4(600.0, 600.0, 599.5, 339.5)
    for i in range(poses.shape[0]):
        copy_or_convert_image(os.path.join(data_root, f"frame{i:06d}.jpg"),
                              os.path.join(out_path, f"{i:06d}_rgb.jpg"))
    write_cameras_npz(out_path, poses, K4, scale_mat)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_folder", default="Datasets/orig/Replica_eval_ext")
    p.add_argument("--processed", default="Datasets/processed/Replica")
    p.add_argument("--out", default="Datasets/processed/Replica_EVAL_EXT")
    a = p.parse_args(argv)
    for scan_id, scene in enumerate(SCENES, start=1):
        convert_scene(os.path.join(a.dataset_folder, scene),
                      os.path.join(a.out, f"scan{scan_id}"),
                      os.path.join(a.processed, f"scan{scan_id}"))


if __name__ == "__main__":
    main()
