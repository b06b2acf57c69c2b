"""Convert self-captured Azure Kinect scans (COLMAP-posed) to VolSDF layout
(counterpart of nicer_slam_tpu/preprocess/azure_2_volsdf.py).

Reference: preprocess/azure_2_volsdf.py — poses + intrinsics from the
COLMAP sparse model, scale_mat from the dense mesh bbox unioned with camera
positions (max-union here, azure_2_volsdf.py:75-79), images from color/.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from .colmap import load_colmap_poses
from .common import (compute_scale_mat, copy_or_convert_image,
                     extract_cues_and_flow, make_K4, write_cameras_npz)

SCENES = ["1", "2", "3", "4", "5", "6"]
# reference uses poisson for 1,2,3,6, delaunay for 4,5 (azure_2_volsdf.py:66-69)
POISSON_IDS = (1, 2, 3, 6)


def convert_scene(data_root: str, out_path: str, scan_id: int,
                  with_cues: bool = False, with_flow: bool = False,
                  device="cuda", **cue_kwargs) -> None:
    os.makedirs(out_path, exist_ok=True)
    c2ws, intr = load_colmap_poses(data_root)
    fx, fy, cx, cy = intr

    mesh_name = ("meshed-poisson.ply" if scan_id in POISSON_IDS
                 else "meshed-delaunay.ply")
    from ..utils.ply import read_ply

    mesh = read_ply(os.path.join(data_root, "dense", mesh_name))
    min_v = mesh["verts"].min(0).astype(np.float64)
    max_v = mesh["verts"].max(0).astype(np.float64)
    min_v = np.minimum(min_v, c2ws[:, :3, 3].min(0))
    max_v = np.maximum(max_v, c2ws[:, :3, 3].max(0))
    scale_mat = compute_scale_mat(min_v, max_v, enlarge=1.5)

    images = sorted(glob(os.path.join(data_root, "color", "*")))
    n = min(len(images), c2ws.shape[0])
    for i in range(n):
        copy_or_convert_image(images[i],
                              os.path.join(out_path, f"{i:06d}_rgb.png"))
    write_cameras_npz(out_path, c2ws[:n], make_K4(fx, fy, cx, cy), scale_mat)
    if with_cues or with_flow:
        extract_cues_and_flow(out_path, with_cues=with_cues,
                              with_flow=with_flow, device=device, **cue_kwargs)


def main(argv=None):
    p = argparse.ArgumentParser(description="Preprocess Azure dataset.")
    p.add_argument("--dataset_folder", default="Datasets/orig/Azure")
    p.add_argument("--out", default="Datasets/processed/Azure")
    p.add_argument("--with_cues", action="store_true")
    p.add_argument("--with_flow", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    for scan_id, scene in enumerate(SCENES, start=1):
        convert_scene(os.path.join(a.dataset_folder, scene),
                      os.path.join(a.out, f"scan{scan_id}"), scan_id,
                      with_cues=a.with_cues, with_flow=a.with_flow, device=a.device)


if __name__ == "__main__":
    main()
