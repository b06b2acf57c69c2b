"""Convert raw Replica captures to the VolSDF layout (counterpart of
nicer_slam_tpu/preprocess/replica_2_volsdf.py).

Reference: preprocess/replica_2_volsdf.py — per scene: scale_mat from the
GT mesh bbox (enlarge 1.5 for rooms / 2.0 for offices), K fixed at
fx=fy=600, cx=599.5, cy=339.5 (1200x680), world_mat = K @ w2c, rgb copied
as %06d_rgb.png, GT depth pngs as %06d_gt_depth.png, then cue/flow
extraction on ``device``.

Usage: python -m nicer_slam_tpu_torch.preprocess.replica_2_volsdf \
    --dataset_folder Datasets/orig/Replica --out Datasets/processed/Replica \
    [--with_cues] [--with_flow] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import (compute_scale_mat, copy_or_convert_image,
                     extract_cues_and_flow, make_K4, write_cameras_npz)

SCENES = ["room0", "room1", "room2", "office0", "office1", "office2",
          "office3", "office4"]


def convert_scene(data_root: str, out_path: str, scan_id: int,
                  with_cues: bool = False, with_flow: bool = False,
                  intrinsics: tuple = (600.0, 600.0, 599.5, 339.5),
                  device="cuda", **cue_kwargs) -> None:
    """``intrinsics`` defaults to the reference's fixed Replica camera
    (fx fy cx cy for 1200x680, reference replica_2_volsdf.py:75-80);
    overridable so tests can convert small synthesized captures through
    the identical pipeline."""
    os.makedirs(out_path, exist_ok=True)
    poses = np.loadtxt(os.path.join(data_root, "traj.txt")).reshape(-1, 4, 4)
    scene = os.path.basename(data_root.rstrip("/"))
    mesh_file = os.path.join(data_root, "..", f"{scene}_mesh.ply")

    from ..utils.ply import read_ply, write_ply

    mesh = read_ply(mesh_file)
    min_v = mesh["verts"].min(0).astype(np.float64)
    max_v = mesh["verts"].max(0).astype(np.float64)
    enlarge = 1.5 if scan_id in (1, 2, 3) else 2.0
    scale_mat = compute_scale_mat(min_v, max_v, enlarge=enlarge)
    # export the cube-normalized GT mesh next to the scans (used by eval_rec)
    norm = np.linalg.inv(scale_mat.astype(np.float64))
    verts_n = mesh["verts"].astype(np.float64) @ norm[:3, :3].T + norm[:3, 3]
    write_ply(os.path.join(out_path, "..", f"{scene}_mesh_{scan_id:02d}.ply"),
              verts_n.astype(np.float32), mesh["faces"],
              normals=mesh.get("normals"), colors=mesh.get("colors"))

    K4 = make_K4(*intrinsics)
    images_dir = os.path.join(data_root, "results")
    for i in range(poses.shape[0]):
        copy_or_convert_image(os.path.join(images_dir, f"frame{i:06d}.jpg"),
                              os.path.join(out_path, f"{i:06d}_rgb.png"))
        copy_or_convert_image(os.path.join(images_dir, f"depth{i:06d}.png"),
                              os.path.join(out_path, f"{i:06d}_gt_depth.png"))
    write_cameras_npz(out_path, poses, K4, scale_mat)
    if with_cues or with_flow:
        extract_cues_and_flow(out_path, with_cues=with_cues,
                              with_flow=with_flow, device=device, **cue_kwargs)


def main(argv=None):
    p = argparse.ArgumentParser(description="Preprocess Replica dataset.")
    p.add_argument("--dataset_folder", default="Datasets/orig/Replica")
    p.add_argument("--out", default="Datasets/processed/Replica")
    p.add_argument("--with_cues", action="store_true")
    p.add_argument("--with_flow", action="store_true")
    p.add_argument("--depth_ckpt", default=None)
    p.add_argument("--normal_ckpt", default=None)
    p.add_argument("--flow_ckpt", default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    for scan_id, scene in enumerate(SCENES, start=1):
        convert_scene(os.path.join(a.dataset_folder, scene),
                      os.path.join(a.out, f"scan{scan_id}"), scan_id,
                      with_cues=a.with_cues, with_flow=a.with_flow,
                      depth_ckpt=a.depth_ckpt, normal_ckpt=a.normal_ckpt,
                      flow_ckpt=a.flow_ckpt, device=a.device)


if __name__ == "__main__":
    main()
