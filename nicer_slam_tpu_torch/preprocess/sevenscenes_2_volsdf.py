"""Convert 7-Scenes to the VolSDF layout (counterpart of
nicer_slam_tpu/preprocess/sevenscenes_2_volsdf.py).

Reference: preprocess/7scenes_2_volsdf.py — calibrated per-scene intrinsics
(the table at :11-19), scale_mat from mesh bbox min-unioned with camera
positions (note: the reference takes np.minimum of BOTH bounds, :73-75 —
we reproduce that literally), invalid depth 65535 -> 0 (:106), seq-01,
stairs limited to 500 frames.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import (compute_scale_mat, copy_or_convert_image,
                     extract_cues_and_flow, make_K4, write_cameras_npz)

# per-scene calibrated intrinsics (7scenes_2_volsdf.py:11-19)
INTRINSICS = {
    "chess": (535.30153598, 533.71239636, 316.85634818, 239.75744442),
    "fire": (534.60449776, 539.02904297, 318.09034465, 248.36314533),
    "heads": (533.48533767, 534.03326847, 315.07657519, 238.83690698),
    "office": (534.924901, 549.31688003, 316.52655936, 256.39520434),
    "pumpkin": (569.2724576, 544.82942106, 346.65669988, 221.8028837),
    "redkitchen": (540.26264666, 545.1689031, 318.22221602, 246.72672228),
    "stairs": (571.97464398, 570.18232961, 326.44024801, 238.53590499),
}
SCENES = list(INTRINSICS.keys())


def convert_scene(data_root: str, out_path: str, scan_id: int, scene: str,
                  with_cues: bool = False, with_flow: bool = False,
                  device="cuda", **cue_kwargs) -> None:
    import cv2

    os.makedirs(out_path, exist_ok=True)
    n = 500 if scene == "stairs" else 1000
    c2ws = []
    for i in range(n):
        pf = os.path.join(data_root, f"frame-{i:06d}.pose.txt")
        if not os.path.exists(pf):
            break
        c2ws.append(np.loadtxt(pf))
    c2ws = np.stack(c2ws)
    n = c2ws.shape[0]
    cam_pos = c2ws[:, :3, 3]

    from ..utils.ply import read_ply

    mesh = read_ply(os.path.join(data_root, "..", "..", "meshes",
                                 f"{scene}.ply"))
    min_v = mesh["verts"].min(0).astype(np.float64)
    max_v = mesh["verts"].max(0).astype(np.float64)
    # reference quirk (7scenes_2_volsdf.py:73-75): min-union on both bounds
    min_v = np.minimum(cam_pos.min(0), min_v)
    max_v = np.minimum(cam_pos.max(0), max_v)
    scale_mat = compute_scale_mat(min_v, max_v, enlarge=1.5)

    fx, fy, cx, cy = INTRINSICS[scene]
    K4 = make_K4(fx, fy, cx, cy)
    for i in range(n):
        copy_or_convert_image(
            os.path.join(data_root, f"frame-{i:06d}.color.png"),
            os.path.join(out_path, f"{i:06d}_rgb.png"))
        depth = cv2.imread(os.path.join(data_root, f"frame-{i:06d}.depth.png"), -1)
        depth[depth == 65535] = 0  # 7scenes invalid marker -> 0
        cv2.imwrite(os.path.join(out_path, f"{i:06d}_gt_depth.png"), depth)
    write_cameras_npz(out_path, c2ws, K4, scale_mat)
    if with_cues or with_flow:
        extract_cues_and_flow(out_path, with_cues=with_cues,
                              with_flow=with_flow, device=device, **cue_kwargs)


def main(argv=None):
    p = argparse.ArgumentParser(description="Preprocess 7-Scenes dataset.")
    p.add_argument("--dataset_folder", default="Datasets/orig/7Scenes")
    p.add_argument("--out", default="Datasets/processed/7Scenes")
    p.add_argument("--seq", type=int, default=1)
    p.add_argument("--with_cues", action="store_true")
    p.add_argument("--with_flow", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    for scan_id, scene in enumerate(SCENES, start=1):
        convert_scene(
            os.path.join(a.dataset_folder, scene, f"seq-{a.seq:02d}"),
            os.path.join(a.out, f"scan{scan_id}"), scan_id, scene,
            with_cues=a.with_cues, with_flow=a.with_flow, device=a.device)


if __name__ == "__main__":
    main()
