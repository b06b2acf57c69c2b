"""TSDF fusion from posed depth maps -> GT mesh (counterpart of
nicer_slam_tpu/preprocess/tsdf_fusion.py).

Replaces the reference's Open3D ScalableTSDFVolume step
(preprocess/get_mesh_7scenes.py:12-46): integrate every (depth, pose) pair
into a dense truncated-SDF voxel volume, then extract the zero level set.
The volume lives on ``device`` across the sequence and each frame is one
launch of K9 (``ops/tsdf.py``, ``csrc/tsdf.cu``) on the card.

Usage: python -m nicer_slam_tpu_torch.preprocess.tsdf_fusion \
    --scan_dir <processed scan> --out mesh.ply [--res 256] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import tsdf as tsdf_ops


def fuse_depths(depths, c2ws, K, res: int = 256,
                bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                voxel_trunc: float = 4.0, depth_max: float = 5.0,
                min_weight: float = 1.0, device="cuda"):
    """Fuse a sequence; returns (verts, faces, normals) world-space mesh.

    depths: iterable of [H,W] float depth maps (meters); c2ws: [N,4,4];
    K: [3,3].
    """
    if bounds is None:
        # bound from camera frustum centers ± depth_max
        centers = np.asarray(c2ws)[:, :3, 3]
        lo = centers.min(0) - depth_max
        hi = centers.max(0) + depth_max
    else:
        lo, hi = bounds
    voxel = float(np.max(np.asarray(hi) - np.asarray(lo)) / res)
    sdf_trunc = voxel_trunc * voxel

    dev = torch.device(device)
    coords = tsdf_ops.axis_coords(res, lo, hi, dev)
    tsdf = torch.ones(res ** 3, dtype=torch.float32, device=dev)
    weight = torch.zeros(res ** 3, dtype=torch.float32, device=dev)
    K_t = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    for depth, c2w in zip(depths, c2ws):
        w2c = np.linalg.inv(c2w).astype(np.float32)
        tsdf_ops.integrate(tsdf, weight, torch.as_tensor(np.asarray(depth, np.float32),
                                                         device=dev),
                           torch.as_tensor(w2c, device=dev), K_t, coords, sdf_trunc,
                           depth_max)

    tsdf_np = tsdf.cpu().numpy().reshape(res, res, res)
    w_np = weight.cpu().numpy().reshape(res, res, res)

    from ..ops.marching_cubes import marching_tetrahedra

    step = [(hi[d] - lo[d]) / (res - 1) for d in range(3)]
    # only mesh fully-observed cubes: suppresses the phantom shell at the
    # truncation/observation boundary behind surfaces
    return marching_tetrahedra(tsdf_np, level=0.0, spacing=tuple(step),
                               origin=tuple(lo),
                               valid=w_np >= min_weight)


def main(argv=None):
    """CLI: fuse 7-Scenes GT depth into a GT mesh
    (get_mesh_7scenes.py equivalent)."""
    import cv2

    p = argparse.ArgumentParser()
    p.add_argument("--scan_dir", required=True,
                   help="processed scan dir with *_gt_depth.png + cameras.npz")
    p.add_argument("--out", required=True, help="output .ply")
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--depth_scale", type=float, default=1000.0)
    p.add_argument("--every", type=int, default=5)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    from ..utils.camera import load_K_Rt_from_P
    from ..utils.ply import write_ply

    cams = np.load(os.path.join(a.scan_dir, "cameras.npz"))
    depth_files = sorted(glob(os.path.join(a.scan_dir, "*_gt_depth.png")))
    idxs = list(range(0, len(depth_files), a.every))
    depths, c2ws = [], []
    K = None
    for i in idxs:
        # world_mat alone (no scale_mat) -> world-frame mesh
        P = cams[f"world_mat_{i}"][:3, :4]
        intr, pose = load_K_Rt_from_P(P)
        K = intr[:3, :3]
        d = cv2.imread(depth_files[i], -1).astype(np.float32) / a.depth_scale
        depths.append(d)
        c2ws.append(pose)
    verts, faces, normals = fuse_depths(depths, np.stack(c2ws), K, res=a.res,
                                        device=a.device)
    write_ply(a.out, verts, faces, normals=normals)
    print(f"wrote {a.out}: {verts.shape[0]} verts, {faces.shape[0]} faces")


if __name__ == "__main__":
    main()
