"""Shared preprocessing core for the VolSDF on-disk format (counterpart of
nicer_slam_tpu/preprocess/common.py).

Behavioral reference: preprocess/{replica,7scenes,azure}_2_volsdf.py —
scene normalization into the unit cube from the GT-mesh bounding box
(optionally unioned with camera positions), ``world_mat = K @ w2c`` with
``scale_mat`` = cube->world similarity, image copying, and the monocular
cue / optical flow extraction hooks. Images are converted with OpenCV.
"""

from __future__ import annotations

import collections
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np


def compute_scale_mat(min_v: np.ndarray, max_v: np.ndarray,
                      enlarge: float = 1.5) -> np.ndarray:
    """cube->world scale_mat from a world-space bounding box.

    The normalizing transform is built first (world->cube: translate by
    -center then scale by 2/(maxdim*enlarge)) and inverted, exactly like
    replica_2_volsdf.py:44-62."""
    center = (min_v + max_v) / 2.0
    scale = 2.0 / (np.max(max_v - min_v) * enlarge)
    norm = np.eye(4, dtype=np.float64)
    norm[:3, 3] = -center
    norm[:3] *= scale
    return np.linalg.inv(norm).astype(np.float32)


def make_K4(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    K = np.eye(4, dtype=np.float64)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def write_cameras_npz(out_path: str, c2ws: np.ndarray, K4: np.ndarray,
                      scale_mat: np.ndarray) -> None:
    """cameras.npz with world_mat_i = K @ inv(c2w_i) and a shared
    scale_mat_i."""
    cams: Dict[str, np.ndarray] = {}
    for i in range(c2ws.shape[0]):
        cams[f"world_mat_{i}"] = (K4 @ np.linalg.inv(c2ws[i])).astype(np.float32)
        cams[f"scale_mat_{i}"] = scale_mat.astype(np.float32)
    np.savez(os.path.join(out_path, "cameras.npz"), **cams)


class BackgroundWriter:
    """Runs file writes on a few threads while the caller computes the next
    frame: the lzma-compressed cues and flows take seconds a frame at full
    size, and lzma (like OpenCV's encoders) releases the GIL. At most two
    writes per thread are pending; leaving the ``with`` block waits for
    every write and raises the first error."""

    def __init__(self, workers: Optional[int] = None):
        self.workers = workers or min(8, os.cpu_count() or 1)

    def __enter__(self):
        self.pool = ThreadPoolExecutor(self.workers)
        self.pending = collections.deque()
        return self

    def submit(self, fn, *args) -> None:
        if len(self.pending) >= 2 * self.workers:
            self.pending.popleft().result()
        self.pending.append(self.pool.submit(fn, *args))

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                while self.pending:
                    self.pending.popleft().result()
        finally:
            self.pool.shutdown(wait=True, cancel_futures=True)


def read_rgb(path: str) -> np.ndarray:
    """An image file as float32 RGB [H, W, 3] in [0, 1]."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def copy_or_convert_image(src: str, dst: str) -> None:
    """Copy when the extensions agree, else decode and re-encode (OpenCV
    keeps the channel order on both sides, and 16-bit depth stays 16-bit)."""
    if os.path.splitext(src)[1].lower() == os.path.splitext(dst)[1].lower():
        shutil.copyfile(src, dst)
        return
    import cv2

    img = cv2.imread(src, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(src)
    if not cv2.imwrite(dst, img):
        raise OSError(f"cannot write {dst}")


def normalize_mesh_and_export(mesh_path: str, scale_mat_inv_dst: str,
                              norm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Load a GT mesh, return its bbox; export the cube-normalized copy."""
    from ..utils.ply import read_ply, write_ply

    mesh = read_ply(mesh_path)
    verts = mesh["verts"].astype(np.float64)
    min_v, max_v = verts.min(0), verts.max(0)
    verts_n = verts @ norm[:3, :3].T + norm[:3, 3]
    write_ply(scale_mat_inv_dst, verts_n.astype(np.float32), mesh["faces"],
              normals=mesh.get("normals"), colors=mesh.get("colors"))
    return min_v, max_v


def extract_cues_and_flow(out_path: str, *, with_cues: bool = True,
                          with_flow: bool = True,
                          keyframe_every: int = 10,
                          flow_thresh: int = 30,
                          depth_ckpt: Optional[str] = None,
                          normal_ckpt: Optional[str] = None,
                          flow_ckpt: Optional[str] = None,
                          device="cuda") -> None:
    """Monocular cue and optical flow extraction on ``device`` (the
    reference runs them as subprocesses in sibling conda envs,
    replica_2_volsdf.py:96-102)."""
    if with_cues:
        from .extract_monocular_cues import extract_cues

        extract_cues(out_path, out_path, depth_ckpt=depth_ckpt,
                     normal_ckpt=normal_ckpt, device=device)
    if with_flow:
        from .extract_flows import extract_flows

        extract_flows(out_path, out_path + "_pair", ckpt=flow_ckpt,
                      keyframe_every=keyframe_every, thresh=flow_thresh,
                      device=device)
