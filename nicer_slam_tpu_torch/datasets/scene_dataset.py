"""VolSDF-format scene dataset, host side (counterpart of
nicer_slam_tpu/datasets/scene_dataset.py, against this package's camera
module).

On-disk layout (reference: code/datasets/scene_dataset.py:12-290):
  <data_dir>/scan<scan_id>/
    cameras.npz              scale_mat_%d + world_mat_%d per frame
    %06d_rgb.png|jpg         RGB frames
    %06d_depth.npy           monocular depth, lzma-compressed
    %06d_normal.npy          monocular normals in [0,1], lzma-compressed
    %06d_gt_depth.png        real depth (uint16 / gt_depth_png_scale)
    %06d_mask.npy            optional masks
  <data_dir>/scan<scan_id>_pair/
    %04d_%04d_flow.npy       optical flow i->j, lzma npy
    %04d_%04d_occ.png        occlusion mask (0 = usable)
"""

from __future__ import annotations

import lzma
import os
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import fastio
from ..utils.camera import load_K_Rt_from_P


def load_npy_maybe_lzma(path: str) -> np.ndarray:
    """lzma-or-raw npy, through the native fastio runtime when it is
    built (native/build.sh)."""
    if fastio.available():
        try:
            return fastio.load_npy(path)
        except IOError:
            pass
    try:
        with lzma.open(path, "rb") as f:
            return np.load(f, allow_pickle=True)
    except (lzma.LZMAError, ValueError, EOFError):
        return np.load(path, allow_pickle=True)


def _glob_sorted(pattern: str) -> List[str]:
    return sorted(glob(pattern))


class SLAMDataset:
    """Loads camera matrices eagerly, per-frame images lazily (LRU-free
    explicit cache with clean(), matching the reference's memory behavior)."""

    def __init__(
        self,
        data_dir: str,
        img_res: Tuple[int, int],
        scan_id: int = 0,
        use_mask: bool = False,
        use_gt_depth: bool = False,
        keyframe_every: int = 10,
        n_images: int = 2000,
        gt_depth_png_scale: float = 6553.5,
        **_unused,
    ):
        self.data_dir = data_dir
        self.img_res = tuple(img_res)
        self.H, self.W = self.img_res
        self.total_pixels = self.H * self.W
        self.scan_id = scan_id
        self.n_images = n_images
        self.keyframe_every = keyframe_every
        self.gt_depth_png_scale = gt_depth_png_scale

        self.instance_dir = os.path.join(data_dir, f"scan{scan_id}")
        if not os.path.exists(self.instance_dir):
            raise FileNotFoundError(f"Data directory is empty: {self.instance_dir}")
        self.flow_dir = os.path.join(data_dir, f"scan{scan_id}_pair")

        self.cam_file = os.path.join(self.instance_dir, "cameras.npz")
        cam = np.load(self.cam_file)
        self.scene_scale = float(np.float32(cam["scale_mat_0"][0, 0]))

        self.intrinsics_all: List[np.ndarray] = []
        self.gt_pose_all: List[np.ndarray] = []
        for idx in range(n_images):
            scale_mat = cam[f"scale_mat_{idx}"].astype(np.float32)
            world_mat = cam[f"world_mat_{idx}"].astype(np.float32)
            P = (world_mat @ scale_mat)[:3, :4]
            intrinsics, pose = load_K_Rt_from_P(P)
            if not np.isfinite(intrinsics).all():
                intrinsics = self.intrinsics_all[0]
            if not np.isfinite(pose).all():
                pose = np.eye(4, dtype=np.float32)
            self.intrinsics_all.append(intrinsics.astype(np.float32))
            self.gt_pose_all.append(pose.astype(np.float32))

        self.image_paths = (
            _glob_sorted(os.path.join(self.instance_dir, "*_rgb.png"))[:n_images]
            + _glob_sorted(os.path.join(self.instance_dir, "*_rgb.jpg"))[:n_images]
        )
        self.depth_paths = _glob_sorted(
            os.path.join(self.instance_dir, "*_depth.npy"))[:n_images] or None
        self.normal_paths = _glob_sorted(
            os.path.join(self.instance_dir, "*_normal.npy"))[:n_images] or None
        self.mask_paths = (
            _glob_sorted(os.path.join(self.instance_dir, "*_mask.npy"))[:n_images]
            if use_mask else None)
        self.gt_depth_paths = (
            _glob_sorted(os.path.join(self.instance_dir, "*_gt_depth.png"))[:n_images]
            if use_gt_depth else None)

        self.est_pose_all: Dict[int, np.ndarray] = {}
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self) -> int:
        return self.n_images

    # -- lazy per-frame data ------------------------------------------------
    def clean(self, idx: int) -> None:
        self._cache.pop(idx, None)

    def frame(self, idx: int) -> Dict[str, np.ndarray]:
        """All per-frame arrays, flattened to [H*W, C]:
        rgb float32 [HW,3], depth [HW], normal [HW,3] in [-1,1],
        gt_depth [HW] (scene-scaled), mask [HW] bool."""
        if idx in self._cache:
            return self._cache[idx]
        import cv2

        # OpenCV decodes to BGR(A); the reference reads RGB
        bgr = cv2.imread(self.image_paths[idx], cv2.IMREAD_UNCHANGED)
        if bgr is None:
            raise FileNotFoundError(f"cannot read image {self.image_paths[idx]}")
        if bgr.ndim == 2:
            bgr = np.repeat(bgr[..., None], 3, axis=-1)
        rgb = np.asarray(bgr[..., 2::-1], np.float32) / 255.0
        rgb = rgb.reshape(-1, 3)

        if self.depth_paths is not None:
            depth = load_npy_maybe_lzma(self.depth_paths[idx]).reshape(-1)
            depth = depth.astype(np.float32)
        else:
            depth = np.ones((self.total_pixels,), np.float32)

        if self.normal_paths is not None:
            normal = load_npy_maybe_lzma(self.normal_paths[idx])
            normal = normal.reshape(3, -1).T.astype(np.float32)
            normal = normal * 2.0 - 1.0  # omnidata outputs are in [0,1]
        else:
            normal = np.ones((self.total_pixels, 3), np.float32)

        if self.gt_depth_paths is not None:
            import cv2

            gt_depth = cv2.imread(self.gt_depth_paths[idx], -1)
            gt_depth = (np.asarray(gt_depth, np.float32)
                        / self.gt_depth_png_scale).reshape(-1)
            gt_depth = gt_depth / self.scene_scale
        else:
            gt_depth = np.ones((self.total_pixels,), np.float32) / self.scene_scale

        if self.mask_paths is not None:
            mask = np.load(self.mask_paths[idx]).reshape(-1) > 0.5
        elif ("Replica" in self.data_dir) and (self.scan_id == 4):
            # office-4 dynamic-content ignore ranges (scene_dataset.py:183-189)
            ignore = (list(range(0, 300)) + list(range(700, 1400))
                      + list(range(1750, 2000)))
            mask = np.full((self.total_pixels,), idx not in ignore)
        else:
            mask = np.ones((self.total_pixels,), bool)

        data = {"rgb": rgb, "depth": depth, "normal": normal,
                "gt_depth": gt_depth, "mask": mask}
        self._cache[idx] = data
        return data

    # -- flow pairs ----------------------------------------------------------
    def flow_pair(self, i: int, j: int) -> Tuple[np.ndarray, np.ndarray]:
        """(flow [H,W,2], usable-mask [H,W] bool) for edge i->j
        (volsdf_train.py:326-346: occ png channel0 == 0 means usable)."""
        import cv2

        flow = load_npy_maybe_lzma(
            os.path.join(self.flow_dir, f"{i:04d}_{j:04d}_flow.npy"))
        occ = cv2.imread(os.path.join(self.flow_dir, f"{i:04d}_{j:04d}_occ.png"))
        usable = occ[:, :, 0] == 0
        return np.asarray(flow, np.float32), usable
