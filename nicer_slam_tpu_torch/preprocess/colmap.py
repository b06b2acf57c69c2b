"""COLMAP sparse-model reader + pose conversion (numpy, self-contained; a
copy of nicer_slam_tpu/preprocess/colmap.py).

Replaces preprocess/colmap_utils/{colmap_read_model,pose_utils}.py: parses
cameras/images/points3D in .bin or .txt format and converts to c2w pose
arrays + pinhole intrinsics. Also a thin shell wrapper to run the colmap
binary when present (colmap_wrapper.py equivalent).
"""

from __future__ import annotations

import os
import struct
import subprocess
from typing import Dict, NamedTuple, Tuple

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


class Camera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class Image(NamedTuple):
    id: int
    qvec: np.ndarray   # [w x y z]
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(fmt, f):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            cid, model_id, w, h = _read("<iiQQ", f)
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{np_}d", f))
            cams[cid] = Camera(cid, name, int(w), int(h), params)
    return cams


def read_images_bin(path: str) -> Dict[int, Image]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            iid = _read("<i", f)[0]
            q = np.array(_read("<4d", f))
            t = np.array(_read("<3d", f))
            cam_id = _read("<i", f)[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read("<Q", f)
            f.read(24 * npts)  # skip 2D points (x, y, point3D_id)
            imgs[iid] = Image(iid, q, t, cam_id, name.decode())
    return imgs


def read_points3d_bin(path: str) -> np.ndarray:
    pts = []
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            _read("<Q", f)               # id
            xyz = _read("<3d", f)
            f.read(3)                    # rgb
            _read("<d", f)               # error
            (track_len,) = _read("<Q", f)
            f.read(8 * track_len)
            pts.append(xyz)
    return np.array(pts)


def read_cameras_txt(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = Camera(int(el[0]), el[1], int(el[2]),
                                      int(el[3]), np.array(el[4:], float))
    return cams


def read_images_txt(path: str) -> Dict[int, Image]:
    imgs = {}
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if not l.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        el = lines[i].split()
        imgs[int(el[0])] = Image(int(el[0]), np.array(el[1:5], float),
                                 np.array(el[5:8], float), int(el[8]), el[9])
        i += 2  # the following line is the (possibly empty) 2D-points line
    return imgs


def read_model(sparse_dir: str):
    """(cameras, images) from a COLMAP sparse dir (.bin preferred)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(os.path.join(sparse_dir, "images.txt"))
    return cams, imgs


def load_colmap_poses(basedir: str) -> Tuple[np.ndarray, np.ndarray]:
    """(c2w [N,4,4] sorted by image name, intrinsics [fx fy cx cy]) from
    <basedir>/sparse/0 (pose_utils.py:11-58 equivalent)."""
    cams, imgs = read_model(os.path.join(basedir, "sparse", "0"))
    cam = next(iter(cams.values()))
    if cam.model == "SIMPLE_PINHOLE" or cam.model == "SIMPLE_RADIAL":
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fx, fy, cx, cy = cam.params[:4]

    order = sorted(imgs.values(), key=lambda im: im.name)
    c2ws = []
    for im in order:
        R = qvec2rotmat(im.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = im.tvec
        c2ws.append(np.linalg.inv(w2c))
    return np.stack(c2ws), np.array([fx, fy, cx, cy])


def run_colmap(basedir: str, match_type: str = "exhaustive_matcher") -> None:
    """Shell out to the colmap binary (colmap_wrapper.py equivalent)."""
    db = os.path.join(basedir, "database.db")
    subprocess.check_call(["colmap", "feature_extractor",
                           "--database_path", db,
                           "--image_path", os.path.join(basedir, "images"),
                           "--ImageReader.single_camera", "1"])
    subprocess.check_call(["colmap", match_type, "--database_path", db])
    sparse = os.path.join(basedir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    subprocess.check_call(["colmap", "mapper", "--database_path", db,
                           "--image_path", os.path.join(basedir, "images"),
                           "--output_path", sparse])
