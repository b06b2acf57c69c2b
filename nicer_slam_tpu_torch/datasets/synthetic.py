"""Synthetic VolSDF-layout scene generator (analytic SDF, sphere tracing).

Produces a directory tree byte-compatible with the reference's processed
data format (preprocess/replica_2_volsdf.py: cameras.npz with
scale_mat/world_mat pairs, *_rgb.png, lzma *_depth.npy / *_normal.npy,
*_gt_depth.png, scan<k>_pair/ flow+occ files) from an analytic room scene,
so integration tests and benchmarks can run end-to-end with exact ground
truth — poses, depth, normals, and optical flow are all closed-form.

Scene: an axis-aligned room (free space positive SDF) with a few spheres;
procedural albedo. Units: the "cube" frame is [-1,1]^3; scale_mat maps cube
-> world with a configurable scale so the gt_depth png path and
assign_scale behavior are exercised realistically.

This package's own copy of nicer_slam_tpu/datasets/synthetic.py: the same
numpy scene, trajectory and files, with the PNGs written through OpenCV
(RGB -> BGR; 16-bit grayscale as is), which the port's dataset loader reads
back.
"""

from __future__ import annotations

import lzma
import os
from typing import List, Tuple

import numpy as np


def _imwrite(path: str, im: np.ndarray) -> None:
    import cv2

    im = np.asarray(im)
    if im.ndim == 3:
        im = np.ascontiguousarray(im[..., ::-1])
    if not cv2.imwrite(path, im):
        raise IOError(f"cannot write {path}")


SPHERES = [
    # (center, radius)
    (np.array([0.35, 0.1, 0.3]), 0.22),
    (np.array([-0.4, -0.25, -0.2]), 0.28),
    (np.array([0.0, 0.45, -0.4]), 0.18),
]
ROOM_R = 0.85  # wall distance (inf-norm)


def scene_sdf(x: np.ndarray) -> np.ndarray:
    """Free-space SDF: positive inside the room & outside objects."""
    room = ROOM_R - np.abs(x).max(axis=-1)
    d = room
    for c, r in SPHERES:
        d = np.minimum(d, np.linalg.norm(x - c, axis=-1) - r)
    return d


def scene_normal(x: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Outward (into free space) normal = grad of the free-space SDF."""
    g = np.zeros_like(x)
    for d in range(3):
        dx = np.zeros((3,), x.dtype)
        dx[d] = eps
        g[..., d] = scene_sdf(x + dx) - scene_sdf(x - dx)
    n = g / (np.linalg.norm(g, axis=-1, keepdims=True) + 1e-12)
    return n


def scene_albedo(x: np.ndarray) -> np.ndarray:
    """Procedural smooth color field in [0,1]^3."""
    r = 0.5 + 0.45 * np.sin(6.0 * x[..., 0] + 2.0 * x[..., 1])
    g = 0.5 + 0.45 * np.sin(5.0 * x[..., 1] - 3.0 * x[..., 2] + 1.0)
    b = 0.5 + 0.45 * np.sin(4.0 * x[..., 2] + 5.0 * x[..., 0] + 2.0)
    return np.stack([r, g, b], axis=-1)


def sphere_trace(origins: np.ndarray, dirs: np.ndarray,
                 max_steps: int = 96, eps: float = 1e-4,
                 t_max: float = 4.0) -> np.ndarray:
    """March along unit ``dirs`` until the free-space SDF crosses zero.
    Returns hit distance t [N] (t_max where no hit)."""
    t = np.zeros(origins.shape[0], np.float64)
    alive = np.ones(origins.shape[0], bool)
    for _ in range(max_steps):
        if not alive.any():
            break
        p = origins[alive] + t[alive, None] * dirs[alive]
        d = scene_sdf(p)
        t[alive] = t[alive] + np.maximum(d, eps * 0.5)
        hit = d < eps
        over = t[alive] > t_max
        idx = np.where(alive)[0]
        alive[idx[hit | over]] = False
    return np.minimum(t, t_max)


CAM_CLEARANCE = 0.06  # min free-space SDF along any generated camera path


def _clear_camera_position(pos: np.ndarray,
                           clearance: float = CAM_CLEARANCE,
                           iters: int = 12) -> np.ndarray:
    """Project a camera position out to >= clearance free-space SDF.

    Round-5 forensics: the raw orbit below passes THROUGH sphere 1 for
    a in [0.45, 0.97] (frames 150-323 at 0.003 rad/frame) — one third of
    every 500-frame benchmark was rendered from INSIDE geometry (all-zero
    gt depth, albedo-fog rgb), which drove the at-scale map deaths and
    ATE misses of rounds 4-5. Sliding along the SDF gradient keeps the
    path smooth (displacement is continuous in `a` and vanishes where the
    raw orbit is already clear)."""
    pos = pos.astype(np.float64)
    for _ in range(iters):
        d = float(scene_sdf(pos))
        if d >= clearance:
            break
        n = scene_normal(pos[None])[0]
        pos = pos + (clearance - d) * n
    return pos


def camera_trajectory(n_frames: int,
                      rad_per_frame: float = 0.03) -> List[np.ndarray]:
    """Smooth collision-free orbit inside the room; returns c2w (cube
    coords).

    The angular velocity is FIXED per frame (not per sequence) so
    frame-to-frame motion matches real SLAM data (~0.01 cube units/frame,
    like Replica at 2000 frames) regardless of sequence length — tracking
    has no basin of attraction otherwise."""
    poses = []
    for i in range(n_frames):
        a = rad_per_frame * i
        pos = np.array([0.35 * np.sin(a), 0.12 * np.sin(2 * a) + 0.05,
                        0.35 * np.cos(a) - 0.1])
        pos = _clear_camera_position(pos)
        # a check that holds under python -O too (an assert would not)
        if not scene_sdf(pos) >= 0.9 * CAM_CLEARANCE:
            raise RuntimeError(f"camera frame {i} could not be cleared from geometry "
                               f"(sdf={float(scene_sdf(pos)):.4f})")
        target = np.array([0.45 * np.sin(a + 1.1), 0.0,
                           0.45 * np.cos(a + 1.1)])
        fwd = target - pos
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])  # y-down camera convention
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = down
        c2w[:3, 2] = fwd
        c2w[:3, 3] = pos
        poses.append(c2w)
    return poses


def _pixel_rays(H: int, W: int, K: np.ndarray, c2w: np.ndarray):
    ys, xs = np.mgrid[0:H, 0:W]
    x_l = (xs + 0.0 - K[0, 2]) / K[0, 0]
    y_l = (ys + 0.0 - K[1, 2]) / K[1, 1]
    dirs_cam = np.stack([x_l, y_l, np.ones_like(x_l)], -1).reshape(-1, 3)
    dirs = dirs_cam @ c2w[:3, :3].T
    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    return c2w[:3, 3], dirs / norm, dirs_cam  # unit world dirs + cam dirs


def render_frame(H: int, W: int, K: np.ndarray, c2w: np.ndarray):
    """Returns rgb [H,W,3] f32, depth_z [H,W] (pinhole z-depth, cube units),
    normal_cam [H,W,3]."""
    o, dirs, dirs_cam = _pixel_rays(H, W, K, c2w)
    t = sphere_trace(np.broadcast_to(o, dirs.shape).copy(), dirs)
    pts = o + t[:, None] * dirs
    n_world = scene_normal(pts)
    albedo = scene_albedo(pts)
    # simple headlight shading for view-dependence
    shade = 0.55 + 0.45 * np.abs((n_world * -dirs).sum(-1, keepdims=True))
    rgb = np.clip(albedo * shade, 0, 1)
    # pinhole z-depth: t is euclidean along unit dir; z = t * dir_cam_z/|dir_cam|
    z_cam = t * (dirs_cam[:, 2] / np.linalg.norm(dirs_cam, axis=-1))
    n_cam = n_world @ c2w[:3, :3]  # R^T n (camera frame)
    return (rgb.reshape(H, W, 3).astype(np.float32),
            z_cam.reshape(H, W).astype(np.float32),
            n_cam.reshape(H, W, 3).astype(np.float32),
            t.reshape(H, W).astype(np.float32))


def true_flow(H: int, W: int, K: np.ndarray, c2w_i: np.ndarray,
              c2w_j: np.ndarray, depth_z_i: np.ndarray):
    """Exact optical flow i->j from geometry. Returns flow [H,W,2] and an
    in-bounds usability mask [H,W]."""
    ys, xs = np.mgrid[0:H, 0:W]
    x_l = (xs - K[0, 2]) / K[0, 0] * depth_z_i
    y_l = (ys - K[1, 2]) / K[1, 1] * depth_z_i
    pts_cam = np.stack([x_l, y_l, depth_z_i], -1).reshape(-1, 3)
    pts_w = pts_cam @ c2w_i[:3, :3].T + c2w_i[:3, 3]
    w2c_j = np.linalg.inv(c2w_j)
    pts_j = pts_w @ w2c_j[:3, :3].T + w2c_j[:3, 3]
    u = K[0, 0] * pts_j[:, 0] / pts_j[:, 2] + K[0, 2]
    v = K[1, 1] * pts_j[:, 1] / pts_j[:, 2] + K[1, 2]
    flow = np.stack([u - xs.reshape(-1), v - ys.reshape(-1)], -1)
    ok = ((pts_j[:, 2] > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H))
    return (flow.reshape(H, W, 2).astype(np.float32),
            ok.reshape(H, W))


def generate(
    out_dir: str,
    scan_id: int = 1,
    n_frames: int = 40,
    H: int = 120,
    W: int = 160,
    world_scale: float = 3.0,
    gt_depth_png_scale: float = 6553.5,
    keyframe_every: int = 10,
    flow_thresh: int = 30,
    with_flow: bool = True,
    assign_scale: float = 20.0,
    rad_per_frame: float = 0.03,
) -> str:
    """Write a full VolSDF-layout scan; returns the data_dir to point the
    conf at. Monocular 'prior' depth is cube_depth/assign_scale so the
    frame-0 metric anchor (loss.py:179-184) is exact.

    ``rad_per_frame`` sets the per-frame camera motion. The default 0.03
    matches the reference *demo* sequence's motion statistics (200 frames
    covering a room sweep); 0.003 gives the Replica-at-2000-frames regime —
    ~10x smaller frame-to-frame motion over the same total sweep — the
    apples-to-apples setting for full-sequence drift studies."""
    inst = os.path.join(out_dir, f"scan{scan_id}")
    pair = os.path.join(out_dir, f"scan{scan_id}_pair")
    os.makedirs(inst, exist_ok=True)
    if with_flow:
        os.makedirs(pair, exist_ok=True)

    f = 0.9 * W
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], np.float64)
    K4 = np.eye(4)
    K4[:3, :3] = K

    # scale_mat: cube -> world (preprocess/replica_2_volsdf.py:40-61 builds
    # this from the scene bbox; here it is a pure similarity)
    scale_mat = np.eye(4, dtype=np.float64)
    scale_mat[:3, :3] *= world_scale

    poses = camera_trajectory(n_frames, rad_per_frame=rad_per_frame)
    cams = {}
    depths = []
    for i, c2w in enumerate(poses):
        rgb, z, n_cam, t_eucl = render_frame(H, W, K, c2w)
        depths.append(z)
        _imwrite(os.path.join(inst, f"{i:06d}_rgb.png"),
                        (rgb * 255).astype(np.uint8))
        # mono prior depth: exact affine of true depth
        mono = (z / assign_scale).astype(np.float32)
        with lzma.open(os.path.join(inst, f"{i:06d}_depth.npy"), "wb") as fh:
            np.save(fh, mono)
        # omnidata normal convention: stored in [0,1], loader maps *2-1
        n_store = ((n_cam.transpose(2, 0, 1) + 1.0) / 2.0).astype(np.float32)
        with lzma.open(os.path.join(inst, f"{i:06d}_normal.npy"), "wb") as fh:
            np.save(fh, n_store)
        # real depth in WORLD units as uint16 png
        gt_depth_world = z * world_scale
        png = np.clip(gt_depth_world * gt_depth_png_scale, 0, 65535)
        _imwrite(os.path.join(inst, f"{i:06d}_gt_depth.png"),
                        png.astype(np.uint16))

        # world_mat = K @ w2c_world, where w2c_world sees world coords
        c2w_world = scale_mat @ c2w  # cube pose lifted to world
        w2c_world = np.linalg.inv(c2w_world)
        cams[f"world_mat_{i}"] = (K4 @ w2c_world).astype(np.float32)
        cams[f"scale_mat_{i}"] = scale_mat.astype(np.float32)

    np.savez(os.path.join(inst, "cameras.npz"), **cams)

    if with_flow:
        kfs = [i for i in range(n_frames) if i % keyframe_every == 0]
        for i in kfs:
            for j in kfs:
                if 0 < abs(i - j) <= flow_thresh:
                    flow, ok = true_flow(H, W, K, poses[i], poses[j],
                                         depths[i])
                    with lzma.open(
                            os.path.join(pair, f"{i:04d}_{j:04d}_flow.npy"),
                            "wb") as fh:
                        np.save(fh, flow)
                    occ = np.where(ok, 0, 255).astype(np.uint8)
                    _imwrite(
                        os.path.join(pair, f"{i:04d}_{j:04d}_occ.png"),
                        np.stack([occ] * 3, -1))
    return out_dir


def generate_eval(
    out_dir: str,
    scan_id: int = 1,
    n_views: int = 4,
    H: int = 120,
    W: int = 160,
    world_scale: float = 3.0,
    gt_depth_png_scale: float = 6553.5,
) -> str:
    """Held-out extrapolation views of the SAME scene, written to
    ``<out_dir>_eval/scan<id>`` (the layout eval_rendering's extrapolate
    method expects, reference preprocess/replica_eval_2_volsdf.py: same
    world scaling, novel viewpoints off the training trajectory)."""
    inst = os.path.join(out_dir + "_eval", f"scan{scan_id}")
    os.makedirs(inst, exist_ok=True)

    f = 0.9 * W
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], np.float64)
    K4 = np.eye(4)
    K4[:3, :3] = K
    scale_mat = np.eye(4, dtype=np.float64)
    scale_mat[:3, :3] *= world_scale

    # novel views: the training orbit phase-shifted and lifted — inside the
    # room but never coincident with training poses
    base = camera_trajectory(n_views * 7 + 9)
    poses = [base[7 * i + 9].copy() for i in range(n_views)]
    for i, p in enumerate(poses):
        p[:3, 3] += np.array([0.0, -0.08 + 0.03 * i, 0.0])

    cams = {}
    for i, c2w in enumerate(poses):
        rgb, z, _, _ = render_frame(H, W, K, c2w)
        _imwrite(os.path.join(inst, f"{i:06d}_rgb.png"),
                        (rgb * 255).astype(np.uint8))
        png = np.clip(z * world_scale * gt_depth_png_scale, 0, 65535)
        _imwrite(os.path.join(inst, f"{i:06d}_gt_depth.png"),
                        png.astype(np.uint16))
        c2w_world = scale_mat @ c2w
        cams[f"world_mat_{i}"] = (K4 @ np.linalg.inv(c2w_world)).astype(np.float32)
        cams[f"scale_mat_{i}"] = scale_mat.astype(np.float32)
    np.savez(os.path.join(inst, "cameras.npz"), **cams)
    return inst
