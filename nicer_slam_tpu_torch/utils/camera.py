"""Camera math: projection decomposition, quaternion SE(3), ray generation.

Counterpart of ``nicer_slam_tpu/utils/camera.py``. Numpy host-side helpers
(dataset loading, the runner's pose bookkeeping) and differentiable torch
versions (inside the render/track/map steps). The ray directions keep the
reference's division by the SQUARED norm (rend_util.py:92), which sets the
z_vals/depth scale convention of the whole system.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# numpy host-side
# ---------------------------------------------------------------------------

def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection into intrinsics K (4x4) and c2w pose (4x4)
    via cv2.decomposeProjectionMatrix (rend_util.py:44-65)."""
    import cv2

    out = cv2.decomposeProjectionMatrix(np.asarray(P, dtype=np.float64))
    K, R, t = out[0], out[1], out[2]
    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K.astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose().astype(np.float32)
    pose[:3, 3] = (t[:3] / t[3])[:, 0].astype(np.float32)
    return intrinsics, pose


def rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion [w x y z] (Shepperd)."""
    R = np.asarray(R, dtype=np.float64)
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        w, x, y, z = 0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s
    elif m00 > m11 and m00 > m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2.0
        w, x, y, z = (m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s
    elif m11 > m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2.0
        w, x, y, z = (m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2.0
        w, x, y, z = (m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s
    q = np.array([w, x, y, z], dtype=np.float64)
    if q[0] < 0:
        q = -q
    return (q / np.linalg.norm(q)).astype(np.float32)


def tensor_from_camera_np(c2w: np.ndarray) -> np.ndarray:
    """4x4 (or 3x4) c2w -> 7-vector [qw qx qy qz tx ty tz]."""
    c2w = np.asarray(c2w)
    quad = rot_to_quat_np(c2w[:3, :3])
    return np.concatenate([quad, np.asarray(c2w[:3, 3], dtype=np.float32)], 0)


def camera_from_tensor_np(t7: np.ndarray) -> np.ndarray:
    """7-vector -> 4x4 c2w, the same float32 arithmetic as camera_from_tensor."""
    t = torch.as_tensor(np.asarray(t7, np.float32))
    return camera_from_tensor(t).numpy()


def clamp_pose_to_anchor_np(pose: np.ndarray, anchor: np.ndarray,
                            trans_radius: float = 0.0,
                            rot_deg: float = 0.0) -> np.ndarray:
    """Clamp a 4x4 c2w pose into a trust region around an anchor pose
    (the BA trust region; 0 disables either clamp)."""
    out = np.asarray(pose, np.float64).copy()
    anchor = np.asarray(anchor, np.float64)
    if trans_radius > 0:
        d = out[:3, 3] - anchor[:3, 3]
        n = float(np.linalg.norm(d))
        if n > trans_radius:
            out[:3, 3] = anchor[:3, 3] + d * (trans_radius / n)
    if rot_deg > 0:
        R_delta = out[:3, :3] @ anchor[:3, :3].T
        cos = np.clip((np.trace(R_delta) - 1.0) / 2.0, -1.0, 1.0)
        theta = float(np.arccos(cos))
        theta_max = np.radians(rot_deg)
        if theta > theta_max and theta > 1e-9:
            ax = np.array([R_delta[2, 1] - R_delta[1, 2],
                           R_delta[0, 2] - R_delta[2, 0],
                           R_delta[1, 0] - R_delta[0, 1]])
            ax = ax / max(np.linalg.norm(ax), 1e-12)
            K = np.array([[0, -ax[2], ax[1]],
                          [ax[2], 0, -ax[0]],
                          [-ax[1], ax[0], 0]])
            R_clamped = (np.eye(3) + np.sin(theta_max) * K
                         + (1 - np.cos(theta_max)) * (K @ K))
            out[:3, :3] = R_clamped @ anchor[:3, :3]
    return out.astype(np.asarray(pose).dtype)


# ---------------------------------------------------------------------------
# Procrustes sim(3) alignment for evaluation (cam_util.py:73-115)
# ---------------------------------------------------------------------------

def procrustes_analysis_np(X0: np.ndarray, X1: np.ndarray):
    """Similarity transform aligning X1 to X0 (both [N,3])."""
    t0 = X0.mean(axis=0, keepdims=True)
    t1 = X1.mean(axis=0, keepdims=True)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = np.sqrt((X0c ** 2).sum(axis=-1).mean())
    s1 = np.sqrt((X1c ** 2).sum(axis=-1).mean())
    U, S, Vt = np.linalg.svd((X0c / s0).T @ (X1c / s1))
    R = (U @ Vt).astype(np.float64)
    if np.linalg.det(R) < 0:
        R[2] *= -1
    return dict(t0=t0[0], t1=t1[0], s0=s0, s1=s1, R=R.astype(np.float32))


def invert_pose_np(pose: np.ndarray) -> np.ndarray:
    """Invert [...,3,4] rigid pose(s)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = np.swapaxes(R, -1, -2)
    t_inv = -(R_inv @ t)
    return np.concatenate([R_inv, t_inv], axis=-1)


def prealign_cameras_apply_another_np(pose: np.ndarray, pose_GT: np.ndarray,
                                      apply_pose: np.ndarray):
    """sim(3)-align ``pose`` onto ``pose_GT`` and apply it to ``apply_pose``.

    All inputs are c2w [N,3,4] (the reference feeds c2w and immediately
    inverts, cam_util.py:94-115). Returns (aligned c2w [N,3,4], sim3 dict).
    """
    pose_w2c = invert_pose_np(pose)
    pose_GT_w2c = invert_pose_np(pose_GT)
    apply_w2c = invert_pose_np(apply_pose)

    def centers(p_w2c):
        # camera center in world coords: invert again and take translation
        inv = invert_pose_np(p_w2c)
        return inv[..., :3, 3]

    center_pred = centers(pose_w2c)
    center_GT = centers(pose_GT_w2c)
    center_apply = centers(apply_w2c)
    try:
        sim3 = procrustes_analysis_np(center_GT, center_pred)
    except np.linalg.LinAlgError:
        sim3 = dict(t0=np.zeros(3), t1=np.zeros(3), s0=1.0, s1=1.0,
                    R=np.eye(3, dtype=np.float32))
    center_aligned = (center_apply - sim3["t1"]) / sim3["s1"] @ sim3["R"].T * sim3["s0"] + sim3["t0"]
    R_aligned = apply_w2c[..., :3] @ sim3["R"].T
    t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
    aligned_w2c = np.concatenate([R_aligned, t_aligned[..., None]], axis=-1)
    return invert_pose_np(aligned_w2c), sim3


# ---------------------------------------------------------------------------
# torch differentiable pose parameterization (general.py:52-100 semantics)
# ---------------------------------------------------------------------------

def quad2rotation(quad: torch.Tensor) -> torch.Tensor:
    """Quaternion [.,4] (w x y z, not necessarily unit) -> [.,3,3], with the
    reference's 2/(q.q) scaling so no explicit normalisation is needed."""
    single = quad.ndim == 1
    if single:
        quad = quad[None]
    qr, qi, qj, qk = quad[:, 0], quad[:, 1], quad[:, 2], quad[:, 3]
    two_s = 2.0 / (quad * quad).sum(-1)
    R = torch.stack([
        torch.stack([1 - two_s * (qj * qj + qk * qk),
                     two_s * (qi * qj - qk * qr),
                     two_s * (qi * qk + qj * qr)], -1),
        torch.stack([two_s * (qi * qj + qk * qr),
                     1 - two_s * (qi * qi + qk * qk),
                     two_s * (qj * qk - qi * qr)], -1),
        torch.stack([two_s * (qi * qk - qj * qr),
                     two_s * (qj * qk + qi * qr),
                     1 - two_s * (qi * qi + qj * qj)], -1),
    ], -2)
    return R[0] if single else R


def camera_from_tensor(t7: torch.Tensor) -> torch.Tensor:
    """[.,7] ([qw qx qy qz tx ty tz]) -> [.,4,4] c2w, differentiable."""
    single = t7.ndim == 1
    if single:
        t7 = t7[None]
    R = quad2rotation(t7[:, :4])
    RT = torch.cat([R, t7[:, 4:, None]], dim=2)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=RT.dtype,
                          device=RT.device).expand(RT.shape[0], 1, 4)
    RT = torch.cat([RT, bottom], dim=1)
    return RT[0] if single else RT


# ---------------------------------------------------------------------------
# ray generation (rend_util.py:68-129 semantics, per-ray flat layout)
# ---------------------------------------------------------------------------

def lift_pixels(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel coords [R,2] at depth 1 -> camera-space homogeneous [R,4]
    (with the skew term, rend_util.py:107-129)."""
    x, y = uv[..., 0], uv[..., 1]
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    sk = K[..., 0, 1]
    z = torch.ones_like(x)
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def rays_from_uv(uv: torch.Tensor, c2w: torch.Tensor, K: torch.Tensor):
    """Per-ray world ray dirs (divided by the squared norm), camera origins
    [R,3], and depth_scale [R,1] (z of the identity-pose ray)."""
    p_cam = lift_pixels(uv, K)
    world = torch.einsum("rij,rj->ri", c2w, p_cam)[..., :3]
    cam_loc = c2w[..., :3, 3]
    dirs = world - cam_loc
    ray_dirs = dirs / (dirs * dirs).sum(-1, keepdim=True)
    dirs_tmp = p_cam[..., :3]
    sq_tmp = (dirs_tmp * dirs_tmp).sum(-1, keepdim=True)
    depth_scale = (dirs_tmp / sq_tmp)[..., 2:3]
    return ray_dirs, cam_loc, depth_scale


def near_far_from_cube(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       bound: float, near_min: float, far_max: float):
    """Axis-aligned cube intersection (ray_sampler.py:23-35)."""
    tmin = (-bound - rays_o) / (rays_d + 1e-15)
    tmax = (bound - rays_o) / (rays_d + 1e-15)
    near = torch.minimum(tmin, tmax).amax(dim=-1, keepdim=True)
    far = torch.maximum(tmin, tmax).amin(dim=-1, keepdim=True)
    miss = far < near
    near = torch.where(miss, torch.full_like(near, 1e9), near)
    far = torch.where(miss, torch.full_like(far, 1e9), far)
    return near.clamp_min(near_min), far.clamp_max(far_max)
