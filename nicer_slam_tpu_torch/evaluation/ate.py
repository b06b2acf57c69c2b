"""Trajectory alignment + ATE math (counterpart of
nicer_slam_tpu/evaluation/ate.py; reference: code/evaluation/eval_cam.py).

* Horn-method similarity alignment of matched translation sets
  (eval_cam.py:43-74 ``align``) with optional scale.
* ATE RMSE over aligned trajectories (eval_cam.py:107-225).
* sim(3) Procrustes prealignment of full pose sets
  (eval_cam.py:321-342, via utils/cam_util.py).
* rotation / translation error statistics (eval_cam.py:351-358).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..utils.camera import (invert_pose_np, procrustes_analysis_np,
                            prealign_cameras_apply_another_np)


def horn_align(model: np.ndarray, data: np.ndarray,
               with_scale: bool = True):
    """Least-squares rigid(+scale) alignment model->data; both [3,N].

    Returns (rot [3,3], trans [3,1], scale, trans_error [N]).
    """
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    model_zc = model - model_mean
    data_zc = data - data_mean

    W = np.zeros((3, 3))
    for i in range(model.shape[1]):
        W += np.outer(model_zc[:, i], data_zc[:, i])
    U, d, Vh = np.linalg.svd(W.transpose())
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh

    if with_scale:
        rotmodel = rot @ model_zc
        dots = (data_zc * rotmodel).sum()
        norms = (model_zc ** 2).sum()
        s = float(dots / norms) if norms > 0 else 1.0
    else:
        s = 1.0

    trans = data_mean - s * rot @ model_mean
    model_aligned = s * rot @ model + trans
    errs = model_aligned - data
    trans_error = np.sqrt((errs * errs).sum(axis=0))
    return rot, trans, s, trans_error


def evaluate_ate(gt_c2w: np.ndarray, est_c2w: np.ndarray,
                 with_scale: bool = True) -> Dict[str, float]:
    """ATE RMSE (m) after Horn alignment of camera centers.

    gt_c2w/est_c2w: [N,4,4] (or [N,3,4]).
    """
    gt_xyz = np.asarray(gt_c2w)[:, :3, 3].T        # [3,N]
    est_xyz = np.asarray(est_c2w)[:, :3, 3].T
    rot, trans, s, trans_error = horn_align(est_xyz, gt_xyz, with_scale)
    return {
        "ate_rmse": float(np.sqrt((trans_error ** 2).mean())),
        "ate_mean": float(trans_error.mean()),
        "ate_median": float(np.median(trans_error)),
        "ate_std": float(trans_error.std()),
        "ate_min": float(trans_error.min()),
        "ate_max": float(trans_error.max()),
        "scale": s,
    }


def prealign_cameras(est_c2w: np.ndarray, gt_c2w: np.ndarray):
    """sim(3)-align the estimated trajectory onto GT (applied to itself),
    the eval_cam.py:321-342 path. Returns (aligned est c2w [N,3,4], sim3)."""
    est34 = np.asarray(est_c2w)[:, :3, :4]
    gt34 = np.asarray(gt_c2w)[:, :3, :4]
    return prealign_cameras_apply_another_np(est34, gt34, est34)


def camera_alignment_errors(aligned_est: np.ndarray,
                            gt_c2w: np.ndarray) -> Dict[str, float]:
    """Mean rotation (deg) / translation errors between pose sets
    (eval_cam.py:351-358).

    Caveat (matches the reference metric): the sim3 prealignment fits
    camera CENTERS only, so on short or low-spread trajectory arcs the
    world rotation is ill-conditioned and rot_error_deg can be tens of
    degrees even when raw frame-to-frame orientations are within a few
    degrees of GT — compare against the unaligned relative rotations
    before reading a large value as orientation drift."""
    R_a = np.asarray(aligned_est)[:, :3, :3]
    R_g = np.asarray(gt_c2w)[:, :3, :3]
    t_a = np.asarray(aligned_est)[:, :3, 3]
    t_g = np.asarray(gt_c2w)[:, :3, 3]
    RtR = np.einsum("nij,nik->njk", R_a, R_g)  # R_a^T R_g
    tr = np.clip((np.trace(RtR, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    rot_deg = np.degrees(np.arccos(tr))
    t_err = np.linalg.norm(t_a - t_g, axis=-1)
    return {"rot_error_deg": float(rot_deg.mean()),
            "trans_error": float(t_err.mean())}


def _rot_angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Geodesic angle (deg) between rotation sets Ra, Rb: [N,3,3]."""
    RtR = np.einsum("nij,nik->njk", Ra, Rb)  # Ra^T Rb
    tr = np.clip((np.trace(RtR, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


def rotation_drift(gt_c2w: np.ndarray, est_c2w: np.ndarray,
                   return_curve: bool = False) -> Dict[str, float]:
    """Raw, alignment-free orientation drift vs GT.

    The sim3 ``rot_error_deg`` from :func:`camera_alignment_errors` fits
    camera CENTERS only and is ill-conditioned on short/low-spread arcs
    (values of 100+ deg on runs whose raw orientations are within a few
    degrees of GT). This is the well-conditioned metric the round-4
    post-mortem used, now part of the standard eval output:

    * ``rot_drift_deg``      angle between the frame-0-anchored relative
      rotations at the LAST frame: angle(R0_est^T R_i_est, R0_gt^T R_i_gt).
      This is what "orientation drift" means — the reference's tracking
      loop holds it bounded over 2000 frames (volsdf_train.py:363-446).
    * ``rot_drift_max_deg``/``rot_drift_mean_deg``  curve statistics.
    * ``rot_step_deg_mean``  mean per-frame relative-rotation error
      angle(R_{i-1,est}^T R_{i,est}, R_{i-1,gt}^T R_{i,gt}) — the
      tracker's per-frame rotation jitter floor (TRACK_NOISE acc_r).
    """
    R_g = np.asarray(gt_c2w, dtype=np.float64)[:, :3, :3]
    R_e = np.asarray(est_c2w, dtype=np.float64)[:, :3, :3]
    rel_g = np.einsum("ij,nik->njk", R_g[0], R_g)   # R_g0^T R_gi
    rel_e = np.einsum("ij,nik->njk", R_e[0], R_e)
    drift = _rot_angle_deg(rel_e, rel_g)
    step_g = np.einsum("nij,nik->njk", R_g[:-1], R_g[1:])
    step_e = np.einsum("nij,nik->njk", R_e[:-1], R_e[1:])
    steps = _rot_angle_deg(step_e, step_g) if len(R_g) > 1 else np.zeros(1)
    out = {"rot_drift_deg": float(drift[-1]),
           "rot_drift_max_deg": float(drift.max()),
           "rot_drift_mean_deg": float(drift.mean()),
           "rot_step_deg_mean": float(steps.mean())}
    if return_curve:
        out["curve"] = drift
    return out


def write_tum_trajectory(path: str, c2w: np.ndarray,
                         timestamps=None) -> None:
    """TUM format: t tx ty tz qx qy qz qw (eval_cam.py export &
    gt_trajs/*.txt format)."""
    from ..utils.camera import rot_to_quat_np

    c2w = np.asarray(c2w)
    n = c2w.shape[0]
    ts = timestamps if timestamps is not None else np.arange(n)
    with open(path, "w") as f:
        for i in range(n):
            q = rot_to_quat_np(c2w[i, :3, :3])  # [w x y z]
            t = c2w[i, :3, 3]
            f.write(f"{ts[i]} {t[0]} {t[1]} {t[2]} "
                    f"{q[1]} {q[2]} {q[3]} {q[0]}\n")


def read_tum_trajectory(path: str, return_timestamps: bool = False):
    """Read TUM trajectory file (``t tx ty tz qx qy qz qw`` per line, the
    reference's ``gt_trajs/*.txt`` format) -> c2w [N,4,4]
    (or ``(c2w, timestamps)`` when ``return_timestamps``)."""
    import torch

    from ..utils.camera import quad2rotation

    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            rows.append(vals)
    arr = np.asarray(rows)
    t = arr[:, 1:4]
    q_xyzw = arr[:, 4:8]
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, :3]], axis=1)
    # the rotations in float32, as the JAX package computes them
    R = quad2rotation(torch.from_numpy(q_wxyz.astype(np.float32))).numpy()
    out = np.tile(np.eye(4, dtype=np.float32)[None], (arr.shape[0], 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    if return_timestamps:
        return out, arr[:, 0]
    return out
