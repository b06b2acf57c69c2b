"""Mesh reconstruction evaluation (counterpart of
nicer_slam_tpu/evaluation/eval_rec.py; reference: code/evaluation/eval_rec.py).

Pipeline: load reconstructed + GT meshes, apply the saved sim(3) alignment,
refine with point-to-point ICP (replacing the reference's manual
CloudCompare step, eval_rec.py:270-275), sample 200k points per mesh, and
report accuracy / completion (cm), completion ratio (%), normal
consistency, Chamfer-L1, and F-score @ thresholds
(eval_rec.py:25-92, 143-166, 207-235).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.ply import read_ply


def sample_mesh_points(verts: np.ndarray, faces: np.ndarray, n: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface sampling; returns (points [n,3],
    face normals per point [n,3])."""
    rng = rng or np.random.default_rng(0)
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    cross = np.cross((v1 - v0).astype(np.float64), (v2 - v0).astype(np.float64))
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    fn = cross / (np.linalg.norm(cross, axis=-1, keepdims=True) + 1e-30)
    p = area / max(area.sum(), 1e-30)
    p = p / p.sum()  # exact normalization for rng.choice
    fi = rng.choice(len(faces), size=n, p=p)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    pts = ((1 - r1) * v0[fi] + r1 * (1 - r2) * v1[fi] + r1 * r2 * v2[fi])
    return pts.astype(np.float32), fn[fi].astype(np.float32)


def icp_align(src: np.ndarray, dst: np.ndarray, iters: int = 30,
              max_corr: float = 0.1) -> np.ndarray:
    """Point-to-point ICP: returns 4x4 transform mapping src->dst
    (replacement for the reference's get_align_transformation,
    eval_rec.py:190-204)."""
    from scipy.spatial import cKDTree

    T = np.eye(4)
    cur = src.copy()
    tree = cKDTree(dst)
    for _ in range(iters):
        d, idx = tree.query(cur, k=1)
        m = d < max_corr
        if m.sum() < 10:
            break
        a = cur[m]
        b = dst[idx[m]]
        ca, cb = a.mean(0), b.mean(0)
        H = (a - ca).T @ (b - cb)
        U, S, Vt = np.linalg.svd(H)
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[2] *= -1
            R = Vt.T @ U.T
        t = cb - R @ ca
        Ti = np.eye(4)
        Ti[:3, :3] = R
        Ti[:3, 3] = t
        cur = cur @ R.T + t
        T = Ti @ T
    return T


def nn_distances(a: np.ndarray, b: np.ndarray):
    from scipy.spatial import cKDTree

    tree = cKDTree(b)
    d, idx = tree.query(a, k=1)
    return d, idx


def eval_pointcloud(pred_pts: np.ndarray, gt_pts: np.ndarray,
                    pred_normals: Optional[np.ndarray] = None,
                    gt_normals: Optional[np.ndarray] = None,
                    thresholds=(0.01, 0.015, 0.02)) -> Dict[str, float]:
    """Accuracy/completion (same units as input, reported also in cm for
    unit inputs), completion ratio @5cm, normal consistency, F-scores
    (eval_rec.py:25-92)."""
    d_acc, idx_acc = nn_distances(pred_pts, gt_pts)       # pred -> gt
    d_comp, idx_comp = nn_distances(gt_pts, pred_pts)     # gt -> pred

    out = {
        "accuracy": float(d_acc.mean()),
        "completion": float(d_comp.mean()),
        "chamfer_l1": float(0.5 * (d_acc.mean() + d_comp.mean())),
        "completion_ratio_5cm": float((d_comp < 0.05).mean()),
    }
    for th in thresholds:
        precision = (d_acc < th).mean()
        recall = (d_comp < th).mean()
        f = 2 * precision * recall / max(precision + recall, 1e-12)
        out[f"fscore@{th}"] = float(f)

    if pred_normals is not None and gt_normals is not None:
        na = pred_normals[np.arange(len(pred_pts))]
        nb = gt_normals[idx_acc]
        nc1 = np.abs((na * nb).sum(-1)).mean()
        na2 = gt_normals
        nb2 = pred_normals[idx_comp]
        nc2 = np.abs((na2 * nb2).sum(-1)).mean()
        out["normal_consistency"] = float(0.5 * (nc1 + nc2))
    return out


def calc_3d_metric(pred_ply: str, gt_ply: str,
                   align_sim3: Optional[np.ndarray] = None,
                   n_points: int = 200000, do_icp: bool = True
                   ) -> Dict[str, float]:
    """Full mesh-vs-mesh evaluation (eval_rec.py:207-235)."""
    pred = read_ply(pred_ply)
    gt = read_ply(gt_ply)
    verts = pred["verts"].astype(np.float64)
    if align_sim3 is not None:
        verts = verts @ align_sim3[:3, :3].T + align_sim3[:3, 3]

    rng = np.random.default_rng(0)
    p_pts, p_nrm = sample_mesh_points(verts.astype(np.float32),
                                      pred["faces"], n_points, rng)
    g_pts, g_nrm = sample_mesh_points(gt["verts"], gt["faces"], n_points, rng)

    if do_icp:
        T = icp_align(p_pts[::10], g_pts[::10])
        p_pts = p_pts @ T[:3, :3].T + T[:3, 3]
        p_nrm = p_nrm @ T[:3, :3].T
    return eval_pointcloud(p_pts, g_pts, p_nrm, g_nrm)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred", type=str, required=True, help="predicted .ply")
    p.add_argument("--gt", type=str, required=True, help="ground-truth .ply")
    p.add_argument("--sim3", type=str, default=None,
                   help="alignment_transformation_sim3.npy from eval_cam")
    p.add_argument("--n_points", type=int, default=200000)
    p.add_argument("--no_icp", action="store_true")
    a = p.parse_args(argv)
    sim3 = np.load(a.sim3) if a.sim3 else None
    m = calc_3d_metric(a.pred, a.gt, sim3, a.n_points, do_icp=not a.no_icp)
    print(json.dumps(m, indent=2))


if __name__ == "__main__":
    main()
