"""Trajectory/mesh visualization (counterpart of nicer_slam_tpu/utils/viz.py;
reference: code/utils/viz.py + visualizer.py).

Open3D is not available in this environment, so the interactive viewer is
replaced by a headless renderer with the same inputs and outputs: it
consumes PoseParameters checkpoints, the eval_cam sim(3), and the per-frame
``vis/surface_%04d.ply`` meshes, and produces per-frame composited views
(estimated vs GT trajectory + current mesh) and an optional mp4.

The SLAMFrontend queue API of the reference (viz.py:235-286) is kept as a
thin class so downstream code structured around it still works.
matplotlib (the frames) and imageio (the mp4) are optional host packages.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def _project_points(pts: np.ndarray, elev: float = 25.0, azim: float = -60.0):
    """Simple orthographic projection for headless 3D plotting."""
    e, a = np.radians(elev), np.radians(azim)
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, np.cos(e), -np.sin(e)],
                   [0, np.sin(e), np.cos(e)]])
    p = pts @ (Rx @ Rz).T
    return p[:, 0], p[:, 1], p[:, 2]


def render_frame_png(out_path: str, est_traj: np.ndarray,
                     gt_traj: Optional[np.ndarray] = None,
                     mesh: Optional[Dict[str, np.ndarray]] = None,
                     title: str = "", max_mesh_pts: int = 30000) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    if mesh is not None and mesh["verts"].shape[0] > 0:
        v = mesh["verts"]
        sel = np.random.default_rng(0).choice(
            v.shape[0], size=min(max_mesh_pts, v.shape[0]), replace=False)
        x, y, z = _project_points(v[sel])
        c = (mesh["colors"][sel] / 255.0 if "colors" in mesh
             else np.full((len(sel), 3), 0.6))
        order = np.argsort(z)
        ax.scatter(x[order], y[order], s=0.5, c=c[order], linewidths=0)
    if gt_traj is not None and len(gt_traj):
        x, y, _ = _project_points(np.asarray(gt_traj)[:, :3, 3])
        ax.plot(x, y, "k-", lw=1.2, label="ground truth")
    if len(est_traj):
        x, y, _ = _project_points(np.asarray(est_traj)[:, :3, 3])
        ax.plot(x, y, "r-", lw=1.2, label="estimated")
        ax.plot(x[-1:], y[-1:], "r^", ms=8)
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    ax.set_title(title)
    ax.axis("off")
    fig.savefig(out_path, dpi=90, bbox_inches="tight")
    plt.close(fig)


class SLAMFrontend:
    """Headless drop-in for viz.py's subprocess viewer: feed it poses and
    mesh paths; it renders png frames into ``save_dir``."""

    def __init__(self, save_dir: str, estimate_c2w_list=None,
                 gt_c2w_list=None, **_unused):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.est: List[np.ndarray] = list(estimate_c2w_list or [])
        self.gt: List[np.ndarray] = list(gt_c2w_list or [])
        self.mesh = None
        self.frame_no = 0

    def update_pose(self, index: int, pose: np.ndarray, gt: bool = False):
        target = self.gt if gt else self.est
        while len(target) <= index:
            target.append(np.eye(4))
        target[index] = np.asarray(pose)

    def update_mesh(self, path: str):
        from .ply import read_ply

        self.mesh = read_ply(path)

    def render(self, title: str = ""):
        out = os.path.join(self.save_dir, f"viz_{self.frame_no:05d}.png")
        render_frame_png(out, np.asarray(self.est),
                         np.asarray(self.gt) if self.gt else None,
                         self.mesh, title=title)
        self.frame_no += 1
        return out

    def make_video(self, out_path: str, fps: int = 15) -> Optional[str]:
        try:
            import imageio.v2 as imageio
            from glob import glob

            frames = sorted(glob(os.path.join(self.save_dir, "viz_*.png")))
            if not frames:
                return None
            with imageio.get_writer(out_path, fps=fps) as w:
                for f in frames:
                    w.append_data(imageio.imread(f))
            return out_path
        except Exception:
            return None
