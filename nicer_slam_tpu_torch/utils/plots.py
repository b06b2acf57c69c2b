"""Visual observability: rendered-vs-GT panels and mesh dumps (counterpart
of nicer_slam_tpu/utils/plots.py).

Per call of ``vis_hook`` it writes, under the run's ``vis/``:
  rendering_<frame>_<idx>_<iter>.png   rendered RGB | GT RGB
  normal_<frame>_<idx>_<iter>.png      rendered normals | GT normals
  depth_<frame>_<idx>_<iter>.png       rendered depth | GT (mono) depth
  merge_<frame>_<idx>_<iter>.png       the three stacked
  surface_<frame:04d>.ply              colored mesh of the SDF's zero level

PNGs go through OpenCV. The mesh's SDF grid is evaluated on the model's
device (``combine_sdf``); the isosurface extraction and the PLY writer are
this package's numpy copies of the JAX package's ``ops.marching_cubes`` and
``utils.ply``. Vertex colours come from the color network with the
view direction set to -normal, as the reference colours its meshes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models import fields
from ..ops.marching_cubes import extract_mesh
from .ply import write_ply


def colorize_depth(depth: np.ndarray, lo=None, hi=None) -> np.ndarray:
    lo = np.percentile(depth, 2) if lo is None else lo
    hi = np.percentile(depth, 98) if hi is None else hi
    d = np.clip((depth - lo) / max(hi - lo, 1e-8), 0, 1)
    try:
        import matplotlib
    except ImportError:
        return np.stack([d, d, d], -1)
    return matplotlib.colormaps["viridis"](d)[..., :3]


def _write_png(path: str, rgb: np.ndarray) -> None:
    import cv2

    u8 = np.clip(np.asarray(rgb) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if not cv2.imwrite(path, u8[..., ::-1]):
        raise IOError(f"cannot write {path}")


def save_panels(plots_dir: str, frame_idx: int, inner_iter: int,
                rendered: Dict[str, np.ndarray],
                gt: Dict[str, np.ndarray], img_idx: int = 0) -> None:
    tag = f"{frame_idx}_{img_idx}_{inner_iter}"
    rgb_panel = np.concatenate([rendered["rgb"], gt["rgb"]], axis=1)
    nrm_panel = np.concatenate([(rendered["normal"] + 1) / 2,
                                (gt["normal"] + 1) / 2], axis=1)
    dep_panel = np.concatenate(
        [colorize_depth(rendered["depth"]), colorize_depth(gt["depth"])], axis=1)
    for name, panel in (("rendering", rgb_panel), ("normal", nrm_panel),
                        ("depth", dep_panel)):
        _write_png(os.path.join(plots_dir, f"{name}_{tag}.png"), panel)
    _write_png(os.path.join(plots_dir, f"merge_{tag}.png"),
               np.concatenate([rgb_panel, nrm_panel, dep_panel], axis=0))


def mesh_sdf_fn(model, device):
    """numpy [N,3] -> numpy [N] SDF of the fine stage, on ``device``."""
    @torch.no_grad()
    def sdf(x: np.ndarray) -> np.ndarray:
        pts = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
        return fields.combine_sdf(model.implicit, pts, "fine")[:, 0].cpu().numpy()
    return sdf


def vertex_colors(model, verts: np.ndarray, normals: np.ndarray, device,
                  chunk: int = 65536) -> np.ndarray:
    """Color-network colours [V,3] at the vertices, view direction -normal.
    Per-image and exposure codes are frame 0's (the JAX package's vis hook
    passes frame 0 with per_image_code; with model_exposure it has no
    colour here, the port takes frame 0's exposure-corrected one)."""
    cfg = model.render.cfg
    colors = np.zeros((verts.shape[0], 3), np.float32)
    for s in range(0, verts.shape[0], chunk):
        e = min(s + chunk, verts.shape[0])
        pts = torch.from_numpy(verts[s:e]).to(device)
        dirs = torch.from_numpy(-normals[s:e]).to(device)
        idx = (torch.zeros((e - s,), dtype=torch.int64, device=device)
               if cfg.per_image_code or cfg.model_exposure else None)
        with torch.no_grad():
            _, feat, grad = fields.combine_get_outputs(model.implicit, pts, "fine")
            rgb = fields.rendering_forward(model.render, pts, grad, dirs, feat, "highfreq",
                                           image_indices=idx)
            colors[s:e] = (rgb[0] if cfg.model_exposure else rgb).cpu().numpy()
    return colors


def save_mesh(runner, frame_idx: int, resolution: Optional[int] = None,
              suffix: str = "") -> Optional[str]:
    """Extract and write the colored SDF mesh at ``resolution`` (default
    the conf's plot.resolution) to ``vis/surface_<frame><suffix>.ply``;
    returns its path, or None when the SDF has no zero crossing on the grid."""
    c = runner.conf
    resolution = resolution or c.get_int("plot.resolution", 512)
    gb = c.get_list("plot.grid_boundary", [-1.0, 1.0])
    mesh = extract_mesh(mesh_sdf_fn(runner.model, runner.device),
                        resolution=resolution, grid_boundary=tuple(gb))
    if mesh is None:
        runner.log("unable to get a surface, NO MESH!")
        return None
    verts, faces, normals = mesh
    colors = vertex_colors(runner.model, verts, normals, runner.device)
    path = os.path.join(runner.plots_dir, f"surface_{frame_idx:04d}{suffix}.ply")
    write_ply(path, verts, faces, normals=normals, colors=colors)
    return path


def vis_hook(runner, frame_idx: int, inner_iter: int = 0) -> None:
    """The vis callback of ``SLAMRunner.run``: render the frame in full,
    write the panels beside its ground truth, write the mesh."""
    out = runner.render_full_image(frame_idx)
    data = runner.dataset.frame(frame_idx)
    H, W = runner.H, runner.W
    gt = {"rgb": data["rgb"].reshape(H, W, 3),
          "normal": data["normal"].reshape(H, W, 3),
          "depth": data["depth"].reshape(H, W)}
    runner.dataset.clean(frame_idx)
    save_panels(runner.plots_dir, frame_idx, inner_iter, out, gt)
    save_mesh(runner, frame_idx)
