"""Monocular depth/normal prior extraction (counterpart of
nicer_slam_tpu/preprocess/extract_monocular_cues.py, the reference's
Omnidata-DPT step).

The reference runs the Omnidata DPT (vitb_rn50_384) depth and normal models
at 384x384, resizes back to the frame resolution and stores lzma-compressed
.npy (depth [H,W] in ~[0,1], normal [3,H,W] in [0,1]).

Backends, in resolution order:
  * ``depth_ckpt``: a DPT checkpoint in the flat layout
    (``tools/convert_omnidata.py``), run by ``models/dpt.DPTInference``.
  * ``mono_prior``: the self-trained RGB-only prior (``mono_prior.npz`` at
    the repository root, ``models/mono_prior.py``); no GT depth is read.
  * ``from_gt_depth``: cues from the scan's own GT depth: depth prior =
    normalized GT depth, normal prior = camera-space normals from depth
    derivatives (``--prefer_gt`` chooses it over the mono prior).

The networks run on ``device`` (``cuda`` unless the caller asks for the
CPU); the GT-depth cues are numpy.
"""

from __future__ import annotations

import argparse
import lzma
import os
from glob import glob
from typing import Optional

import numpy as np

from .common import BackgroundWriter, read_rgb


def normals_from_depth(depth: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """Camera-space normals [H,W,3] from a z-depth map via central
    differences of the back-projected point cloud."""
    H, W = depth.shape
    ys, xs = np.mgrid[0:H, 0:W]
    # avoid zero depth holes
    d = np.where(depth > 0, depth, np.nan)
    X = (xs - W / 2.0) / fx * d
    Y = (ys - H / 2.0) / fy * d
    P = np.stack([X, Y, d], -1)
    dx = np.zeros_like(P)
    dy = np.zeros_like(P)
    dx[:, 1:-1] = (P[:, 2:] - P[:, :-2]) / 2
    dy[1:-1, :] = (P[2:, :] - P[:-2, :]) / 2
    n = np.cross(dx.reshape(-1, 3), dy.reshape(-1, 3)).reshape(H, W, 3)
    # orient towards the camera (-z view direction)
    flip = (n[..., 2:3] > 0)
    n = np.where(flip, -n, n)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(np.isfinite(norm) & (norm > 1e-9), n / (norm + 1e-12),
                 np.array([0.0, 0.0, -1.0]))
    return np.nan_to_num(n, nan=0.0)


def _save_lzma(path: str, arr: np.ndarray) -> None:
    with lzma.open(path, "wb") as f:
        np.save(f, arr.astype(np.float32))


def _default_mono_prior_path() -> str:
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "mono_prior.npz")


def extract_cues(img_path: str, output_path: str,
                 depth_ckpt: Optional[str] = None,
                 normal_ckpt: Optional[str] = None,
                 from_gt_depth: bool = True,
                 gt_depth_png_scale: float = 6553.5,
                 mono_prior_ckpt: Optional[str] = None,
                 prefer_gt: bool = False,
                 device="cuda") -> None:
    os.makedirs(output_path, exist_ok=True)
    rgbs = (sorted(glob(os.path.join(img_path, "*_rgb.png")))
            + sorted(glob(os.path.join(img_path, "*_rgb.jpg"))))

    if depth_ckpt and os.path.exists(depth_ckpt):
        from ..models.dpt import DPTInference

        depth_model = DPTInference(depth_ckpt, task="depth", device=device)
        normal_model = (DPTInference(normal_ckpt, task="normal", device=device)
                        if normal_ckpt and os.path.exists(normal_ckpt)
                        else None)
        with BackgroundWriter() as writer:
            for rp in rgbs:
                img = read_rgb(rp)
                stem = os.path.basename(rp).split("_")[0]
                writer.submit(_save_lzma, os.path.join(output_path, f"{stem}_depth.npy"),
                              depth_model(img))
                if normal_model is not None:
                    writer.submit(_save_lzma, os.path.join(output_path, f"{stem}_normal.npy"),
                                  normal_model(img))          # [3,H,W] in [0,1]
        return

    # RGB-only path: the self-trained mono prior — no GT depth read
    mp_path = mono_prior_ckpt or _default_mono_prior_path()
    if not prefer_gt and os.path.exists(mp_path):
        from ..models.mono_prior import MonoPriorInference

        model = MonoPriorInference(mp_path, device=device)
        with BackgroundWriter() as writer:
            for rp in rgbs:
                stem = os.path.basename(rp).split("_")[0]
                depth, normal01 = model(read_rgb(rp))
                writer.submit(_save_lzma, os.path.join(output_path, f"{stem}_depth.npy"), depth)
                writer.submit(_save_lzma, os.path.join(output_path, f"{stem}_normal.npy"),
                              normal01)
        return

    if not from_gt_depth:
        raise FileNotFoundError(
            "no DPT checkpoint or mono_prior.npz available and from_gt_depth "
            "disabled — convert Omnidata weights (tools/convert_omnidata.py) "
            "or train the RGB-only prior (tools/train_mono_prior.py)")

    # geometric fallback from GT depth (written beside the depth pngs, as
    # the JAX package writes them)
    import cv2

    cams = np.load(os.path.join(img_path, "cameras.npz"))
    from ..utils.camera import load_K_Rt_from_P

    intr, _ = load_K_Rt_from_P((cams["world_mat_0"] @ cams["scale_mat_0"])[:3, :4])
    fx, fy = intr[0, 0], intr[1, 1]
    with BackgroundWriter() as writer:
        for rp in rgbs:
            stem = os.path.basename(rp).split("_")[0]
            dp = os.path.join(img_path, f"{stem}_gt_depth.png")
            d = cv2.imread(dp, -1).astype(np.float32) / gt_depth_png_scale
            # mono prior depth: affine-normalized (the SSI loss is scale/shift
            # invariant; extract_monocular_cues.py stores ~[0,1] maps)
            dmax = np.percentile(d[d > 0], 99) if (d > 0).any() else 1.0
            mono = np.clip(d / max(dmax, 1e-6), 0, 1)
            writer.submit(_save_lzma, os.path.join(img_path, f"{stem}_depth.npy"), mono)
            n = normals_from_depth(d, fx, fy)          # [-1,1] camera frame
            n01 = ((n + 1.0) / 2.0).transpose(2, 0, 1)  # stored in [0,1], [3,H,W]
            writer.submit(_save_lzma, os.path.join(img_path, f"{stem}_normal.npy"), n01)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", choices=["depth", "normal", "both"],
                   default="both")
    p.add_argument("--img_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--depth_ckpt", default=None)
    p.add_argument("--normal_ckpt", default=None)
    p.add_argument("--mono_prior_ckpt", default=None)
    p.add_argument("--no_gt_fallback", action="store_true")
    p.add_argument("--prefer_gt", action="store_true",
                   help="use the GT-depth fallback even when the RGB-only "
                        "mono prior is available")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    extract_cues(a.img_path, a.output_path, a.depth_ckpt, a.normal_ckpt,
                 from_gt_depth=not a.no_gt_fallback,
                 mono_prior_ckpt=a.mono_prior_ckpt, prefer_gt=a.prefer_gt,
                 device=a.device)


if __name__ == "__main__":
    main()
