"""Optical-flow extraction between keyframe pairs (counterpart of
nicer_slam_tpu/preprocess/extract_flows.py, the reference's GMFlow step).

Reference: preprocess/extract_flows.py — GMFlow bidirectional flow on
keyframe pairs (interval 10, radius 3 keyframes, thresh 30), forward/backward
consistency check -> occlusion PNGs (0 = usable), lzma .npy flows.

Backends, in resolution order:
  * ``ckpt``: a GMFlow checkpoint in the flat layout
    (``tools/convert_gmflow.py``), run by ``models/gmflow.GMFlowInference``
    on ``device``.
  * classical RGB-only: pyramidal Horn-Schunck with warping, from the images
    alone (no depth, no poses), on ``device`` in float64 with the JAX
    package's numpy arithmetic op for op; used whenever no checkpoint is
    given and the scan has no gt_depth pngs (or ``rgb_only``).
  * geometric: exact flow from GT depth + poses with forward/backward
    depth-consistency occlusion (numpy, one pass per pair).
"""

from __future__ import annotations

import argparse
import lzma
import os
from glob import glob
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .common import BackgroundWriter, read_rgb


def flow_from_depth(depth_i: np.ndarray, c2w_i: np.ndarray,
                    c2w_j: np.ndarray, K: np.ndarray):
    """Exact flow i->j from z-depth; returns (flow [H,W,2], z in j [H,W],
    target pixel coords [H,W,2])."""
    H, W = depth_i.shape
    ys, xs = np.mgrid[0:H, 0:W]
    X = (xs - K[0, 2]) / K[0, 0] * depth_i
    Y = (ys - K[1, 2]) / K[1, 1] * depth_i
    pts = np.stack([X, Y, depth_i], -1).reshape(-1, 3)
    w2c_j = np.linalg.inv(c2w_j)
    rel = w2c_j @ c2w_i
    pj = pts @ rel[:3, :3].T + rel[:3, 3]
    z = pj[:, 2]
    u = K[0, 0] * pj[:, 0] / np.maximum(z, 1e-9) + K[0, 2]
    v = K[1, 1] * pj[:, 1] / np.maximum(z, 1e-9) + K[1, 2]
    flow = np.stack([u - xs.reshape(-1), v - ys.reshape(-1)], -1)
    tgt = np.stack([u, v], -1)
    return (flow.reshape(H, W, 2).astype(np.float32),
            z.reshape(H, W), tgt.reshape(H, W, 2))


def occlusion_from_depth(depth_i, depth_j, c2w_i, c2w_j, K,
                         rel_tol: float = 0.05):
    """Occlusion/validity via projected-depth consistency: pixel usable iff
    the point lands in-bounds in j, in front of the camera, and j's depth at
    the landing pixel agrees within rel_tol."""
    H, W = depth_i.shape
    flow, z_in_j, tgt = flow_from_depth(depth_i, c2w_i, c2w_j, K)
    ui = np.clip(np.round(tgt[..., 0]).astype(np.int64), 0, W - 1)
    vi = np.clip(np.round(tgt[..., 1]).astype(np.int64), 0, H - 1)
    inb = ((tgt[..., 0] >= 0) & (tgt[..., 0] < W)
           & (tgt[..., 1] >= 0) & (tgt[..., 1] < H) & (z_in_j > 0)
           & (depth_i > 0))
    dj = depth_j[vi, ui]
    consistent = np.abs(dj - z_in_j) < rel_tol * np.maximum(z_in_j, 1e-6)
    usable = inb & consistent & (dj > 0)
    return flow, usable


# ---------------------------------------------------------------------------
# classical RGB-only flow: every operation is the numpy version's, in the same
# order, in float64. A divisor that is not a power of two is a device tensor:
# on the card torch turns a tensor divided by a Python number into a product
# with its reciprocal, which rounds differently.
# ---------------------------------------------------------------------------

def _bilinear_warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample img [H,W] at (x+u, y+v), edge-clamped."""
    H, W = img.shape
    xs = torch.arange(W, dtype=img.dtype, device=img.device)[None, :]
    ys = torch.arange(H, dtype=img.dtype, device=img.device)[:, None]
    x = torch.clamp(xs + u, 0, W - 1.001)
    y = torch.clamp(ys + v, 0, H - 1.001)
    x0, y0 = x.long(), y.long()
    fx, fy = x - x0, y - y0
    return ((1 - fx) * (1 - fy) * img[y0, x0]
            + fx * (1 - fy) * img[y0, x0 + 1]
            + (1 - fx) * fy * img[y0 + 1, x0]
            + fx * fy * img[y0 + 1, x0 + 1])


def _box3(a: torch.Tensor, nine: torch.Tensor) -> torch.Tensor:
    """3x3 box filter, edge-replicated (row by row, left to right)."""
    H, W = a.shape
    p = F.pad(a[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    acc = p[0:H, 0:W]
    for i, j in ((0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
        acc = acc + p[i:i + H, j:j + W]
    return acc / nine


def _downsample2(a: torch.Tensor) -> torch.Tensor:
    H2, W2 = a.shape[0] // 2 * 2, a.shape[1] // 2 * 2
    a = a[:H2, :W2]
    return 0.25 * (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2])


def _gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``np.gradient(a, axis=dim)``: central differences over 2 inside,
    one-sided differences at the two edges."""
    n = a.shape[dim]
    first = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    inner = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) / 2.0
    last = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim)


def _upsample_nearest(u: torch.Tensor, H: int, W: int):
    """The pyramid's nearest-neighbour upsample of a flow component to
    [H, W]; returns it and (sx, sy), the factors its values scale by."""
    sy, sx = H / u.shape[0], W / u.shape[1]
    # the indices in numpy's arithmetic, on the host (a true division)
    yi = np.minimum((np.arange(H) / sy).astype(int), u.shape[0] - 1)
    xi = np.minimum((np.arange(W) / sx).astype(int), u.shape[1] - 1)
    yi, xi = (torch.from_numpy(t).to(u.device) for t in (yi, xi))
    return u[yi][:, xi], sx, sy


def classical_flow(img0: np.ndarray, img1: np.ndarray, n_levels: int = 5,
                   n_iters: int = 80, alpha: float = 12.0, device="cuda") -> np.ndarray:
    """Pyramidal Horn-Schunck optical flow with warping (RGB-only; no
    learned weights, no depth). img0/img1 [H,W,3] in [0,1] -> flow [H,W,2]
    in pixels (0 -> 1), computed on ``device`` in float64."""
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    # classic HS alphas assume 0-255 intensity units (the grey level is the
    # numpy float32 mean, as the JAX package forms it)
    g0 = torch.from_numpy(img0.mean(-1).astype(np.float64)).to(dev) * 255.0
    g1 = torch.from_numpy(img1.mean(-1).astype(np.float64)).to(dev) * 255.0
    nine = torch.tensor(9.0, **f64)
    pyr0, pyr1 = [g0], [g1]
    for _ in range(n_levels - 1):
        if min(pyr0[-1].shape) < 16:
            break
        pyr0.append(_downsample2(pyr0[-1]))
        pyr1.append(_downsample2(pyr1[-1]))

    u = torch.zeros_like(pyr0[-1])
    v = torch.zeros_like(pyr0[-1])
    a2 = alpha * alpha
    for lvl in range(len(pyr0) - 1, -1, -1):
        a0, b0 = pyr0[lvl], pyr1[lvl]
        if u.shape != a0.shape:
            u, sx, sy = _upsample_nearest(u, *a0.shape)
            v, _, _ = _upsample_nearest(v, *a0.shape)
            u, v = u * sx, v * sy
        # warp img1 toward img0 by the current flow, solve for the increment
        for _ in range(3):  # warping iterations per level
            w1 = _bilinear_warp(b0, u, v)
            Ix = 0.5 * (_gradient(a0, 1) + _gradient(w1, 1))
            Iy = 0.5 * (_gradient(a0, 0) + _gradient(w1, 0))
            It = w1 - a0
            du = torch.zeros_like(u)
            dv = torch.zeros_like(v)
            denom = a2 + Ix * Ix + Iy * Iy
            for _ in range(n_iters // 3):
                du_avg = _box3(du, nine)
                dv_avg = _box3(dv, nine)
                t = (Ix * du_avg + Iy * dv_avg + It) / denom
                du = du_avg - Ix * t
                dv = dv_avg - Iy * t
            u = u + du
            v = v + dv
    return torch.stack([u, v], -1).float().cpu().numpy()


def _pairs(frame_ids, thresh: int = 30):
    out = []
    for i in frame_ids:
        for j in frame_ids:
            if 0 < abs(i - j) <= thresh:
                out.append((i, j))
    return out


def extract_flows(img_path: str, output_path: str, ckpt: Optional[str] = None,
                  keyframe_every: int = 10, thresh: int = 30,
                  gt_depth_png_scale: float = 6553.5,
                  fwd_bwd_tol: float = 1.0,
                  rgb_only: bool = False, device="cuda") -> None:
    os.makedirs(output_path, exist_ok=True)
    import cv2

    rgbs = (sorted(glob(os.path.join(img_path, "*_rgb.png")))
            + sorted(glob(os.path.join(img_path, "*_rgb.jpg"))))
    n = len(rgbs)
    kf_ids = list(range(0, n, keyframe_every))
    pairs = _pairs(kf_ids, thresh)

    use_model = ckpt and os.path.exists(ckpt)
    have_depth = bool(glob(os.path.join(img_path, "*_gt_depth.png")))
    if use_model or rgb_only or not have_depth:
        if use_model:
            from ..models.gmflow import GMFlowInference

            model = GMFlowInference(ckpt, device=device)
        else:
            # classical RGB-only fallback (no weights, no depth, no poses)
            def model(a, b):
                return classical_flow(a, b, device=device)
        cache = {}

        def get_img(i):
            if i not in cache:
                cache[i] = read_rgb(rgbs[i])
            return cache[i]

        flows = {}
        for i, j in pairs:
            flows[(i, j)] = model(get_img(i), get_img(j))
        with BackgroundWriter() as writer:
            for i, j in pairs:
                fwd = flows[(i, j)]
                bwd = flows[(j, i)]
                H, W = fwd.shape[:2]
                ys, xs = np.mgrid[0:H, 0:W]
                u = np.clip(np.round(xs + fwd[..., 0]).astype(np.int64), 0, W - 1)
                v = np.clip(np.round(ys + fwd[..., 1]).astype(np.int64), 0, H - 1)
                cycle = fwd + bwd[v, u]
                usable = np.linalg.norm(cycle, axis=-1) < fwd_bwd_tol
                writer.submit(_write_pair, output_path, i, j, fwd, usable)
        return

    # geometric fallback from GT depth + cameras.npz poses
    cams = np.load(os.path.join(img_path, "cameras.npz"))
    from ..utils.camera import load_K_Rt_from_P

    def load_frame(i):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
        intr, pose = load_K_Rt_from_P(P)
        d = cv2.imread(os.path.join(img_path, f"{i:06d}_gt_depth.png"), -1)
        scale = float(cams["scale_mat_0"][0, 0])
        d = d.astype(np.float32) / gt_depth_png_scale / scale  # cube units
        return intr[:3, :3], pose, d

    cache = {}
    with BackgroundWriter() as writer:
        for i, j in pairs:
            for k in (i, j):
                if k not in cache:
                    cache[k] = load_frame(k)
            K, pose_i, d_i = cache[i]
            _, pose_j, d_j = cache[j]
            flow, usable = occlusion_from_depth(d_i, d_j, pose_i, pose_j, K)
            writer.submit(_write_pair, output_path, i, j, flow, usable)


def _write_pair(output_path: str, i: int, j: int, flow: np.ndarray,
                usable: np.ndarray) -> None:
    import cv2

    with lzma.open(os.path.join(output_path, f"{i:04d}_{j:04d}_flow.npy"),
                   "wb") as f:
        np.save(f, flow.astype(np.float32))
    occ = np.where(usable, 0, 255).astype(np.uint8)
    cv2.imwrite(os.path.join(output_path, f"{i:04d}_{j:04d}_occ.png"),
                np.stack([occ] * 3, -1))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--inference_dir", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--keyframe_every", type=int, default=10)
    p.add_argument("--thresh", type=int, default=30)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    extract_flows(a.inference_dir, a.output_path, a.ckpt,
                  a.keyframe_every, a.thresh, device=a.device)


if __name__ == "__main__":
    main()
