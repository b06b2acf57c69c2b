"""TSDF integration of one depth frame (counterpart of
nicer_slam_tpu/preprocess/tsdf_fusion.py ``make_integrate_fn``'s
``integrate``, :33-58): kernel K9.

Every voxel of a dense ``res³`` volume is projected into the frame and the
truncated signed distance to the observed depth is folded into its running
weighted mean (``tsdf``, ``weight``, float32 ``[res³]``, flat index
``(i·res + j)·res + k`` for the voxel at ``(xs[i], ys[j], zs[k])``), in
place. On a CPU tensor :func:`integrate` runs :func:`integrate_plain`; on a
CUDA tensor it launches ``csrc/tsdf.cu`` (one thread per voxel) and never
the plain version. Both form the camera-space point as per-component
float32 products summed in one fixed order (not as a matrix product) and
divide truly, so on the card they agree bit for bit; ``sdf_trunc`` and
``depth_max`` are rounded to float32 first, as the JAX package's float32
arithmetic rounds them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import _cuda

KERNEL = "tsdf.integrate"


def axis_coords(res: int, lo, hi, device) -> tuple:
    """The voxel centres along each axis, ``linspace(lo[d], hi[d], res)``
    (float64, rounded to float32)."""
    return tuple(torch.from_numpy(np.linspace(float(lo[d]), float(hi[d]), res)
                                  .astype(np.float32)).to(device) for d in range(3))


def integrate_plain(tsdf: torch.Tensor, weight: torch.Tensor, depth: torch.Tensor,
                    w2c: torch.Tensor, K: torch.Tensor, coords: Sequence[torch.Tensor],
                    sdf_trunc: float, depth_max: float) -> None:
    """The plain PyTorch version of K9, in place."""
    xs, ys, zs = coords
    H, W = depth.shape
    x, y, z = xs.view(-1, 1, 1), ys.view(1, -1, 1), zs.view(1, 1, -1)

    def cam(r):
        return ((w2c[r, 0] * x + w2c[r, 1] * y) + w2c[r, 2] * z) + w2c[r, 3]

    cx, cy, cz = cam(0), cam(1), cam(2)
    ui = torch.round((K[0, 0] * cx) / cz + K[0, 2])
    vi = torch.round((K[1, 1] * cy) / cz + K[1, 2])
    inb = (cz > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    zero = torch.zeros((), dtype=depth.dtype, device=depth.device)
    pix = torch.where(inb, vi, zero).long() * W + torch.where(inb, ui, zero).long()
    d = torch.where(inb, depth.reshape(-1)[pix], zero)
    trunc = torch.tensor(sdf_trunc, dtype=torch.float32, device=depth.device)
    sdf = d - cz
    valid = inb & (d > 0) & (d < depth_max) & (sdf > -trunc)
    obs = torch.clamp(sdf / trunc, -1.0, 1.0)
    w_obs = valid.to(torch.float32)
    t, w = tsdf.view(inb.shape), weight.view(inb.shape)
    nw = w + w_obs
    new = torch.where(nw > 0, (t * w + obs * w_obs) / torch.clamp(nw, min=1e-9), t)
    tsdf.copy_(new.reshape(-1))
    weight.copy_(nw.reshape(-1))


def integrate(tsdf: torch.Tensor, weight: torch.Tensor, depth: torch.Tensor,
              w2c: torch.Tensor, K: torch.Tensor, coords: Sequence[torch.Tensor],
              sdf_trunc: float, depth_max: float) -> None:
    """Fold one frame (depth [H, W] float32, w2c [4, 4], K [3, 3]) into
    ``tsdf``/``weight`` [res³] in place."""
    sdf_trunc, depth_max = float(np.float32(sdf_trunc)), float(np.float32(depth_max))
    if not _cuda.on_card(KERNEL, tsdf):
        integrate_plain(tsdf, weight, depth, w2c, K, coords, sdf_trunc, depth_max)
        return
    res = coords[0].numel()
    H, W = depth.shape
    dev = tsdf.device
    f32 = torch.float32
    _cuda.check(tsdf, "tsdf", f32, (res ** 3,))
    _cuda.check(weight, "weight", f32, (res ** 3,), dev)
    _cuda.check(depth, "depth", f32, (H, W), dev)
    _cuda.check(w2c, "w2c", f32, (4, 4), dev)
    _cuda.check(K, "K", f32, (3, 3), dev)
    for name, c in zip("xyz", coords):
        _cuda.check(c, f"{name}s", f32, (res,), dev)
    _cuda.launch(KERNEL, "nsl_tsdf_integrate", res ** 3, tsdf.data_ptr(), weight.data_ptr(),
                 depth.data_ptr(), w2c.data_ptr(), K.data_ptr(),
                 *(c.data_ptr() for c in coords), res, H, W, sdf_trunc, depth_max)
