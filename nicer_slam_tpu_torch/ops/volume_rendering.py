"""SDF volume-rendering compositing (counterpart of
nicer_slam_tpu/ops/volume_rendering.py and the per-ray composites of
nicer_slam_tpu/models/scene_model.py:353-357, 489-494): kernel K4.

  free_energy_i = dist_i · density_i      (last dist = 1e10)
  alpha_i       = 1 − exp(−free_energy_i)
  T_i           = exp(−Σ_{j<i} free_energy_j)
  w_i           = alpha_i · T_i

``composite`` returns the weights and the three per-ray composites the
losses read: ``Σ w·rgb``, the normalised depth ``Σ w·z / (Σ w + 1e-8)`` and
``Σ w·normal`` (before the camera rotation). z carries no gradient (the
sampler detaches its rays).

On the card K4 is memory bound (it streams 8 floats per sample once) and
small next to the field networks; one warp per ray does the transmittance
scan and the per-ray sums with warp shuffles, without atomics
(csrc/composite.cu).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _cuda


def render_weights(z_vals: torch.Tensor, density: torch.Tensor) -> torch.Tensor:
    """[R,S] z values + [R,S] densities -> [R,S] compositing weights."""
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
    free_energy = dists * density
    shifted = torch.cat([torch.zeros_like(free_energy[:, :1]),
                         free_energy[:, :-1]], dim=-1)
    alpha = 1.0 - torch.exp(-free_energy)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    return alpha * transmittance


def composite_plain(z_vals, density, rgb, normals):
    """Plain version: (weights [R,S], rgb [R,3], depth [R,1], normal [R,3])."""
    weights = render_weights(z_vals, density)
    rgb_values = (weights[..., None] * rgb).sum(dim=1)
    wsum = weights.sum(dim=1, keepdim=True)
    depth = (weights * z_vals).sum(dim=1, keepdim=True) / (wsum + 1e-8)
    normal_map = (weights[..., None] * normals).sum(dim=1)
    return weights, rgb_values, depth, normal_map


class _CompositeCUDA(torch.autograd.Function):
    """One warp per ray (csrc/composite.cu)."""

    @staticmethod
    def forward(ctx, z_vals, density, rgb, normals):
        R, S = z_vals.shape
        dev = z_vals.device
        weights = torch.empty((R, S), dtype=torch.float32, device=dev)
        rgb_values = torch.empty((R, 3), dtype=torch.float32, device=dev)
        depth = torch.empty((R, 1), dtype=torch.float32, device=dev)
        normal_map = torch.empty((R, 3), dtype=torch.float32, device=dev)
        _cuda.launch("composite.fwd", "nsl_composite_fwd", R, z_vals.data_ptr(),
                     density.data_ptr(), rgb.data_ptr(), normals.data_ptr(),
                     weights.data_ptr(), rgb_values.data_ptr(), depth.data_ptr(),
                     normal_map.data_ptr(), R, S)
        ctx.save_for_backward(z_vals, density, rgb, normals)
        ctx.set_materialize_grads(False)
        return weights, rgb_values, depth, normal_map

    @staticmethod
    @once_differentiable
    def backward(ctx, g_weights, g_rgb, g_depth, g_normal):
        z_vals, density, rgb, normals = ctx.saved_tensors
        R, S = z_vals.shape
        dev = z_vals.device

        def grad_or_zeros(g, shape):
            return (torch.zeros(shape, dtype=torch.float32, device=dev)
                    if g is None else g.contiguous())

        g_rgb = grad_or_zeros(g_rgb, (R, 3))
        g_depth = grad_or_zeros(g_depth, (R, 1))
        g_normal = grad_or_zeros(g_normal, (R, 3))
        if g_weights is not None:
            g_weights = g_weights.contiguous()
        g_density = torch.empty((R, S), dtype=torch.float32, device=dev)
        g_rgb_s = torch.empty((R, S, 3), dtype=torch.float32, device=dev)
        g_normals_s = torch.empty((R, S, 3), dtype=torch.float32, device=dev)
        _cuda.launch("composite.bwd", "nsl_composite_bwd", R, z_vals.data_ptr(),
                     density.data_ptr(), rgb.data_ptr(), normals.data_ptr(),
                     _cuda.ptr(g_weights), g_rgb.data_ptr(), g_depth.data_ptr(),
                     g_normal.data_ptr(), g_density.data_ptr(), g_rgb_s.data_ptr(),
                     g_normals_s.data_ptr(), R, S)
        return None, g_density, g_rgb_s, g_normals_s


def composite(z_vals: torch.Tensor, density: torch.Tensor, rgb: torch.Tensor,
              normals: torch.Tensor):
    """K4: z_vals [R,S] (no gradient), density [R,S], rgb [R,S,3],
    normals [R,S,3] -> (weights [R,S], rgb_values [R,3], depth [R,1],
    normal_map [R,3]). Plain version on CPU, kernel on CUDA."""
    if z_vals.device.type == "cpu":
        return composite_plain(z_vals, density, rgb, normals)
    if z_vals.device.type != "cuda":
        raise ValueError(f"composite: unsupported device {z_vals.device}")
    R, S = z_vals.shape
    if S > 32 * 16:
        raise ValueError(f"composite kernel supports S <= 512, got {S}")
    _cuda.check(z_vals, "z_vals", torch.float32, (R, S))
    _cuda.check(density, "density", torch.float32, (R, S), device=z_vals.device)
    _cuda.check(rgb, "rgb", torch.float32, (R, S, 3), device=z_vals.device)
    _cuda.check(normals, "normals", torch.float32, (R, S, 3), device=z_vals.device)
    return _CompositeCUDA.apply(z_vals.detach(), density, rgb, normals)
