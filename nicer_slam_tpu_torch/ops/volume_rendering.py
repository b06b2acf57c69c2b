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

With colour top-k (training, ``0 < color_topk < S``;
scene_model.py:323-353) the composite splits in two: ``weights_topk``
returns the weights, the depth and normal composites, and the ``Kc``
largest weights of each ray (``topk_w``: largest first, ties to the lower
index, the values and order of ``lax.top_k``), the ray's weight sum
``wsum`` and the flat picks ``ray·S + index``; the colour network runs
only at the picked samples, and ``topk_rgb`` composites their colours with
the kept weights renormalised to ``wsum``. The weights pass's backward
takes the cotangents on ``topk_w`` and ``wsum`` itself
(``weights_topk_bwd_plain`` is its closed form).

On the card K4 is memory bound (it streams 8 floats per sample once) and
small next to the field networks: one warp per ray does the transmittance
scan, the per-ray sums and the top-k picks (a radix select by warp
ballots) with warp shuffles, without atomics; the top-k colour composite
gives each ray Kc lanes (csrc/composite.cu). Any S and 0 < Kc <= S run:
rays longer than the register rounds (512 samples for the composite's
forward, 1024 for the rest) run in tiles with the transmittance carried
across them.
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


def weights_topk_plain(z_vals, density, normals, Kc: int):
    """Plain version of the weights pass: (weights [R,S], depth [R,1],
    normal [R,3], topk_w [R,Kc], wsum [R,1], picks [R,Kc] int64 flat
    indices ray·S + i). A stable descending sort keeps ties in index order,
    as lax.top_k does. The kernel orders the weights by their bit patterns,
    which order as the floats do because every weight (1 - exp(-e))·T has
    e >= 0 and is neither negative nor -0.0."""
    R, S = z_vals.shape
    weights = render_weights(z_vals, density)
    wsum = weights.sum(dim=1, keepdim=True)
    depth = (weights * z_vals).sum(dim=1, keepdim=True) / (wsum + 1e-8)
    normal_map = (weights[..., None] * normals).sum(dim=1)
    idx = torch.sort(weights.detach(), dim=1, descending=True, stable=True)[1][:, :Kc]
    topk_w = torch.gather(weights, 1, idx)
    picks = torch.arange(R, device=idx.device)[:, None] * S + idx
    return weights, depth, normal_map, topk_w, wsum, picks


def weights_topk_bwd_plain(z_vals, density, normals, picks, g_weights, g_depth,
                           g_normal, g_topk_w, g_wsum):
    """Closed form of the weights pass's backward, the formula
    composite_bwd_kernel computes: (g_density [R,S], g_normals [R,S,3]).
    Any cotangent may be None (zero). With g_w the total cotangent on each
    weight,

      g_w_i = g_weights_i + g_wsum + Σ_k [picks_k = i]·g_topk_w_k
              + g_normal·n_i + g_depth·(z_i − depth)/(Σw + 1e-8),
      dL/dσ_i = dist_i·(g_w_i·T_i·exp(−e_i) − Σ_{j>i} g_w_j·w_j),

    the tail summed from the ray's end (no subtraction: the last sample's
    distance is 1e10)."""
    R, S = z_vals.shape
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
    free_energy = dists * density
    shifted = torch.cat([torch.zeros_like(free_energy[:, :1]),
                         free_energy[:, :-1]], dim=-1)
    ex = torch.exp(-free_energy)
    trans = torch.exp(-torch.cumsum(shifted, dim=-1))
    w = (1.0 - ex) * trans
    inv = 1.0 / (w.sum(dim=1, keepdim=True) + 1e-8)
    depth = (w * z_vals).sum(dim=1, keepdim=True) * inv

    def zeros(shape):
        return torch.zeros(shape, dtype=w.dtype, device=w.device)

    g_depth = zeros((R, 1)) if g_depth is None else g_depth
    g_normal = zeros((R, 3)) if g_normal is None else g_normal
    gw = g_depth * (z_vals - depth) * inv + (normals * g_normal[:, None, :]).sum(-1)
    if g_weights is not None:
        gw = gw + g_weights
    if g_wsum is not None:
        gw = gw + g_wsum
    if g_topk_w is not None:
        gw = (gw.reshape(-1).index_add(0, picks.reshape(-1), g_topk_w.reshape(-1))
              .reshape(R, S))
    lt = gw * w
    tail = torch.cat([torch.flip(torch.cumsum(torch.flip(lt[:, 1:], [1]), 1), [1]),
                      torch.zeros_like(lt[:, :1])], dim=1)
    g_density = (gw * trans * ex - tail) * dists
    return g_density, g_normal[:, None, :] * w[..., None]


def topk_rgb_plain(topk_w, wsum, rgb):
    """Plain version of the top-k colour composite: topk_w [R,Kc], the
    ray's whole weight wsum [R,1], rgb [R,Kc,3] -> [R,3]."""
    renorm = wsum / (topk_w.sum(1, keepdim=True) + 1e-8)
    return ((topk_w * renorm)[..., None] * rgb).sum(dim=1)


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
        g_density, g_rgb_s, g_normals_s = _composite_bwd(
            "composite.bwd", z_vals, density, rgb, normals, g_weights,
            g_rgb, g_depth, g_normal)
        return None, g_density, g_rgb_s, g_normals_s


def _composite_bwd(kernel, z_vals, density, rgb, normals, g_weights,
                   g_rgb, g_depth, g_normal, picks=None, g_topk_w=None,
                   g_wsum=None):
    """composite_bwd_kernel; without ``rgb`` (the weights pass) it takes no
    colour cotangent and returns no colour gradient, and takes the
    cotangents on the top-k values (at ``picks``) and on the weight sum."""
    R, S = z_vals.shape
    dev = z_vals.device

    def grad_or_zeros(g, shape):
        return (torch.zeros(shape, dtype=torch.float32, device=dev)
                if g is None else g.contiguous())

    def contiguous(g):
        return None if g is None else g.contiguous()

    g_depth = grad_or_zeros(g_depth, (R, 1))
    g_normal = grad_or_zeros(g_normal, (R, 3))
    if rgb is not None:
        g_rgb = grad_or_zeros(g_rgb, (R, 3))
    g_weights, g_topk_w, g_wsum = map(contiguous, (g_weights, g_topk_w, g_wsum))
    Kc = 0 if picks is None else picks.shape[1]
    g_density = torch.empty((R, S), dtype=torch.float32, device=dev)
    g_rgb_s = (torch.empty((R, S, 3), dtype=torch.float32, device=dev)
               if rgb is not None else None)
    g_normals_s = torch.empty((R, S, 3), dtype=torch.float32, device=dev)
    _cuda.launch(kernel, "nsl_composite_bwd", R, z_vals.data_ptr(),
                 density.data_ptr(), _cuda.ptr(rgb), normals.data_ptr(),
                 _cuda.ptr(picks), _cuda.ptr(g_weights), _cuda.ptr(g_rgb),
                 g_depth.data_ptr(), g_normal.data_ptr(), _cuda.ptr(g_topk_w),
                 _cuda.ptr(g_wsum), g_density.data_ptr(), _cuda.ptr(g_rgb_s),
                 g_normals_s.data_ptr(), R, S, Kc)
    return g_density, g_rgb_s, g_normals_s


class _WeightsTopkCUDA(torch.autograd.Function):
    """The weights pass with the top-k picks, one warp per ray."""

    @staticmethod
    def forward(ctx, z_vals, density, normals, Kc):
        R, S = z_vals.shape
        dev = z_vals.device
        weights = torch.empty((R, S), dtype=torch.float32, device=dev)
        depth = torch.empty((R, 1), dtype=torch.float32, device=dev)
        normal_map = torch.empty((R, 3), dtype=torch.float32, device=dev)
        topk_w = torch.empty((R, Kc), dtype=torch.float32, device=dev)
        wsum = torch.empty((R, 1), dtype=torch.float32, device=dev)
        picks = torch.empty((R, Kc), dtype=torch.int64, device=dev)
        _cuda.launch("weights_topk.fwd", "nsl_weights_topk_fwd", R, z_vals.data_ptr(),
                     density.data_ptr(), normals.data_ptr(), weights.data_ptr(),
                     depth.data_ptr(), normal_map.data_ptr(), topk_w.data_ptr(),
                     wsum.data_ptr(), picks.data_ptr(), R, S, Kc)
        ctx.save_for_backward(z_vals, density, normals, picks)
        ctx.mark_non_differentiable(picks)
        ctx.set_materialize_grads(False)
        return weights, depth, normal_map, topk_w, wsum, picks

    @staticmethod
    @once_differentiable
    def backward(ctx, g_weights, g_depth, g_normal, g_topk_w, g_wsum, _g_picks):
        z_vals, density, normals, picks = ctx.saved_tensors
        g_density, _, g_normals = _composite_bwd(
            "weights_topk.bwd", z_vals, density, None, normals, g_weights,
            None, g_depth, g_normal, picks, g_topk_w, g_wsum)
        return None, g_density, g_normals, None


class _TopkRGBCUDA(torch.autograd.Function):
    """The top-k colour composite, Kc lanes per ray."""

    @staticmethod
    def forward(ctx, topk_w, wsum, rgb):
        R, Kc = topk_w.shape
        out = torch.empty((R, 3), dtype=torch.float32, device=topk_w.device)
        _cuda.launch("topk_rgb.fwd", "nsl_topk_rgb_fwd", R, topk_w.data_ptr(),
                     wsum.data_ptr(), rgb.data_ptr(), out.data_ptr(), R, Kc)
        ctx.save_for_backward(topk_w, wsum, rgb)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        return _topk_rgb_bwd(*ctx.saved_tensors, g_out)


def _topk_rgb_bwd(topk_w, wsum, rgb, g_out):
    """topk_rgb_bwd_kernel: (g_topk_w, g_wsum, g_rgb)."""
    R, Kc = topk_w.shape
    dev = topk_w.device
    g_out = g_out.contiguous()
    g_w = torch.empty((R, Kc), dtype=torch.float32, device=dev)
    g_wsum = torch.empty((R, 1), dtype=torch.float32, device=dev)
    g_rgb = torch.empty((R, Kc, 3), dtype=torch.float32, device=dev)
    _cuda.launch("topk_rgb.bwd", "nsl_topk_rgb_bwd", R, topk_w.data_ptr(),
                 wsum.data_ptr(), rgb.data_ptr(), g_out.data_ptr(), g_w.data_ptr(),
                 g_wsum.data_ptr(), g_rgb.data_ptr(), R, Kc)
    return g_w, g_wsum, g_rgb


# what the kernels refuse (csrc/composite.cu returns cudaErrorInvalidValue
# there) is what the JAX package cannot run either: a ray of no samples, or
# a top-k outside lax.top_k's 0 < Kc <= S; the wrappers raise first
def check_weights_topk_shape(S: int, Kc: int) -> None:
    if not (S >= 1 and 0 < Kc <= S):
        raise ValueError(f"weights_topk kernel: S {S}, Kc {Kc} run in neither package "
                         f"(lax.top_k needs 0 < Kc <= S)")


def check_composite_shape(S: int) -> None:
    if S < 1:
        raise ValueError(f"composite kernel: S {S} runs in neither package (no samples)")


def check_topk_rgb_shape(Kc: int) -> None:
    if Kc < 1:
        raise ValueError(f"topk_rgb kernel needs Kc >= 1, got {Kc}")


def weights_topk(z_vals: torch.Tensor, density: torch.Tensor,
                 normals: torch.Tensor, Kc: int):
    """K4's weights pass for colour top-k: z_vals [R,S] (no gradient),
    density [R,S], normals [R,S,3] -> (weights [R,S], depth [R,1],
    normal_map [R,3], topk_w [R,Kc], wsum [R,1], picks [R,Kc] int64 flat
    indices ray·S + i); gradients reach density and normals through the
    first five. Plain version on CPU, kernel on CUDA."""
    if not _cuda.on_card("weights_topk", z_vals):
        return weights_topk_plain(z_vals, density, normals, Kc)
    R, S = z_vals.shape
    check_weights_topk_shape(S, Kc)
    _cuda.check(z_vals, "z_vals", torch.float32, (R, S))
    _cuda.check(density, "density", torch.float32, (R, S), device=z_vals.device)
    _cuda.check(normals, "normals", torch.float32, (R, S, 3), device=z_vals.device)
    return _WeightsTopkCUDA.apply(z_vals.detach(), density, normals, int(Kc))


def topk_rgb(topk_w: torch.Tensor, wsum: torch.Tensor, rgb: torch.Tensor):
    """K4's top-k colour composite: topk_w [R,Kc], wsum [R,1],
    rgb [R,Kc,3] -> [R,3]; gradients to all three. Plain version on CPU,
    kernel on CUDA."""
    if not _cuda.on_card("topk_rgb", topk_w):
        return topk_rgb_plain(topk_w, wsum, rgb)
    R, Kc = topk_w.shape
    check_topk_rgb_shape(Kc)
    _cuda.check(topk_w, "topk_w", torch.float32, (R, Kc))
    _cuda.check(wsum, "wsum", torch.float32, (R, 1), device=topk_w.device)
    _cuda.check(rgb, "rgb", torch.float32, (R, Kc, 3), device=topk_w.device)
    return _TopkRGBCUDA.apply(topk_w, wsum, rgb)


def composite(z_vals: torch.Tensor, density: torch.Tensor, rgb: torch.Tensor,
              normals: torch.Tensor):
    """K4: z_vals [R,S] (no gradient), density [R,S], rgb [R,S,3],
    normals [R,S,3] -> (weights [R,S], rgb_values [R,3], depth [R,1],
    normal_map [R,3]). Plain version on CPU, kernel on CUDA."""
    if not _cuda.on_card("composite", z_vals):
        return composite_plain(z_vals, density, rgb, normals)
    R, S = z_vals.shape
    check_composite_shape(S)
    _cuda.check(z_vals, "z_vals", torch.float32, (R, S))
    _cuda.check(density, "density", torch.float32, (R, S), device=z_vals.device)
    _cuda.check(rgb, "rgb", torch.float32, (R, S, 3), device=z_vals.device)
    _cuda.check(normals, "normals", torch.float32, (R, S, 3), device=z_vals.device)
    return _CompositeCUDA.apply(z_vals.detach(), density, rgb, normals)
