"""Ray sampling: stratified uniform + inverse-CDF importance sampling
(counterpart of nicer_slam_tpu/ops/ray_sampling.py): kernel K5.

The 640-sample prepass reads a periodically refreshed ``[res³]`` density
volume (the "cached" prepass, models/scene_model.build_density_cache)
trilinearly; ``importance_sample`` fuses that read with the whole sampler,
and ``importance_sample_plain`` is its plain version (the CPU path and the
reference for the comparisons on the card).

The "exact" prepass (``render_rays`` without a cache: the JAX package's
default in training, and every eval render) evaluates the SDF network and
the voxel β at the prepass z (K6, ops/sdf_density.py) and
``importance_sample_given`` runs the same weights, inverse CDF, merge and
sort on those densities, with z, near and far as inputs, so that the CDF
uses bit for bit the z the network was evaluated at (jittered in
training).

Every random draw is an input: ``t_rand [R, Ne]`` (stratified jitter),
``perm`` (the extra bins, shared by the rays of a chunk: ``[N_extra]``
for all rays, or ``[n_chunks, N_extra]``, row r // (R / n_chunks) for ray
r, as the JAX package's exact prepass draws them per chunk of
``prepass_ray_chunk`` rays) and ``eik_idx [R]`` (the eikonal anchor).
Rays are detached: z never carries a pose gradient.

On the card K5 is latency bound: per ray, 640 trilinear reads of an
L2-resident 8 MB volume and two 640-long scans. One warp holds one ray:
the reads are lane-strided, the scans lane-chunked and combined by warp
shuffles, the binary searches lane-strided, and the merged row is sorted
by a warp bitonic sort in 128 slots; nothing but z_vals and z_eik
touches device memory (csrc/sampler.cu). Every shape the JAX package
runs goes through the kernel: past 1024 prepass samples the lane chunks
are scanned in the warp's row in passes, past 128 sorted samples the sort
takes 8 or 16 keys a lane or sorts in the row, and rows that outgrow a
block's shared memory live in a global scratch
(``nsl_importance_sample_rows`` says when).

The plain version sums in the kernel's order (``lane_exclusive_cumsum``,
``lane_total``): the inverse CDF is a discontinuous function of the cdf
(the u = 1 sample follows the last bit of the cdf's total, and a bin whose
cdf step falls under 1e-5 snaps to its lower edge), so on the card the two
must see the same float32 numbers, not numbers a few ulps apart. Every
other operation rounds once, in the order the expressions below state,
and the kernel keeps that order (no fused multiply-adds).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.camera import near_far_from_cube
from . import _cuda


class SamplerConfig(NamedTuple):
    scene_bounding_sphere: float = 1.0
    near: float = 0.0
    N_samples: int = 64
    N_samples_eval: int = 640
    N_samples_extra: int = 32
    # the exact prepass in training draws its extra bins per chunk of this
    # many rays when R > prepass_ray_chunk and R % prepass_ray_chunk == 0
    # (the JAX package's sequential ray chunks, each with its own key);
    # 0 = one draw for all rays
    prepass_ray_chunk: int = 1024
    prepass_mode: str = "exact"
    prepass_cache_res: int = 128

    @property
    def uniform_far(self) -> float:
        # UniformSampler(take_sphere_intersection=True) far: 2·bound·1.75
        return 2.0 * self.scene_bounding_sphere * 1.75

    @property
    def total_samples(self) -> int:
        return self.N_samples + self.N_samples_extra + 2


def prepass_chunks(cfg: SamplerConfig, R: int) -> int:
    """Chunks of ``prepass_ray_chunk`` rays whose exact prepass in training
    draws its own jitter, extra bins and anchors (1: no chunking)."""
    pc = cfg.prepass_ray_chunk
    return R // pc if pc and R > pc and R % pc == 0 else 1


def perm_rows(perm: torch.Tensor, R: int) -> torch.Tensor:
    """The extra bins of every ray [R, N_extra] from ``perm`` [N_extra] or
    [n_chunks, N_extra] (ray r takes row r // (R / n_chunks))."""
    if perm.dim() == 1:
        return perm[None].expand(R, -1)
    C = perm.shape[0]
    if R % C:
        raise ValueError(f"perm: {C} chunks do not divide {R} rays")
    return perm.repeat_interleave(R // C, dim=0)


def perm_slice(perm: torch.Tensor, R: int, lo: int, hi: int) -> torch.Tensor:
    """The extra-bin rows of rays lo .. hi - 1 of R: ``perm`` itself when
    all rays share it ([N_extra]); else the rows of the chunks the slice
    covers, which must be whole chunks (ray r reads row r // (R /
    n_chunks) by its global index)."""
    if perm.dim() == 1:
        return perm
    per = R // perm.shape[0]
    if R % perm.shape[0] or lo % per or hi % per:
        raise ValueError(f"rays {lo}..{hi} of {R} do not cover whole prepass chunks of "
                         f"{per} rays: shard the rays in multiples of prepass_ray_chunk")
    return perm[lo // per:hi // per]


def _step(n: int) -> float:
    """f32(1/(n-1)), the step of linspace(0, 1, n) (0 for n = 1, whose one
    point is 0)."""
    return float(np.float32(1.0 / (n - 1))) if n > 1 else 0.0


def check_sampler_shape(cfg: SamplerConfig, Ne: int) -> None:
    """Raise for a sampler shape the JAX package cannot run either: no
    prepass sample, or a negative count. The kernel takes every other."""
    if Ne < 1 or cfg.N_samples < 0 or cfg.N_samples_extra < 0:
        raise ValueError(
            f"importance sampler: N_samples_eval {Ne}, N_samples {cfg.N_samples} and "
            f"N_samples_extra {cfg.N_samples_extra} run in neither package (needs "
            f"N_samples_eval >= 1 and no negative count)")


def linspace01(n: int, device=None) -> torch.Tensor:
    """float32 linspace(0, 1, n) with the reference's rounding:
    ``i · f32(1/(n-1))``, last element exactly 1 (n = 1: [0])."""
    t = torch.arange(n, dtype=torch.float32, device=device) * _step(n)
    if n > 1:
        t[-1] = 1.0
    return t


def _rows(R: int, cfg: SamplerConfig, Ne: int, dev):
    """The kernel's global scratch rows for this shape ((rows [n, f],
    n) where a warp's rows outgrow a block's shared memory; else None)."""
    lib = _cuda.library()
    f = lib.nsl_importance_sample_rows(Ne, cfg.N_samples, cfg.N_samples_extra)
    if f < 0:
        raise RuntimeError("nsl_importance_sample_rows: invalid shape or no device")
    if f == 0:
        return None
    n = lib.nsl_importance_sample_row_warps(R)
    return torch.empty((n, f), dtype=torch.float32, device=dev), n


def uniform_z_vals(cfg: SamplerConfig, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, t_rand: Optional[torch.Tensor]):
    """Stratified samples from the cube intersection -> (z [R,Ne],
    near [R,1], far [R,1]); ``t_rand`` None = no jitter (eval)."""
    rays_o, rays_d = rays_o.detach(), rays_d.detach()
    _, far = near_far_from_cube(rays_o, rays_d, bound=cfg.scene_bounding_sphere,
                                near_min=cfg.near, far_max=cfg.uniform_far)
    near = torch.full_like(far, cfg.near)
    t = linspace01(cfg.N_samples_eval, rays_o.device)
    z_vals = near * (1.0 - t) + far * t
    if t_rand is not None:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals, near, far


# The kernel's summation order: a warp holds a row of M entries, lane l the
# ceil(M/32) contiguous entries from l·ceil(M/32), summed serially from 0;
# the lanes' sums combine by a Hillis–Steele scan (a prefix) or a butterfly
# (a total), as csrc/warp.cuh does.
_LANES = 32


def _lane_chunks(x: torch.Tensor) -> torch.Tensor:
    """[R, M] -> [R, 32, ceil(M/32)], zero-padded."""
    R, M = x.shape
    n = -(-M // _LANES)
    return torch.nn.functional.pad(x, (0, _LANES * n - M)).reshape(R, _LANES, n)


def _lane_sums(xc: torch.Tensor) -> torch.Tensor:
    s = torch.zeros_like(xc[..., 0])
    for j in range(xc.shape[-1]):
        s = s + xc[..., j]
    return s


def lane_exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums along the rows of ``x`` [R, M] in the kernel's
    order: each lane's entries serially from the exclusive scan of the
    lanes' sums."""
    xc = _lane_chunks(x)
    incl = _lane_sums(xc)
    for o in (1, 2, 4, 8, 16):
        incl = torch.cat([incl[:, :o], incl[:, o:] + incl[:, :-o]], 1)
    run = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], 1)
    out = []
    for j in range(xc.shape[-1]):
        out.append(run)
        run = run + xc[..., j]
    return torch.stack(out, -1).reshape(x.shape[0], -1)[:, :x.shape[1]]


def lane_total(x: torch.Tensor) -> torch.Tensor:
    """Row sums of ``x`` [R, M] -> [R, 1] in the kernel's order."""
    s = _lane_sums(_lane_chunks(x))
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, torch.arange(_LANES, device=x.device) ^ o]
    return s[:, :1]


def sample_cdf(bins: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Deterministic inverse-CDF sampling at u = linspace(0, 1, n). The pdf
    (``weights[:, :-1] + 1e-5``) is laid out over the Ne entries of the row
    (its last one 0), so its sums take the lane chunks of the prepass."""
    pdf = weights[..., :-1] + 1e-5
    pdf = torch.nn.functional.pad(pdf, (0, 1))
    pdf = pdf / lane_total(pdf)
    cdf = lane_exclusive_cumsum(pdf)
    u = linspace01(n, bins.device).expand(cdf.shape[0], n).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def density_cache_lookup(cache: torch.Tensor, res: int, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear read of the plain [res³] density volume (flat index
    (x·res + y)·res + z): [N,3] -> [N]; 0 outside |p| <= 1."""
    g = (pts + 1.0) * (0.5 * (res - 1))
    g0 = torch.floor(g).to(torch.int64).clamp(0, res - 2)
    f = (g - g0.to(g.dtype)).clamp(0.0, 1.0)
    base = (g0[:, 0] * res + g0[:, 1]) * res + g0[:, 2]
    dens = torch.zeros_like(pts[:, 0])
    for c in range(8):
        bx, by, bz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        w = ((f[:, 0] if bx else 1.0 - f[:, 0]) * (f[:, 1] if by else 1.0 - f[:, 1])
             * (f[:, 2] if bz else 1.0 - f[:, 2]))
        dens = dens + cache[base + bx * res * res + by * res + bz] * w
    inb = (pts.abs() <= 1.0).all(dim=-1)
    return torch.where(inb, dens, torch.zeros_like(dens))


def prepass_weights(z_vals: torch.Tensor, density: torch.Tensor) -> torch.Tensor:
    """Volume-rendering weights of the prepass samples [R, Ne]: the free
    energy's exclusive cumsum, last dist 1e10."""
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full_like(z_vals[:, :1], 1e10)], -1)
    free_energy = dists * density
    return ((1.0 - torch.exp(-free_energy))
            * torch.exp(-lane_exclusive_cumsum(free_energy)))


def _sample_from_density(cfg: SamplerConfig, z_vals, near, far, density,
                         perm, eik_idx):
    """Weights, inverse CDF, merge with near, far and z[perm], sort, the
    eikonal anchor (ray_sampler.py:100-166 after the density)."""
    R = z_vals.shape[0]
    z_samples = sample_cdf(z_vals, prepass_weights(z_vals, density), cfg.N_samples)
    z_all = torch.cat([z_samples, near, far,
                       torch.gather(z_vals, 1, perm_rows(perm, R))], -1)
    z_all, _ = torch.sort(z_all, -1)
    z_eik = torch.gather(z_all, -1, eik_idx.reshape(R, 1))
    return z_all, z_eik


def importance_sample_plain(cfg: SamplerConfig, rays_o: torch.Tensor,
                            rays_d: torch.Tensor, cache: torch.Tensor,
                            t_rand: Optional[torch.Tensor], perm: torch.Tensor,
                            eik_idx: torch.Tensor):
    """Plain version of K5 (ray_sampler.py:90-166 with the cached prepass):
    (z_vals [R, Ns+Nextra+2] sorted, z_eik [R,1])."""
    with torch.no_grad():
        z_vals, near, far = uniform_z_vals(cfg, rays_o, rays_d, t_rand)
        R, Ne = z_vals.shape
        pts = rays_o.detach()[:, None, :] + z_vals[..., None] * rays_d.detach()[:, None, :]
        density = density_cache_lookup(cache, cfg.prepass_cache_res,
                                       pts.reshape(-1, 3)).reshape(R, Ne)
        return _sample_from_density(cfg, z_vals, near, far, density, perm, eik_idx)


def importance_sample_given_plain(cfg: SamplerConfig, z_vals: torch.Tensor,
                                  near: torch.Tensor, far: torch.Tensor,
                                  density: torch.Tensor, perm: torch.Tensor,
                                  eik_idx: torch.Tensor):
    """Plain version of K5's given-density mode: z [R, Ne], near and far
    [R, 1] from ``uniform_z_vals`` (jittered or not) and the densities at z
    -> (z_vals [R, S] sorted, z_eik [R,1])."""
    with torch.no_grad():
        return _sample_from_density(cfg, z_vals, near, far, density, perm, eik_idx)


def importance_sample(cfg: SamplerConfig, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, cache: torch.Tensor,
                      t_rand: Optional[torch.Tensor], perm: torch.Tensor,
                      eik_idx: torch.Tensor):
    """K5: the cached-prepass importance sampler -> (z_vals [R, S] sorted,
    z_eik [R, 1]). Plain version on CPU, kernel on CUDA."""
    if rays_o.device.type == "cpu":
        return importance_sample_plain(cfg, rays_o, rays_d, cache, t_rand,
                                       perm, eik_idx)
    if rays_o.device.type != "cuda":
        raise ValueError(f"importance_sample: unsupported device {rays_o.device}")
    R = rays_o.shape[0]
    Ne, Ns, Nx = cfg.N_samples_eval, cfg.N_samples, cfg.N_samples_extra
    check_sampler_shape(cfg, Ne)
    res = cfg.prepass_cache_res
    dev = rays_o.device
    rays_o, rays_d = rays_o.detach().contiguous(), rays_d.detach().contiguous()
    _cuda.check(rays_o, "rays_o", torch.float32, (R, 3))
    _cuda.check(rays_d, "rays_d", torch.float32, (R, 3), device=dev)
    _cuda.check(cache, "cache", torch.float32, (res ** 3,), device=dev)
    if t_rand is not None:
        _cuda.check(t_rand, "t_rand", torch.float32, (R, Ne), device=dev)
    _cuda.check(perm, "perm", torch.int64, (Nx,), device=dev)
    _cuda.check(eik_idx, "eik_idx", torch.int64, (R,), device=dev)
    St = cfg.total_samples
    z_out = torch.empty((R, St), dtype=torch.float32, device=dev)
    z_eik = torch.empty((R, 1), dtype=torch.float32, device=dev)
    args = (rays_o.data_ptr(), rays_d.data_ptr(), cache.data_ptr(), _cuda.ptr(t_rand),
            perm.data_ptr(), eik_idx.data_ptr(), z_out.data_ptr(), z_eik.data_ptr(), R, res,
            Ne, Ns, Nx, float(cfg.scene_bounding_sphere), float(cfg.near),
            float(cfg.uniform_far), _step(Ne), _step(Ns))
    rows = _rows(R, cfg, Ne, dev) if R else None
    if rows is None:
        _cuda.launch("importance_sample", "nsl_importance_sample", R, *args)
    else:
        _cuda.launch("importance_sample", "nsl_importance_sample_global", R, *args,
                     rows[0].data_ptr(), rows[1])
    return z_out, z_eik


def importance_sample_given(cfg: SamplerConfig, z_vals: torch.Tensor,
                            near: torch.Tensor, far: torch.Tensor,
                            density: torch.Tensor, perm: torch.Tensor,
                            eik_idx: torch.Tensor):
    """K5 in given-density mode (the exact prepass): z [R, Ne], near and far
    [R, 1] and the prepass densities [R, Ne] -> (z_vals [R, S] sorted,
    z_eik [R, 1]). ``perm`` is [N_extra] or [n_chunks, N_extra]. Plain
    version on CPU, kernel on CUDA."""
    if z_vals.device.type == "cpu":
        return importance_sample_given_plain(cfg, z_vals, near, far, density, perm,
                                             eik_idx)
    if z_vals.device.type != "cuda":
        raise ValueError(f"importance_sample_given: unsupported device {z_vals.device}")
    R = z_vals.shape[0]
    Ne, Ns, Nx = cfg.N_samples_eval, cfg.N_samples, cfg.N_samples_extra
    check_sampler_shape(cfg, Ne)
    dev = z_vals.device
    z_vals, density = z_vals.detach().contiguous(), density.detach().contiguous()
    near, far = near.detach().contiguous(), far.detach().contiguous()
    _cuda.check(z_vals, "z_vals", torch.float32, (R, Ne))
    _cuda.check(near, "near", torch.float32, (R, 1), device=dev)
    _cuda.check(far, "far", torch.float32, (R, 1), device=dev)
    _cuda.check(density, "density", torch.float32, (R, Ne), device=dev)
    C = 1 if perm.dim() == 1 else perm.shape[0]
    if R % C:
        raise ValueError(f"perm: {C} chunks do not divide {R} rays")
    _cuda.check(perm, "perm", torch.int64, (Nx,) if perm.dim() == 1 else (C, Nx), device=dev)
    _cuda.check(eik_idx, "eik_idx", torch.int64, (R,), device=dev)
    z_out = torch.empty((R, cfg.total_samples), dtype=torch.float32, device=dev)
    z_eik = torch.empty((R, 1), dtype=torch.float32, device=dev)
    args = (z_vals.data_ptr(), near.data_ptr(), far.data_ptr(), density.data_ptr(),
            perm.data_ptr(), eik_idx.data_ptr(), z_out.data_ptr(), z_eik.data_ptr(),
            R, R // C, Ne, Ns, Nx, _step(Ns))
    rows = _rows(R, cfg, Ne, dev) if R else None
    if rows is None:
        _cuda.launch("importance_sample_given", "nsl_importance_sample_given", R, *args)
    else:
        _cuda.launch("importance_sample_given", "nsl_importance_sample_given_global", R,
                     *args, rows[0].data_ptr(), rows[1])
    return z_out, z_eik
