"""Scene model: the per-ray-batch forward pass (counterpart of
nicer_slam_tpu/models/scene_model.py).

Rays live in one flat ``[R]`` batch with a per-ray keyframe-slot id. The
path: rays -> importance sampler, with one of two prepasses: "cached" (K5
reads the ``[res³]`` prepass density that K6 builds) or "exact" (the JAX
package's default, and every eval render: K6 evaluates the SDF network and
the density at every jittered prepass z, K5 samples from those densities)
-> coarse+fine SDF with analytic normals (K1) -> Laplace density with the
voxel-counter β (K7) -> per-ray composite (K4; in training with
``color_topk`` the weights pass picks the top-k samples and the color
network, K2 on the color grid, runs only there; with ``model_exposure`` a
second composite of the colour before the exposure) -> flow over the
keyframe edge graph, photometric warp per patch size, eikonal points, the
camera-space normal map and the SDF at the cameras.

Every random draw is an argument (``RenderDraws``); ``make_render_draws``
makes them from a torch Generator, and the tests hand in the JAX package's
draws instead.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import Config

from ..ops import density as density_ops
from ..ops import sdf_density
from ..ops.ray_sampling import (SamplerConfig, importance_sample,
                                 importance_sample_given, prepass_chunks, uniform_z_vals)
from ..ops.safe_math import safe_norm
from ..ops.volume_rendering import composite, topk_rgb, weights_topk
from ..utils.camera import rays_from_uv
from . import fields


class SceneConfig(NamedTuple):
    combine: fields.CombineConfig
    render: fields.RenderingNetConfig
    sampler: SamplerConfig
    density_method: str = "volsdf_gridpredefined"
    scene_bounding_sphere: float = 1.0
    voxel_res: int = 64
    white_bkgd: bool = False
    bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    use_warp_loss: bool = True
    H: int = 680
    W: int = 1200
    # the warp's patch sizes: each lifts a ps x ps patch around a ray
    patchsizes: Tuple[int, ...] = (1,)
    # in training, the color network runs only at the color_topk samples of
    # largest weight per ray, their weights renormalised to the ray's whole
    # weight (the JAX package's SceneConfig.color_topk); 0 = every sample
    color_topk: int = 0


def scene_config_from_conf(model_conf: Config, img_res, n_images: int) -> SceneConfig:
    fvs = model_conf.get_int("feature_vector_size")
    rs = model_conf.get_config("ray_sampler")
    sampler = SamplerConfig(
        scene_bounding_sphere=model_conf.get_float("scene_bounding_sphere", 1.0),
        near=rs.get_float("near", 0.0),
        N_samples=rs.get_int("N_samples", 64),
        N_samples_eval=rs.get_int("N_samples_eval", 640),
        N_samples_extra=rs.get_int("N_samples_extra", 32),
        prepass_ray_chunk=rs.get_int("prepass_ray_chunk", 1024),
        prepass_mode=rs.get_string("prepass_mode", "exact"),
        prepass_cache_res=rs.get_int("prepass_cache_res", 128),
    )
    combine = fields.combine_config_from_conf(model_conf.get_config("implicit_network"), fvs)
    if combine.fine.concat_coarse_feature and sampler.prepass_mode == "cached":
        raise ValueError("concat_coarse_feature with prepass_mode = cached: the JAX package "
                         "cannot build its density cache (build_density_cache fails with a "
                         "shape error in combine_sdf_packed, whose fine input lacks the coarse "
                         "features); use prepass_mode = exact")
    return SceneConfig(
        combine=combine,
        render=fields.rendering_config_from_conf(
            model_conf.get_config("rendering_network"), fvs, n_images=n_images),
        sampler=sampler,
        density_method=model_conf.get_string("density_method", "volsdf_gridpredefined"),
        scene_bounding_sphere=model_conf.get_float("scene_bounding_sphere", 1.0),
        voxel_res=model_conf.get_int("voxel_res", 64),
        white_bkgd=model_conf.get_bool("white_bkgd", False),
        use_warp_loss=model_conf.get_bool("use_warp_loss", False),
        H=int(img_res[0]),
        W=int(img_res[1]),
        patchsizes=tuple(int(p) for p in model_conf.get_list("mapping_patchsizes", [1])),
        color_topk=model_conf.get_int("color_topk", 0),
    )


class SceneModel(nn.Module):
    """All map parameters. state_dict keys with '.' -> '/' are the JAX
    param-tree paths (``implicit/coarse/encoding``, ``render/lins/0/v``, ...)."""

    def __init__(self, cfg: SceneConfig, rng: np.random.Generator):
        super().__init__()
        self.cfg = cfg
        self.implicit = fields.CombineNet(cfg.combine, rng)
        self.render = fields.RenderingNet(cfg.render, rng)
        if cfg.density_method == "volsdf_laplace":
            self.density = nn.ParameterDict(
                {"beta": nn.Parameter(torch.tensor(0.1, dtype=torch.float32))})


def init_voxels(cfg: SceneConfig, device=None) -> torch.Tensor:
    return torch.zeros((cfg.voxel_res,) * 3, dtype=torch.float32, device=device)


def _learned_beta(cfg: SceneConfig, model: SceneModel) -> Optional[torch.Tensor]:
    """volsdf_laplace's learned β; None for the voxel counter's β."""
    if cfg.density_method == "volsdf_laplace":
        return density_ops.learned_beta(model.density["beta"])
    return None


def _density(cfg: SceneConfig, model: SceneModel, voxels, sdf_flat, pts_flat,
             beta_scale=None):
    return sdf_density.density_from_sdf(sdf_flat, pts_flat, voxels,
                                        _learned_beta(cfg, model), beta_scale,
                                        cfg.voxel_res)


@torch.no_grad()
def build_density_cache(cfg: SceneConfig, model: SceneModel,
                        voxels: torch.Tensor) -> torch.Tensor:
    """Prepass density volume [res³] on the uniform linspace(-1, 1, res)
    grid, flat index (x·res + y)·res + z: the SDF from the bf16-packed
    coarse and fine tables, as the JAX package builds it, and the
    voxel-counter β, in one K6 launch on the card
    (``sdf_density.density_grid``). The sampler (K5) reads it trilinearly;
    the runner refreshes it. The JAX package's [res³, 8] cell-blocked
    layout holds the same values: its reads clip the cell to res - 2, so
    they never wrap."""
    return sdf_density.density_grid(model.implicit, sdf_density.pack_sdf(model.implicit),
                                    cfg.sampler.prepass_cache_res, voxels,
                                    _learned_beta(cfg, model), voxel_res=cfg.voxel_res)


@torch.no_grad()
def _exact_prepass(cfg: SceneConfig, model: SceneModel, voxels: torch.Tensor,
                   sdf_pack: sdf_density.SdfPack, cam_loc: torch.Tensor,
                   ray_dirs: torch.Tensor, t_rand: Optional[torch.Tensor],
                   perm: torch.Tensor, eik_idx: torch.Tensor, beta_scale=None):
    """The exact prepass (scene_model.py:238-287 with ray_sampling.py:
    112-163): the stratified z (jittered by ``t_rand`` in training), the
    density at every one of them in one K6 launch
    (``sdf_density.density_rays``: the SDF network from the bf16-packed
    tables and the voxel β), then K5 on those densities with the true near
    and far. The JAX package runs a training prepass in chunks of
    ``prepass_ray_chunk`` rays, one key each; ``perm`` carries their draws
    ([n_chunks, N_extra]), so one launch of each kernel covers all rays."""
    sc = cfg.sampler
    z, near, far = uniform_z_vals(sc, cam_loc, ray_dirs, t_rand)
    density = sdf_density.density_rays(model.implicit, sdf_pack, cam_loc, ray_dirs, z,
                                       voxels, _learned_beta(cfg, model), beta_scale,
                                       cfg.voxel_res)
    return importance_sample_given(sc, z, near, far, density, perm, eik_idx)


class RayBatch(NamedTuple):
    uv: torch.Tensor          # [R,2] pixel coords (x,y)
    kf_slot: torch.Tensor     # [R] int64 slot index
    poses: torch.Tensor       # [S,4,4] c2w (differentiable for tracking/BA)
    intrinsics: torch.Tensor  # [S,4,4]
    frame_ids: torch.Tensor   # [S] int64
    slot_valid: torch.Tensor  # [S] bool
    ray_valid: torch.Tensor   # [R] bool
    ray_weight: Optional[torch.Tensor] = None  # [R] float32


class FlowEdges(NamedTuple):
    idii: torch.Tensor   # [E] int64 reference slot
    idjj: torch.Tensor   # [E] int64 target slot
    valid: torch.Tensor  # [E] bool


class RenderDraws(NamedTuple):
    """The random draws of one render_rays call."""

    t_rand: torch.Tensor                        # [R, Ne] in [0,1)
    perm: torch.Tensor                          # [N_extra] or [n_chunks, N_extra] int64 bins
    eik_idx: torch.Tensor                       # [R] int64 in [0, S)
    eik_uniform: Optional[torch.Tensor] = None  # [10R, 3] in [-b, b)
    eik_nei: Optional[torch.Tensor] = None      # [11R, 3] in [0,1)


def make_render_draws(cfg: SceneConfig, R: int, gen: torch.Generator,
                      device, is_mapping: bool) -> RenderDraws:
    """The draws of one training render_rays call: the exact prepass draws
    its extra bins per chunk of ``prepass_ray_chunk`` rays (``perm``
    [n_chunks, N_extra] when it chunks), the cached prepass once."""
    sc = cfg.sampler
    t_rand = torch.rand((R, sc.N_samples_eval), generator=gen, device=device)
    n = prepass_chunks(sc, R) if sc.prepass_mode != "cached" else 1
    perms = [torch.randperm(sc.N_samples_eval, generator=gen,
                            device=device)[:sc.N_samples_extra] for _ in range(n)]
    perm = perms[0] if n == 1 else torch.stack(perms)
    eik_idx = torch.randint(0, sc.total_samples, (R,), generator=gen, device=device)
    if not is_mapping:
        return RenderDraws(t_rand, perm, eik_idx)
    b = cfg.scene_bounding_sphere
    eik_uniform = torch.rand((10 * R, 3), generator=gen, device=device) * (2 * b) - b
    eik_nei = torch.rand((11 * R, 3), generator=gen, device=device)
    return RenderDraws(t_rand, perm, eik_idx, eik_uniform, eik_nei)


def render_rays(cfg: SceneConfig, model: SceneModel, voxels: torch.Tensor,
                batch: RayBatch, draws: RenderDraws, *, stage: str = "fine",
                color_stage: str = "highfreq", training: bool = True,
                is_mapping: bool = False, edges: Optional[FlowEdges] = None,
                full_rgb: Optional[torch.Tensor] = None,
                full_depth: Optional[torch.Tensor] = None,
                density_cache: Optional[torch.Tensor] = None,
                sdf_pack: Optional[sdf_density.SdfPack] = None,
                beta_scale: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Forward pass over a flat ray batch. With ``is_mapping`` the output
    also holds the updated voxel counter (``voxels``) and the eikonal
    gradients (``grad_theta``, ``grad_theta_nei``), and, with the warp
    loss and ``full_rgb`` [S, H*W, 3], ``warp_{sampled_rgb,gt_rgb,mask}_{ps}``
    for every patch size (``full_depth`` [S, H*W], the slots' monocular
    depth, masks the patches of ps > 1 across depth edges). With a
    ``density_cache`` the prepass reads it; without one it is exact and
    reads ``sdf_pack``, the caller's ``sdf_density.pack_sdf`` of the model
    (packed once per mapping iteration, tracked frame or render). With
    ``model_exposure`` the output holds ``rgb_un`` and ``rgb_un_values``,
    the colours before the exposure and their composite."""
    if density_cache is None and sdf_pack is None:
        raise ValueError("the exact prepass reads sdf_pack "
                         "(sdf_density.pack_sdf of the model)")
    R = batch.uv.shape[0]
    K = batch.intrinsics[batch.kf_slot]
    c2w = batch.poses[batch.kf_slot]
    ray_dirs, cam_loc, depth_scale = rays_from_uv(batch.uv, c2w, K)

    if training:
        perm = draws.perm
    else:
        ne = cfg.sampler.N_samples_eval
        perm = torch.as_tensor(np.linspace(0, ne - 1, cfg.sampler.N_samples_extra)
                               .astype(np.int64), device=ray_dirs.device)
    t_rand = draws.t_rand if training else None
    if density_cache is None:
        z_vals, z_eik = _exact_prepass(cfg, model, voxels, sdf_pack, cam_loc.detach(),
                                       ray_dirs.detach(), t_rand, perm, draws.eik_idx,
                                       beta_scale)
    else:
        z_vals, z_eik = importance_sample(cfg.sampler, cam_loc, ray_dirs, density_cache,
                                          t_rand, perm, draws.eik_idx)
    S = z_vals.shape[1]

    points = cam_loc[:, None, :] + z_vals[..., None] * ray_dirs[:, None, :]
    points_flat = points.reshape(-1, 3)
    new_voxels = (density_ops.update_voxels(voxels, points_flat, cfg.voxel_res)
                  if is_mapping else voxels)
    dirs_flat = ray_dirs[:, None, :].expand(R, S, 3).reshape(-1, 3)

    sdf, feature_vectors, gradients = fields.combine_get_outputs(
        model.implicit, points_flat, stage)
    density = _density(cfg, model, new_voxels, sdf[:, 0], points_flat,
                       beta_scale).reshape(R, S)
    normals = (gradients / (safe_norm(gradients, dim=-1, keepdim=True) + 1e-6)
               ).reshape(R, S, 3)
    # each point's frame index, for the per-image and exposure codes
    rcfg = cfg.render
    ray_frames = (batch.frame_ids[batch.kf_slot]
                  if rcfg.per_image_code or rcfg.model_exposure else None)
    Kc = cfg.color_topk
    if training and 0 < Kc < S:
        # color only at the Kc samples of largest weight (scene_model.py:
        # 323-353); gradients reach the kept weights and the weight sum
        weights, depth_values, normal_comp, topk_w, wsum, picks = weights_topk(
            z_vals, density, normals, Kc)
        flat_i = picks.reshape(-1)
        rgb_k = fields.rendering_forward(
            model.render, points_flat[flat_i], gradients[flat_i], dirs_flat[flat_i],
            feature_vectors[flat_i], color_stage,
            image_indices=None if ray_frames is None else ray_frames.repeat_interleave(Kc))
        if rcfg.model_exposure:
            rgb_k, rgb_un = (t.reshape(R, Kc, 3) for t in rgb_k)
            rgb_un_values = topk_rgb(topk_w, wsum, rgb_un)
        rgb_values = topk_rgb(topk_w, wsum, rgb_k.reshape(R, Kc, 3))
    else:
        rgb_flat = fields.rendering_forward(
            model.render, points_flat, gradients, dirs_flat, feature_vectors, color_stage,
            image_indices=None if ray_frames is None else ray_frames.repeat_interleave(S))
        if rcfg.model_exposure:
            rgb_flat, rgb_un = rgb_flat
            rgb_un = rgb_un.reshape(R, S, 3)
            rgb_un_values = composite(z_vals, density, rgb_un, normals)[1]
        weights, rgb_values, depth_values, normal_comp = composite(
            z_vals, density, rgb_flat.reshape(R, S, 3), normals)
    surf_points = cam_loc + depth_values * ray_dirs                      # [R,3]

    out: Dict[str, torch.Tensor] = {}

    # ---- optical-flow prediction over the edge graph (network.py:153-165)
    if edges is not None:
        tgt_w2c = torch.linalg.inv(batch.poses[edges.idjj])
        tgt_K = batch.intrinsics[edges.idjj]
        cam_pts = (torch.einsum("eij,rj->eri", tgt_w2c[:, :3, :3], surf_points)
                   + tgt_w2c[:, None, :3, 3])
        pix = torch.einsum("eij,erj->eri", tgt_K[:, :3, :3], cam_pts)
        out["flow"] = pix[..., :2] / (pix[..., 2:] + 1e-8) - batch.uv[None]

    # ---- warp (network.py:167-279): per patch size, a ps x ps pixel patch
    # around every ray lifted to the ray's rendered depth (fronto-parallel),
    # reprojected into every keyframe slot and sampled bilinearly there; the
    # ground truth is the ray's own keyframe, integer-sampled (1.0 outside
    # the image, masked); for ps > 1 the patch's monocular-depth variance
    # must be under 0.01 (network.py:260-271)
    if cfg.use_warp_loss and is_mapping and full_rgb is not None:
        w2c_all = torch.linalg.inv(batch.poses)
        for ps in cfg.patchsizes:
            out.update(_warp_patches(cfg, batch, ps, w2c_all, c2w, K, depth_values,
                                     surf_points, full_rgb, full_depth))

    depth_values = depth_scale * depth_values
    if cfg.white_bkgd:
        acc = weights.sum(-1)
        rgb_values = rgb_values + (1.0 - acc[..., None]) * torch.tensor(
            cfg.bg_color, device=rgb_values.device)

    out.update({
        "rgb_values": rgb_values,
        "depth_values": depth_values,
        "z_vals": z_vals,
        "sdf": sdf.reshape(R, S),
        "weights": weights,
    })
    if rcfg.model_exposure:
        out["rgb_un"] = rgb_un
        out["rgb_un_values"] = rgb_un_values

    # ---- eikonal points (network.py:313-336)
    if training and is_mapping:
        eik_near = (cam_loc + z_eik * ray_dirs).detach()
        eik_pts = torch.cat([draws.eik_uniform, eik_near], dim=0)
        neighbours = eik_pts + (draws.eik_nei - 0.5) * 0.01
        all_pts = torch.cat([eik_pts, neighbours], dim=0)
        grad_theta = fields.combine_gradient(model.implicit, all_pts, stage)
        half = all_pts.shape[0] // 2
        out["grad_theta"] = grad_theta[:half]
        out["grad_theta_nei"] = grad_theta[half:]

    # ---- normal map in camera coords (network.py:339-345)
    rot = c2w[:, :3, :3]
    out["normal_map"] = torch.einsum("rij,ri->rj", rot, normal_comp)

    # ---- SDF at the camera origins (the collapse-guard input)
    out["cam_sdf"] = fields.combine_sdf(
        model.implicit, batch.poses[:, :3, 3].contiguous(), stage)[:, 0]
    if is_mapping:
        out["voxels"] = new_voxels
    return out


def _warp_patches(cfg: SceneConfig, batch: RayBatch, ps: int, w2c_all, c2w, K,
                  depth_values, surf_points, full_rgb, full_depth):
    """The warp outputs of one patch size: ``warp_sampled_rgb_{ps}``
    [S,R,pp,3], ``warp_gt_rgb_{ps}`` [R,pp,3] and ``warp_mask_{ps}``
    [S,R,pp] (pp = ps²)."""
    R, pp = batch.uv.shape[0], ps * ps
    if ps == 1:
        patch_uv = batch.uv[:, None, :]                                  # [R,1,2]
        pts = surf_points[:, None, :]                                    # [R,1,3]
    else:
        half = ps // 2
        gx, gy = np.meshgrid(np.arange(-half, half + 1), np.arange(-half, half + 1),
                             indexing="ij")
        offs = torch.as_tensor(np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32),
                               device=batch.uv.device)
        patch_uv = batch.uv[:, None, :] + offs[None]                     # [R,pp,2]
        dirs_p, cam_p, _ = rays_from_uv(patch_uv.reshape(-1, 2),
                                        c2w.repeat_interleave(pp, 0),
                                        K.repeat_interleave(pp, 0))
        pts = (cam_p + depth_values.repeat_interleave(pp, 0) * dirs_p).reshape(R, pp, 3)
    flat = pts.reshape(-1, 3)
    cam_pts = (torch.einsum("sij,nj->sni", w2c_all[:, :3, :3], flat)
               + w2c_all[:, None, :3, 3])
    pix_p = torch.einsum("sij,snj->sni", batch.intrinsics[:, :3, :3], cam_pts)
    tgt_uv = pix_p[..., :2] / (pix_p[..., 2:] + 1e-8)                    # [S,R·pp,2]
    tgt_depth = pix_p[..., 2]
    # the reference normalises by W (not W-1) and grid_samples with
    # align_corners=True: the sample lies at uv·(dim-1)/dim
    sx = tgt_uv[..., 0] * (cfg.W - 1) / cfg.W
    sy = tgt_uv[..., 1] * (cfg.H - 1) / cfg.H
    sampled = _bilinear_sample_images(full_rgb, sx, sy, cfg.H, cfg.W)
    nu = tgt_uv[..., 0] / cfg.W * 2 - 1
    nv = tgt_uv[..., 1] / cfg.H * 2 - 1
    in_bounds = ((nu > -1) & (nu < 1) & (nv > -1) & (nv < 1)
                 & (tgt_depth > 0)).reshape(-1, R, pp)                   # [S,R,pp]
    iu = patch_uv[..., 0].to(torch.int64)                                # [R,pp]
    iv = patch_uv[..., 1].to(torch.int64)
    inb_gt = (iu >= 0) & (iu < cfg.W) & (iv >= 0) & (iv < cfg.H)
    pix_idx = iv.clamp(0, cfg.H - 1) * cfg.W + iu.clamp(0, cfg.W - 1)
    gt_rgb = full_rgb[batch.kf_slot[:, None], pix_idx]                  # [R,pp,3]
    if gt_rgb.dtype == torch.uint8:
        gt_rgb = gt_rgb.to(torch.float32) / 255.0
    gt_rgb = torch.where(inb_gt[..., None], gt_rgb, torch.ones_like(gt_rgb))
    mask = (in_bounds & inb_gt[None] & batch.slot_valid[:, None, None]
            & batch.ray_valid[None, :, None])
    if ps > 1 and full_depth is not None:
        d_patch = full_depth[batch.kf_slot[:, None], pix_idx].to(torch.float32)
        d_patch = torch.where(inb_gt, d_patch, torch.ones_like(d_patch))
        mask = mask & (d_patch.var(dim=-1, unbiased=False) < 0.01)[None, :, None]
    return {f"warp_sampled_rgb_{ps}": sampled.reshape(-1, R, pp, 3),
            f"warp_gt_rgb_{ps}": gt_rgb, f"warp_mask_{ps}": mask}


def _bilinear_sample_images(images: torch.Tensor, x: torch.Tensor,
                            y: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear sample with zero padding: images [S, H*W, C] (uint8 or
    float), x/y [S, R] pixel coords -> [S, R, C]."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    C = images.shape[-1]

    def gather(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = torch.gather(images, 1, flat[..., None].expand(*flat.shape, C))
        if vals.dtype == torch.uint8:
            vals = vals.to(torch.float32) / 255.0
        return torch.where(inb[..., None], vals, torch.zeros_like(vals))

    v00 = gather(x0i, y0i)
    v01 = gather(x0i + 1, y0i)
    v10 = gather(x0i, y0i + 1)
    v11 = gather(x0i + 1, y0i + 1)
    return (v00 * ((1 - fx) * (1 - fy))[..., None] + v01 * (fx * (1 - fy))[..., None]
            + v10 * ((1 - fx) * fy)[..., None] + v11 * (fx * fy)[..., None])
