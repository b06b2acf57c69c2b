"""Scene model: the per-ray-batch forward pass (counterpart of
nicer_slam_tpu/models/scene_model.py).

Rays live in one flat ``[R]`` batch with a per-ray keyframe-slot id. The
path: rays -> importance sampler (K5, reading the cached ``[res³]`` prepass
density; an eval render without a cache takes the exact prepass, the SDF
network through K3 at every prepass sample) -> coarse+fine SDF with
analytic normals (K1) -> Laplace density with the voxel-counter β (K7) ->
per-ray composite (K4; in training with ``color_topk`` the weights pass
picks the top-k samples and the color network, K2 on the color grid, runs
only there) -> flow over the keyframe edge graph, photometric warp at
patch size 1, eikonal points, the camera-space normal map and the SDF at
the cameras.

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
from ..ops.ray_sampling import (SamplerConfig, importance_sample,
                                 importance_sample_given, uniform_z_vals)
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
        prepass_mode=rs.get_string("prepass_mode", "exact"),
        prepass_cache_res=rs.get_int("prepass_cache_res", 128),
    )
    if sampler.prepass_mode != "cached":
        raise NotImplementedError(
            f"prepass_mode {sampler.prepass_mode!r}: training with the exact "
            f"prepass is not ported (set model.ray_sampler.prepass_mode = "
            f"cached; eval renders take the exact prepass either way)")
    patchsizes = tuple(int(p) for p in model_conf.get_list("mapping_patchsizes", [1]))
    if patchsizes != (1,):
        raise NotImplementedError(f"warp patch sizes {patchsizes}: only (1,) is ported")
    return SceneConfig(
        combine=fields.combine_config_from_conf(
            model_conf.get_config("implicit_network"), fvs),
        render=fields.rendering_config_from_conf(
            model_conf.get_config("rendering_network"), fvs),
        sampler=sampler,
        density_method=model_conf.get_string("density_method", "volsdf_gridpredefined"),
        scene_bounding_sphere=model_conf.get_float("scene_bounding_sphere", 1.0),
        voxel_res=model_conf.get_int("voxel_res", 64),
        white_bkgd=model_conf.get_bool("white_bkgd", False),
        use_warp_loss=model_conf.get_bool("use_warp_loss", False),
        H=int(img_res[0]),
        W=int(img_res[1]),
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


def _density(cfg: SceneConfig, model: SceneModel, voxels, sdf_flat, pts_flat,
             beta_scale=None):
    if cfg.density_method == "volsdf_laplace":
        beta = density_ops.learned_beta(model.density["beta"])
        if beta_scale is not None:
            beta = beta * beta_scale
        return density_ops.laplace_density(sdf_flat, beta)
    beta = density_ops.grid_predefined_beta(voxels, pts_flat, cfg.voxel_res)
    if beta_scale is not None:
        beta = beta * beta_scale
    return density_ops.laplace_density(sdf_flat[:, None], beta)[:, 0]


@torch.no_grad()
def build_density_cache(cfg: SceneConfig, model: SceneModel,
                        voxels: torch.Tensor, n_chunks: int = 16) -> torch.Tensor:
    """Prepass density volume [res³] on the uniform linspace(-1, 1, res)
    grid, flat index (x·res + y)·res + z: the SDF from the bf16-packed
    coarse and fine tables (K3), as the JAX package builds it, plus the
    voxel-counter β (K7). The sampler (K5) reads it trilinearly; the runner
    refreshes it. The JAX package's [res³, 8] cell-blocked layout holds the
    same values: its reads clip the cell to res - 2, so they never wrap."""
    res = cfg.sampler.prepass_cache_res
    dev = voxels.device
    xs = torch.linspace(-1.0, 1.0, res, dtype=torch.float32, device=dev)
    grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    packed = fields.pack_combine_tables(model.implicit)
    out = []
    for pts in grid.chunk(n_chunks):
        pts = pts.contiguous()
        sdf = fields.combine_sdf_packed(model.implicit, packed, pts, "fine")
        out.append(_density(cfg, model, voxels, sdf, pts))
    return torch.cat(out)


@torch.no_grad()
def _exact_prepass(cfg: SceneConfig, model: SceneModel, voxels: torch.Tensor,
                   packed_tables: Dict[str, torch.Tensor], cam_loc: torch.Tensor,
                   ray_dirs: torch.Tensor, perm: torch.Tensor, eik_idx: torch.Tensor,
                   beta_scale=None):
    """The exact prepass of an eval render (scene_model.py:246-287 with
    ray_sampling.py:112-163, training=False): the SDF network from the
    bf16-packed tables (K3) and the voxel β (K7) at the 640 unjittered z of
    every ray, then K5 on those densities."""
    sc = cfg.sampler
    R = cam_loc.shape[0]
    z, _, _ = uniform_z_vals(sc, cam_loc, ray_dirs, None)
    pts = (cam_loc[:, None, :] + z[..., None] * ray_dirs[:, None, :]).reshape(-1, 3)
    sdf = fields.combine_sdf_packed(model.implicit, packed_tables, pts, "fine")
    density = _density(cfg, model, voxels, sdf, pts, beta_scale)
    return importance_sample_given(sc, z, density.reshape(R, sc.N_samples_eval),
                                   perm, eik_idx)


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
    perm: torch.Tensor                          # [N_extra] int64 bins
    eik_idx: torch.Tensor                       # [R] int64 in [0, S)
    eik_uniform: Optional[torch.Tensor] = None  # [10R, 3] in [-b, b)
    eik_nei: Optional[torch.Tensor] = None      # [11R, 3] in [0,1)


def make_render_draws(cfg: SceneConfig, R: int, gen: torch.Generator,
                      device, is_mapping: bool) -> RenderDraws:
    sc = cfg.sampler
    t_rand = torch.rand((R, sc.N_samples_eval), generator=gen, device=device)
    perm = torch.randperm(sc.N_samples_eval, generator=gen,
                          device=device)[:sc.N_samples_extra]
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
                density_cache: Optional[torch.Tensor] = None,
                packed_tables: Optional[Dict[str, torch.Tensor]] = None,
                beta_scale: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Forward pass over a flat ray batch. With ``is_mapping`` the output
    also holds the updated voxel counter (``voxels``) and the eikonal
    gradients (``grad_theta``, ``grad_theta_nei``). Without a
    ``density_cache`` the prepass is exact (eval renders only) and reads
    ``packed_tables``, the caller's ``fields.pack_combine_tables`` of the
    model, packed once for all the chunks of a render."""
    if density_cache is None and training:
        raise NotImplementedError(
            "training with the exact prepass is not ported: pass the density cache")
    if density_cache is None and packed_tables is None:
        raise ValueError("the exact prepass reads packed_tables "
                         "(fields.pack_combine_tables of the model)")
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
    if density_cache is None:
        z_vals, z_eik = _exact_prepass(cfg, model, voxels, packed_tables, cam_loc.detach(),
                                       ray_dirs.detach(), perm, draws.eik_idx, beta_scale)
    else:
        z_vals, z_eik = importance_sample(
            cfg.sampler, cam_loc, ray_dirs, density_cache,
            draws.t_rand if training else None, perm, draws.eik_idx)
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
    Kc = cfg.color_topk
    if training and 0 < Kc < S:
        # color only at the Kc samples of largest weight (scene_model.py:
        # 323-353); gradients reach the kept weights and the weight sum
        weights, depth_values, normal_comp, topk_w, wsum, picks = weights_topk(
            z_vals, density, normals, Kc)
        flat_i = picks.reshape(-1)
        rgb_k = fields.rendering_forward(
            model.render, points_flat[flat_i], gradients[flat_i], dirs_flat[flat_i],
            feature_vectors[flat_i], color_stage)
        rgb_values = topk_rgb(topk_w, wsum, rgb_k.reshape(R, Kc, 3))
    else:
        rgb_flat = fields.rendering_forward(model.render, points_flat, gradients,
                                            dirs_flat, feature_vectors, color_stage)
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

    # ---- warp at patch size 1 (network.py:167-279)
    if cfg.use_warp_loss and is_mapping and full_rgb is not None:
        w2c_all = torch.linalg.inv(batch.poses)
        cam_pts = (torch.einsum("sij,nj->sni", w2c_all[:, :3, :3], surf_points)
                   + w2c_all[:, None, :3, 3])
        pix_p = torch.einsum("sij,snj->sni", batch.intrinsics[:, :3, :3], cam_pts)
        tgt_uv = pix_p[..., :2] / (pix_p[..., 2:] + 1e-8)                # [S,R,2]
        tgt_depth = pix_p[..., 2]
        sx = tgt_uv[..., 0] * (cfg.W - 1) / cfg.W
        sy = tgt_uv[..., 1] * (cfg.H - 1) / cfg.H
        sampled = _bilinear_sample_images(full_rgb, sx, sy, cfg.H, cfg.W)
        nu = tgt_uv[..., 0] / cfg.W * 2 - 1
        nv = tgt_uv[..., 1] / cfg.H * 2 - 1
        in_bounds = ((nu > -1) & (nu < 1) & (nv > -1) & (nv < 1)
                     & (tgt_depth > 0))[..., None]                       # [S,R,1]
        iu = batch.uv[:, 0].to(torch.int64)
        iv = batch.uv[:, 1].to(torch.int64)
        inb_gt = (iu >= 0) & (iu < cfg.W) & (iv >= 0) & (iv < cfg.H)     # [R]
        pix_idx = iv.clamp(0, cfg.H - 1) * cfg.W + iu.clamp(0, cfg.W - 1)
        gt_rgb = full_rgb[batch.kf_slot, pix_idx]
        if gt_rgb.dtype == torch.uint8:
            gt_rgb = gt_rgb.to(torch.float32) / 255.0
        gt_rgb = torch.where(inb_gt[:, None], gt_rgb, torch.ones_like(gt_rgb))
        mask = (in_bounds & inb_gt[None, :, None]
                & batch.slot_valid[:, None, None] & batch.ray_valid[None, :, None])
        out["warp_sampled_rgb_1"] = sampled.reshape(-1, R, 1, 3)
        out["warp_gt_rgb_1"] = gt_rgb[:, None, :]                        # [R,1,3]
        out["warp_mask_1"] = mask                                        # [S,R,1]

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
