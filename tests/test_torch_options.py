"""The model options of the torch port against the JAX package, on the CPU:
the rendering network's ten modes, per-image codes and exposure; the
gaussian-window SSIM warp loss; the exact prepass in training (jittered z,
the true near and far, the extra bins drawn per chunk of
``prepass_ray_chunk`` rays) with warp patches [1, 5] and exposure, through
``render_rays`` and through K5's given-density mode alone; and the
combinations that neither package runs.

Tolerances: the color network's outputs and gradients rtol 1e-4 with an
atol of 1e-4 of the largest entry of each compared array (float32 MLPs
summed in other orders, as tests/test_torch_fields.py); the SSIM loss rtol
1e-5 and its gradient as the network's; z samples 1e-5 (float32 scans in
another order), a ray allowed one sample off (the u = 1 inverse-CDF sample,
test_torch_ops.test_sample_cdf_matches_jax); render outputs rtol 1e-4 with
an atol of 1e-4 of the largest entry; masks and the voxel counter exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu import config as jconfig
from nicer_slam_tpu.models import fields as jf
from nicer_slam_tpu.models import losses as jl
from nicer_slam_tpu.models import scene_model as jsm
from nicer_slam_tpu.ops import density as jdens
from nicer_slam_tpu.ops import ray_sampling as jrs
from nicer_slam_tpu.slam.checkpoint import _flatten_pytree
from nicer_slam_tpu_torch.models import fields as tf
from nicer_slam_tpu_torch.models import losses as tl
from nicer_slam_tpu_torch.models import scene_model as tsm
from nicer_slam_tpu_torch.ops import density as tdens
from nicer_slam_tpu_torch.ops import ray_sampling as trs
from nicer_slam_tpu_torch.ops import sdf_density as sd
from nicer_slam_tpu_torch.slam.checkpoint import jax_layout

import _torch_draws
import _torch_tiny
from test_torch_ops import _match_all_but_one

T = torch.from_numpy


def _close(a, b, rtol=1e-4, rel_atol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rel_atol * max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# (a) the rendering network: ten modes, per-image codes, exposure
# ---------------------------------------------------------------------------

# (mode, d_in, multires_view, color grid, per_image_code, model_exposure):
# d_in counts the mode's points / view directions / normals (the view
# encoding adds its own width, so a mode without view directions runs with
# multires_view 0)
RENDER_CASES = [
    ("idr", 9, 4, True, False, False),
    ("idr_detach", 9, 4, False, False, False),
    ("idr_nopts", 6, 4, False, False, False),
    ("idr_nopts_detach", 6, 4, False, False, False),
    ("idr_nonormal", 6, 4, False, False, False),
    ("idr_noview", 6, 0, False, False, False),
    ("nerf", 3, 4, False, False, False),
    ("no_feature", 9, 4, False, False, False),
    ("no_feature_no_noraml", 6, 4, False, False, False),
    ("no_color", 9, 4, False, False, False),
    ("idr", 9, 4, True, True, False),
    ("idr", 9, 4, True, False, True),
]
N_IMAGES = 5


def _render_conf(mode, d_in, multires_view, grid, per_image, exposure):
    b = lambda v: "true" if v else "false"
    return jconfig.parse_string(f"""
        mode = "{mode}"  d_in = {d_in}  d_out = 3  dims = [ 16 16 ]
        weight_norm = true  multires_view = {multires_view}
        per_image_code = {b(per_image)}  model_exposure = {b(exposure)}
        use_grid_feature = {b(grid)}
        color_num_levels = 3  color_logmap = 10  color_desired_res = 64
    """)


def _case_id(c):
    return "-".join([c[0]] + [n for n, on in zip(("grid", "per_image_code", "model_exposure"),
                                                 c[3:]) if on])


@pytest.mark.parametrize("case", RENDER_CASES, ids=[_case_id(c) for c in RENDER_CASES])
def test_rendering_forward_matches_jax(case):
    """Outputs (both of exposure's) and the gradients of a random linear
    function of them with respect to every parameter and every input."""
    conf = _render_conf(*case)
    jcfg = jf.rendering_config_from_conf(conf, 8, n_images=N_IMAGES)
    tcfg = tf.rendering_config_from_conf(conf, 8, n_images=N_IMAGES)
    jparams = jf.init_rendering_net(np.random.default_rng(3), jcfg)
    net = tf.RenderingNet(tcfg, np.random.default_rng(3))
    flat_j = _flatten_pytree(jparams)
    flat_t = {n.replace(".", "/"): jax_layout(n, p) for n, p in net.named_parameters()}
    assert sorted(flat_j) == sorted(flat_t)
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
    if tcfg.model_exposure or tcfg.per_image_code:
        assert net.embeddings.shape == (N_IMAGES, 4 if tcfg.model_exposure else 32)

    rng = np.random.default_rng(4)
    N = 64
    x = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    n = rng.standard_normal((N, 3)).astype(np.float32)
    v = rng.standard_normal((N, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = rng.standard_normal((N, 8)).astype(np.float32)
    idx = rng.integers(0, N_IMAGES, N)
    cots = [rng.standard_normal((N, 3)).astype(np.float32) for _ in range(2)]

    def loss_j(p, *ins):
        out = jf.rendering_forward(jcfg, p, *ins, image_indices=jnp.asarray(idx, jnp.int32),
                                   color_stage="highfreq")
        outs = out if isinstance(out, tuple) else (out,)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    (_, outs_j), grads_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jparams, *map(jnp.asarray, (x, n, v, f)))
    ins = [T(a).requires_grad_(True) for a in (x, n, v, f)]
    out = tf.rendering_forward(net, *ins, "highfreq", image_indices=T(idx))
    outs_t = out if isinstance(out, tuple) else (out,)
    assert len(outs_t) == len(outs_j) == (2 if tcfg.model_exposure else 1)
    sum((o * T(c)).sum() for o, c in zip(outs_t, cots)).backward()
    for a, b in zip(outs_t, outs_j):
        _close(a.detach(), b)
    for t_in, g_j in zip(ins, grads_j[1:]):
        _close(np.zeros(t_in.shape) if t_in.grad is None else t_in.grad, g_j)
    g_flat = _flatten_pytree(grads_j[0])
    for name, p in net.named_parameters():
        key = name.replace(".", "/")
        g_t = np.zeros(flat_j[key].shape) if p.grad is None else jax_layout(key, p.grad)
        _close(g_t, g_flat[key])
    if tcfg.mode == "idr_detach":
        assert ins[1].grad is None            # the normals are detached
    if tcfg.per_image_code or tcfg.model_exposure:
        assert np.abs(g_flat["embeddings"]).max() > 0   # the codes reach the output


# ---------------------------------------------------------------------------
# (b) the gaussian-window SSIM warp loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ps", [3, 5, 7])
def test_gaussian_window_matches_jax(ps):
    np.testing.assert_allclose(tl._gaussian_window(ps).numpy(),
                               np.asarray(jl._gaussian_window(ps)), rtol=1e-6, atol=0)
    assert abs(float(tl._gaussian_window(ps).sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "patch_w"])
def test_warp_ssim_matches_jax(weighted):
    """Per-patch SSIM over 3 slots x 8 rays x 5² pixels, a random mask with
    one patch fully masked (SSIM 1, no loss), with and without a per-patch
    weight; the value and its gradient with respect to the warped colours."""
    rng = np.random.default_rng(7)
    S, R, ps = 3, 8, 5
    sampled = rng.uniform(0, 1, (S, R, ps * ps, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (R, ps * ps, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (S, R, ps * ps)) > 0.3
    mask[1, 2] = False
    pw = rng.uniform(0.2, 1.0, (S, R)).astype(np.float32) if weighted else None
    val_j, g_j = jax.value_and_grad(
        lambda a: jl.warp_ssim(a, jnp.asarray(gt), jnp.asarray(mask), ps,
                               patch_w=None if pw is None else jnp.asarray(pw)))(
        jnp.asarray(sampled))
    a = T(sampled).requires_grad_(True)
    val_t = tl.warp_ssim(a, T(gt), T(mask), ps, None if pw is None else T(pw))
    val_t.backward()
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-5)
    _close(a.grad, g_j)


# ---------------------------------------------------------------------------
# (c) the exact prepass in training through render_rays
# ---------------------------------------------------------------------------

H, W = 24, 32
# the prepass chunk of these tests (the shipped 1024 at CPU size): 32 rays
# in 4 chunks, each with its own extra bins
RAY_CHUNK, N_RAYS = 8, 32
# a β scale that widens the voxel β (0.0144 at count 0) to ~0.58: the
# prepass densities stay under ~2, transmittance stays well above 0 to the
# far end of every ray, and no ray's inverse CDF sits at the u = 1 tie
# (where the sample follows the last bit of the cdf's total: see
# test_torch_slice.py's cache). The β scale itself is the runner's warmup
# factor, which both the prepass and the main pass read.
BETA_SCALE = 40.0


def options_configs(patchsizes="1 5", exposure=True):
    """(jax SceneConfig, torch SceneConfig) of the shrunk model with the
    exact prepass chunked by RAY_CHUNK, warp patches and exposure."""
    text = (_torch_tiny.MODEL_CONF
            .replace("prepass_mode = cached", f"prepass_ray_chunk = {RAY_CHUNK}")
            .replace("mapping_patchsizes = [ 1 ]", f"mapping_patchsizes = [ {patchsizes} ]")
            .replace("per_image_code = false",
                     f"per_image_code = false  model_exposure = {str(exposure).lower()}"))
    c = jconfig.parse_string(text).get_config("model")
    return (jsm.scene_config_from_conf(c, (H, W), N_IMAGES),
            tsm.scene_config_from_conf(c, (H, W), N_IMAGES))


def _images(rng, S):
    """Smooth slot images [S, H*W, 3] uint8 and monocular depths [S, H*W]
    float16 with a step across the middle columns (patches across it fail
    the depth-variance test)."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rgb = np.stack([0.5 + 0.4 * np.sin(0.3 * xx + 0.2 * yy + s + np.array([0, 1, 2])[:, None, None])
                    for s in range(S)]).transpose(0, 2, 3, 1)
    depth = 0.5 + 0.002 * xx[None] + 0.3 * (xx[None] >= W // 2) + 0.01 * np.arange(S)[:, None, None]
    return ((rgb * 255).astype(np.uint8).reshape(S, H * W, 3),
            depth.astype(np.float16).reshape(S, H * W))


def _batch(rng, R, S=2):
    """R rays over S slots of cameras inside the unit cube looking along
    +z, the second slot shifted: (uv, slot, poses, intrinsics, frame ids)."""
    uv = np.stack([rng.uniform(0.5, W - 1.5, R), rng.uniform(0.5, H - 1.5, R)],
                  -1).astype(np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 28.0
    K[0, 2], K[1, 2] = W / 2, H / 2
    poses = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    poses[:, 2, 3] = -0.3
    poses[1, 0, 3] = 0.04
    return uv, (np.arange(R) % S), poses, np.tile(K, (S, 1, 1)), np.array([1, 3])


@pytest.mark.parametrize("color_topk", [0, 6], ids=["every-sample", "topk"])
def test_render_rays_exact_training_matches_jax(color_topk):
    """One training render (mapping) with the exact prepass chunked into 4
    chunks of 8 rays, each with its own extra bins (replayed from the JAX
    package's per-chunk keys), warp patches 1 and 5 with the depth-variance
    mask, exposure (rgb_un_values: K4's composite, or its top-k colour
    composite with colour top-6 of 20 samples), per-point frame ids 1 and
    3."""
    jcfg, tcfg = (c._replace(color_topk=color_topk) for c in options_configs())
    assert trs.prepass_chunks(tcfg.sampler, N_RAYS) == N_RAYS // RAY_CHUNK
    jparams, model = _torch_tiny.models(jcfg, tcfg)
    rng = np.random.default_rng(11)
    vox = rng.integers(0, 30, (16, 16, 16)).astype(np.float32)
    uv, slot, poses, intr, fids = _batch(rng, N_RAYS)
    rgb, depth = _images(rng, 2)
    key = jax.random.PRNGKey(3)
    jbatch = jsm.RayBatch(uv=jnp.asarray(uv), kf_slot=jnp.asarray(slot, jnp.int32),
                          poses=jnp.asarray(poses), intrinsics=jnp.asarray(intr),
                          frame_ids=jnp.asarray(fids, jnp.int32),
                          slot_valid=jnp.ones(2, bool), ray_valid=jnp.ones(N_RAYS, bool))
    out_j = jax.jit(lambda p, v, b, k, bs: jsm.render_rays(
        jcfg, p, v, b, k, stage="fine", color_stage="highfreq", training=True,
        is_mapping=True, full_rgb=jnp.asarray(rgb), full_depth=jnp.asarray(depth),
        beta_scale=bs))(jparams, jnp.asarray(vox), jbatch, key,
                        jnp.asarray(BETA_SCALE, jnp.float32))
    draws = _torch_draws.render_draws(key, tcfg.sampler, N_RAYS, 1.0, True)
    assert draws.perm.shape == (N_RAYS // RAY_CHUNK, tcfg.sampler.N_samples_extra)
    assert len({tuple(p.tolist()) for p in draws.perm}) > 1     # the chunks' own bins
    tbatch = tsm.RayBatch(uv=T(uv), kf_slot=T(slot), poses=T(poses), intrinsics=T(intr),
                          frame_ids=T(fids), slot_valid=torch.ones(2, dtype=torch.bool),
                          ray_valid=torch.ones(N_RAYS, dtype=torch.bool))
    out_t = tsm.render_rays(tcfg, model, T(vox), tbatch, draws, stage="fine",
                            color_stage="highfreq", training=True, is_mapping=True,
                            full_rgb=T(rgb), full_depth=T(depth),
                            sdf_pack=sd.pack_sdf(model.implicit),
                            beta_scale=torch.tensor(BETA_SCALE))
    z_t, z_j = out_t["z_vals"].numpy(), np.asarray(out_j["z_vals"])
    assert z_t.shape == z_j.shape == (N_RAYS, tcfg.sampler.total_samples)
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out_t["voxels"].numpy(), np.asarray(out_j["voxels"]))
    for k in ("rgb_values", "rgb_un_values", "depth_values", "normal_map", "sdf", "weights",
              "grad_theta", "grad_theta_nei", "cam_sdf"):
        _close(out_t[k].detach(), out_j[k])
    assert np.abs(np.asarray(out_j["rgb_un_values"] - out_j["rgb_values"])).max() > 0
    for ps in (1, 5):
        np.testing.assert_array_equal(out_t[f"warp_mask_{ps}"].numpy(),
                                      np.asarray(out_j[f"warp_mask_{ps}"]))
        for k in (f"warp_sampled_rgb_{ps}", f"warp_gt_rgb_{ps}"):
            _close(out_t[k].detach(), out_j[k])
    m5 = out_t["warp_mask_5"].numpy()
    assert m5.shape == (2, N_RAYS, 25) and 0 < m5.mean() < 1
    # the depth-variance mask drops whole patches across the depth step
    assert (~m5.any(axis=(0, 2))).any() and m5.any(axis=(0, 2)).any()
    # one perm for every ray (the cached prepass's draw) would place other
    # extras: the chunk rows are what the comparison holds
    z_one = tsm._exact_prepass(tcfg, model, T(vox), sd.pack_sdf(model.implicit),
                               *_rays(tcfg, tbatch), draws.t_rand, draws.perm[0],
                               draws.eik_idx, torch.tensor(BETA_SCALE))[0].numpy()
    assert np.abs(z_one - z_j).max() > 1e-3


def _rays(tcfg, batch):
    from nicer_slam_tpu_torch.utils.camera import rays_from_uv
    d, o, _ = rays_from_uv(batch.uv, batch.poses[batch.kf_slot],
                           batch.intrinsics[batch.kf_slot])
    return o, d


# ---------------------------------------------------------------------------
# (e) K5 given densities: jittered z, true near and far, per-chunk perms
# ---------------------------------------------------------------------------

def test_importance_sample_given_jittered_chunks_matches_jax():
    """The plain version of K5's given mode against the JAX package's
    importance_z_vals run chunk by chunk, each chunk with its own key (the
    training exact prepass): 32 rays in 4 chunks of 8, jittered z, near
    0.05 (so neither end of a jittered row is near or far), the Laplace
    density (β 0.2) of a sphere's SDF."""
    cfg_j = jrs.SamplerConfig(near=0.05, N_samples=16, N_samples_eval=64, N_samples_extra=8,
                              prepass_ray_chunk=RAY_CHUNK)
    cfg_t = trs.SamplerConfig(near=0.05, N_samples=16, N_samples_eval=64, N_samples_extra=8,
                              prepass_ray_chunk=RAY_CHUNK)
    rng = np.random.default_rng(5)
    R, beta = N_RAYS, 0.2
    o = np.tile(np.array([[0.0, 0.0, -0.95]], np.float32), (R, 1))
    d = np.concatenate([rng.uniform(-0.4, 0.4, (R, 2)), np.ones((R, 1))], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), R // RAY_CHUNK)
    z_j, e_j, draws = [], [], []
    for c, k in enumerate(keys):
        sl = slice(c * RAY_CHUNK, (c + 1) * RAY_CHUNK)
        zc, ec = jrs.importance_z_vals(
            cfg_j, jnp.asarray(o[sl]), jnp.asarray(d[sl]),
            lambda p: jnp.linalg.norm(p, axis=-1) - 0.5,
            lambda s, p: jdens.laplace_density(s, beta), k, training=True)
        z_j.append(np.asarray(zc))
        e_j.append(np.asarray(ec))
        draws.append(_torch_draws.sampler_draws(k, cfg_t, RAY_CHUNK))
    z_j, e_j = np.concatenate(z_j), np.concatenate(e_j)
    t_rand = torch.cat([dr[0] for dr in draws])
    perm = torch.stack([dr[1] for dr in draws])
    eik = torch.cat([dr[2] for dr in draws])
    z, near, far = trs.uniform_z_vals(cfg_t, T(o), T(d), t_rand)
    assert (z[:, :1] > near).all() and (z[:, -1:] < far).all()    # jitter moved the ends
    pts = (T(o)[:, None] + z[..., None] * T(d)[:, None]).reshape(-1, 3)
    dens = tdens.laplace_density(pts.norm(dim=-1) - 0.5, torch.tensor(beta)).reshape(R, -1)
    z_t, e_t = trs.importance_sample_given(cfg_t, z, near, far, dens, perm, eik)
    z_t, e_t = z_t.numpy(), e_t.numpy()
    assert z_t.shape == z_j.shape == (R, cfg_t.total_samples)
    assert _match_all_but_one(z_t, z_j, 1e-5).all()
    exact = np.abs(z_t - z_j).max(1) <= 1e-5
    assert exact.mean() > 0.5
    np.testing.assert_allclose(e_t[exact], e_j[exact], rtol=0, atol=1e-5)
    # near and far are in every row; z's ends are not
    assert (np.abs(z_t - near.numpy()).min(1) == 0).all()
    assert (np.abs(z_t - far.numpy()).min(1) == 0).all()
    # the shared perm of chunk 0 for every ray does not reproduce the rows
    z_one = trs.importance_sample_given(cfg_t, z, near, far, dens, perm[0], eik)[0].numpy()
    assert not _match_all_but_one(z_one, z_j, 1e-5).all()


# ---------------------------------------------------------------------------
# (g) what stays refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,per_image,exposure", [
    ("nerf", False, False), ("idr_nonormal", False, False), ("idr", True, True)],
    ids=["nerf-grid", "idr_nonormal-grid", "per_image_code-model_exposure"])
def test_combinations_the_jax_package_cannot_run_raise(mode, per_image, exposure):
    """A mode whose input leaves out the color grid, and per-image codes
    with exposure: a ValueError at config time in the port, a shape error
    in the JAX package's forward."""
    d_in = {"nerf": 3, "idr_nonormal": 6, "idr": 9}[mode]
    conf = _render_conf(mode, d_in, 4, True, per_image, exposure)
    with pytest.raises(ValueError, match="use_grid_feature|per_image_code"):
        tf.rendering_config_from_conf(conf, 8, n_images=N_IMAGES)
    jcfg = jf.rendering_config_from_conf(conf, 8, n_images=N_IMAGES)
    jparams = jf.init_rendering_net(np.random.default_rng(0), jcfg)
    x = jnp.zeros((4, 3))
    with pytest.raises(TypeError):
        jf.rendering_forward(jcfg, jparams, x, x, x, jnp.zeros((4, 8)),
                             image_indices=jnp.zeros(4, jnp.int32), color_stage="highfreq")


def test_concat_coarse_feature_stays_refused():
    text = _torch_tiny.MODEL_CONF.replace(
        "use_grid_feature = true\n            base_size = 8  end_size = 32",
        "use_grid_feature = true  concat_coarse_feature = true\n"
        "            base_size = 8  end_size = 32")
    assert "concat_coarse_feature = true" in text
    c = jconfig.parse_string(text).get_config("model")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsm.scene_config_from_conf(c, (H, W), N_IMAGES)
