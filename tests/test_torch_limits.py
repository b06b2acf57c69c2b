"""The port's plain versions past the old limits of its kernels, against the
JAX package, on the CPU at tiny sizes. The JAX sampler, compositor and SDF
networks have no limit; the kernels now take every shape the JAX package
runs, and chip_smoke.py holds them against these plain versions on the
card (phase 3) and runs the demo configuration past the sampler's old
limits (phase 5e). Here:

  * K5, both modes: 8 rays, 1056 prepass samples (past 32 a lane), 128 +
    32 + 2 = 162 sorted samples (past the 128-slot sort), the JAX package's
    draws replayed (tests/_torch_draws.py); z_vals to 1e-5, apart from the
    u = 1 inverse-CDF sample of a ray, which lies in the ray's last prepass
    bin in both (tests/test_torch_ops.py);
  * K4: the composite at 600 samples (forward and the vjp of its four
    outputs, to test_torch_ops.py's tolerances) and the weights pass at
    1100 samples with a top-16 (the picks equal to lax.top_k's, values and
    the closed-form backward to 1e-5; torch flushes subnormals as XLA:CPU
    does, tests/test_torch_composite.py);
  * K6: the prepass density (2e-5 of the largest, the bound of
    test_torch_prepass.py) and the training forward (SDF, features and
    gradient to rtol 1e-4 with an atol of 1e-4 of the largest) of a
    20-layer network of 8 units (past 16 layers) and of one with a
    1040-unit layer (past 1024 units), with the general kernel's packing
    (column slices of a wide layer, a descriptor slot a layer) against the
    plain version;
  * the SLAM slice of tests/test_torch_slice.py with those sampler counts:
    one mapping iteration with BA and two tracking iterations, to that
    file's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu import config as jconfig
from nicer_slam_tpu.models import fields as jf
from nicer_slam_tpu.models import scene_model as jsm
from nicer_slam_tpu.ops import density as jdens
from nicer_slam_tpu.ops import ray_sampling as jrs
from nicer_slam_tpu_torch.config import parse_string
from nicer_slam_tpu_torch.models import fields as tf
from nicer_slam_tpu_torch.ops import ray_sampling as trs
from nicer_slam_tpu_torch.ops import sdf_density as sd
from nicer_slam_tpu_torch.ops import volume_rendering as tvr

import chip_smoke
from _torch_draws import render_draws
from test_torch_composite import _weights_pass_jax, flush_denormal
from test_torch_ops import ATOL, _blocked_cache, _composite_jax, _odd_sample_in_last_bin
from test_torch_slice import _map_step_case, _track_frame_case, scene  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
# the sampler counts past the kernel's old limits (1024 prepass samples, 128
# sorted)
NE, NS, NX = 1056, 128, 32


def _close(a, b, rtol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-4 * max(np.abs(b).max(), 1e-30))


def _smooth_volume(res):
    """A thin, smooth density: transmittance stays well above 0 to the far
    end of every ray, so the inverse CDF has no tie at u = 1."""
    g = np.linspace(-1, 1, res)
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    return (0.3 + 0.2 * np.cos(3 * gx) * np.cos(2 * gy) * np.cos(gz)).astype(np.float32)


@pytest.mark.parametrize("mode", ["cached", "given"])
def test_sampler_past_limits_matches_jax(mode):
    """K5's plain version at 1056 prepass and 162 sorted samples, the cached
    prepass (the density cache) and the given densities (the exact prepass:
    an analytic density at the replayed, jittered z)."""
    res, R = 16, 8
    kw = dict(N_samples=NS, N_samples_eval=NE, N_samples_extra=NX, prepass_cache_res=res)
    cfg_j = jrs.SamplerConfig(prepass_mode=mode if mode == "cached" else "exact", **kw)
    cfg_t = trs.SamplerConfig(prepass_mode=mode if mode == "cached" else "exact", **kw)
    assert cfg_t.total_samples == 162
    rng = np.random.default_rng(9)
    o = np.tile(np.array([[0.1, -0.05, -0.9]], np.float32), (R, 1))
    d = np.concatenate([rng.uniform(-0.4, 0.4, (R, 2)), np.ones((R, 1))], 1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    vol = _smooth_volume(res)
    blocked = jnp.asarray(_blocked_cache(vol))

    def dens_np(p):
        return 0.3 + 0.2 * jnp.cos(3 * p[:, 0]) * jnp.cos(2 * p[:, 1]) * jnp.cos(p[:, 2])

    key = jax.random.PRNGKey(3)
    k_sample = jax.random.split(key, 3)[0]
    density_fn = ((lambda s, p: jsm._density_cache_lookup(blocked, res, p)) if mode == "cached"
                  else (lambda s, p: dens_np(p)))
    z_j, e_j = jrs.importance_z_vals(cfg_j, jnp.asarray(o), jnp.asarray(d),
                                     lambda p: jnp.zeros(p.shape[0]), density_fn, k_sample,
                                     training=True)
    dr = render_draws(key, cfg_t, R, 1.0, is_mapping=False)
    z_pre, near, far = trs.uniform_z_vals(cfg_t, T(o), T(d), dr.t_rand)
    if mode == "cached":
        z_t, e_t = trs.importance_sample(cfg_t, T(o), T(d), T(vol.reshape(-1)), dr.t_rand,
                                         dr.perm, dr.eik_idx)
    else:
        p = sd.ray_points(T(o), T(d), z_pre)
        dens = (0.3 + 0.2 * torch.cos(3 * p[:, 0]) * torch.cos(2 * p[:, 1])
                * torch.cos(p[:, 2])).reshape(R, NE)
        z_t, e_t = trs.importance_sample_given(cfg_t, z_pre, near, far, dens, dr.perm,
                                               dr.eik_idx)
    z_j, e_j, z_t, e_t = np.asarray(z_j), np.asarray(e_j), z_t.numpy(), e_t.numpy()
    assert z_t.shape == z_j.shape == (R, 162)
    assert (np.diff(z_t, axis=1) >= 0).all()
    assert _odd_sample_in_last_bin(z_t, z_j, z_pre.numpy(), 1e-5).all()
    exact = np.abs(z_t - z_j).max(1) <= 1e-5
    assert exact.mean() >= 0.5
    np.testing.assert_allclose(e_t[exact], e_j[exact], atol=1e-5, rtol=0)


def test_composite_past_limits_matches_jax():
    """K4's plain composite at 600 samples a ray (past the forward kernel's
    old 512): values and the vjp of all four outputs."""
    rng = np.random.default_rng(12)
    R, S = 4, 600
    z = np.sort(rng.uniform(0.1, 3.0, (R, S)), 1).astype(np.float32)
    dens = rng.uniform(0, 3, (R, S)).astype(np.float32)
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    nrm = rng.standard_normal((R, S, 3)).astype(np.float32)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((R, S), (R, 3), (R, 1), (R, 3))]
    outs_j, vjp = jax.vjp(lambda d, c, n: _composite_jax(jnp.asarray(z), d, c, n),
                          jnp.asarray(dens), jnp.asarray(rgb), jnp.asarray(nrm))
    grads_j = vjp(tuple(jnp.asarray(c) for c in cots))
    ins = [T(a).requires_grad_(True) for a in (dens, rgb, nrm)]
    outs_t = tvr.composite(T(z), *ins)
    grads_t = torch.autograd.grad(outs_t, ins, [T(c) for c in cots])
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=1e-5)


def test_weights_topk_past_limits_matches_jax():
    """K4's weights pass at 1100 samples a ray, top-16 (past the kernel's old
    1024): the picks are lax.top_k's, the values and the closed-form
    backward JAX's."""
    rng = np.random.default_rng(13)
    R, S, Kc = 4, 1100, 16
    z = np.sort(rng.uniform(0.1, 3.0, (R, S)), 1).astype(np.float32)
    dens = rng.uniform(0, 2, (R, S)).astype(np.float32)
    nrm = rng.standard_normal((R, S, 3)).astype(np.float32)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((R, S), (R, 1), (R, 3), (R, Kc), (R, 1))]
    tvr.check_weights_topk_shape(S, Kc)
    outs_j, idx_j = _weights_pass_jax(jnp.asarray(z), jnp.asarray(dens), jnp.asarray(nrm), Kc)
    _, vjp = jax.vjp(lambda d, n: _weights_pass_jax(jnp.asarray(z), d, n, Kc)[0],
                     jnp.asarray(dens), jnp.asarray(nrm))
    g_j = vjp(tuple(jnp.asarray(c) for c in cots))
    with flush_denormal():
        outs = tvr.weights_topk(T(z), T(dens), T(nrm), Kc)
        g_t = tvr.weights_topk_bwd_plain(T(z), T(dens), T(nrm), outs[5], *map(T, cots))
    np.testing.assert_array_equal((outs[5] - torch.arange(R)[:, None] * S).numpy(),
                                  np.asarray(idx_j))
    for a, b in zip(outs[:5], outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


# the SDF networks past the general kernel's old limits: chip_smoke.py's
# tiny-port networks with a fine network of 20 layers of 8 units, or with a
# 1040-unit layer
FINE_DIMS = {"deep-20": " ".join(["8"] * 19), "wide-1040": "1040 32"}


def _nets(which):
    """(port net, JAX params, JAX CombineConfig): the same weights in both
    packages, tables U(-0.05, 0.05)."""
    fvs, text = chip_smoke.GENERAL_NETS["tiny-port"]
    text = text.replace("d_in = 3  d_out = 1  dims = [ 16 16 ]",
                        f"d_in = 3  d_out = 1  dims = [ {FINE_DIMS[which]} ]")
    text = f"implicit_network {{{text}\n}}"
    tcfg = tf.combine_config_from_conf(parse_string(text).get_config("implicit_network"), fvs)
    jcfg = jf.combine_config_from_conf(
        jconfig.parse_string(text).get_config("implicit_network"), fvs)
    net = tf.CombineNet(tcfg, np.random.default_rng(0))
    jparams = jf.init_combine(np.random.default_rng(0), jcfg)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name in ("coarse", "fine"):
            enc = getattr(net, name).encoding
            enc.copy_(torch.rand(enc.shape, generator=g) * 0.1 - 0.05)
            jparams[name]["encoding"] = jnp.asarray(enc.numpy().T)
    return net, jparams, jcfg


@pytest.mark.parametrize("which", list(FINE_DIMS))
def test_sdf_networks_past_limits_match_jax(which):
    """The general K6's network (the selector takes it, the packer lays it
    out: a descriptor slot a layer, a wide layer's column slices) and the
    plain prepass density and training forward against the JAX package."""
    net, jparams, jcfg = _nets(which)
    assert sd.check_sdf_network(net.cfg) == "general"
    assert len(net.fine.lins) == (20 if which == "deep-20" else 3)
    rng = np.random.default_rng(14)
    x = rng.uniform(-1.0, 1.0, (300, 3)).astype(np.float32)
    vox = rng.integers(0, 50, (64, 64, 64)).astype(np.float32)
    # the general kernel's packing, reproduced on the CPU
    tables = sd.pack_sdf(net).tables
    flat, desc = sd.pack_general(net)
    assert desc.shape == (2, sd.desc_ints(max(sd.MAX_LAYERS, len(net.fine.lins))))
    want = sd.sdf_plain(net, tables, T(x))
    got = sd.sdf_general_reference(net, tables, flat, desc, T(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    # the prepass density
    sdf_j = jf.combine_sdf_packed(jcfg, jparams, jf.pack_combine_tables(jcfg, jparams),
                                  jnp.asarray(x), "fine")
    dens_j = np.asarray(jdens.laplace_density(
        sdf_j[:, None], jdens.grid_predefined_beta(jnp.asarray(vox), jnp.asarray(x), 64))[:, 0])
    dens_t = sd.sdf_density_plain(net, tables, T(x), T(vox)).numpy()
    np.testing.assert_allclose(dens_t, dens_j, rtol=0, atol=2e-5 * np.abs(dens_j).max())
    # the training forward: SDF, features and the SDF's gradient
    out_j = jf.combine_get_outputs(jcfg, jparams, jnp.asarray(x), "fine")
    with torch.no_grad():
        out_t = tf.combine_get_outputs(net, T(x), "fine")
    for a, b in zip(out_t, out_j):
        _close(a, b)


def test_check_sdf_network_takes_any_depth_and_width():
    """The selector raises only where the JAX package cannot run the network
    either: 20 layers, and a 1040-unit layer, take the general kernel."""
    for which in FINE_DIMS:
        assert sd.check_sdf_network(_nets(which)[0].cfg) == "general"
    assert sd.slice_widths(1040) == [512, 512, 16]
    assert sd.slice_widths(1024) == [1024]
    assert sd.desc_cap(_nets("deep-20")[0].cfg) == 20


def test_slam_slice_past_limits_matches_jax(scene):  # noqa: F811
    """tests/test_torch_slice.py's mapping iteration (BA, flow, warp) and two
    tracking iterations with N_samples_eval 1056, N_samples 128 and
    N_samples_extra 32, on the scene's smooth prepass cache. A ray sums 162
    samples (20 there), so the SDF-side gradients carry more float32
    rounding in both packages: measured, the coarse network's last bias is
    7.2e-4 (port) and 7.3e-4 (JAX package) from the port's float64 run
    (relative L2; 1.5e-3 between the two), where that file bounds the port
    at 5e-4; here the port is held to 1e-3, the rest as there."""
    s = dict(scene)
    for k in ("jcfg", "tcfg"):
        c = scene[k]
        s[k] = c._replace(sampler=c.sampler._replace(N_samples=NS, N_samples_eval=NE,
                                                     N_samples_extra=NX))
    _map_step_case(s, color_topk=0, sdf_rel_l2=(1e-3, 2e-3))
    _track_frame_case(s, color_topk=0, num_iters=2)
