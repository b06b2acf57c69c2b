"""Parity of the torch port's field networks with the JAX package's, on the
CPU, on the same weights (one numpy init stream, and the checkpoint
converters): SDF outputs and analytic normals, the color network in both
color stages, the gradient of an eikonal + normal-fed rgb loss with respect
to every parameter (the second-order path: the loss differentiates the SDF
gradient), and the prepass density cache.

Tolerances: values and gradients rtol 1e-4 with an atol of 1e-4 of the
largest magnitude of the compared array — float32 through MLPs, double
backward and hash gathers summed in different orders. The density cache,
built from bf16-packed tables in both packages, against the JAX package's
own cache: 2e-5 of the largest density (float32 rounding: see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu.models import fields as jf
from nicer_slam_tpu.models import scene_model as jsm
from nicer_slam_tpu.slam.checkpoint import _flatten_pytree, _unflatten_into
from nicer_slam_tpu_torch.models import fields as tf
from nicer_slam_tpu_torch.models import scene_model as tsm
from nicer_slam_tpu_torch.slam.checkpoint import params_from_numpy, params_to_numpy

import _torch_tiny

T = torch.from_numpy


def _close(a, b, rtol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = 1e-4 * max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, _, _ = _torch_tiny.configs()
    jparams, model = _torch_tiny.models(jcfg, tcfg)
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.9, 0.9, (96, 3)).astype(np.float32)
    x[:3] *= 1.2                      # some points outside the unit cube
    return jcfg, tcfg, jparams, model, x


def test_same_seed_same_weights_and_converters(setup):
    _, tcfg, jparams, model, _ = setup
    flat_j = _flatten_pytree(jparams)
    flat_t = params_to_numpy(model)
    assert sorted(flat_j) == sorted(flat_t)
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
    # JAX params -> a differently-seeded port model, and back into the JAX tree
    other = tsm.SceneModel(tcfg, np.random.default_rng(9))
    params_from_numpy({"model_state_dict/" + k: v for k, v in flat_j.items()}, other)
    back = _unflatten_into(jparams, params_to_numpy(other))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="mismatch"):
        params_from_numpy({k: v for k, v in list(flat_j.items())[1:]}, other)


@pytest.mark.parametrize("stage", ["fine", "coarse"])
def test_combine_get_outputs(setup, stage):
    jcfg, _, jparams, model, x = setup
    sdf_j, feat_j, grad_j = jf.combine_get_outputs(jcfg.combine, jparams["implicit"],
                                                   jnp.asarray(x), stage)
    with torch.no_grad():
        sdf_t, feat_t, grad_t = tf.combine_get_outputs(model.implicit, T(x), stage)
        sdf_only = tf.combine_sdf(model.implicit, T(x), stage)
    _close(sdf_t, sdf_j)
    _close(feat_t, feat_j)
    _close(grad_t, grad_j)
    _close(sdf_only, sdf_j)


@pytest.mark.parametrize("color_stage", ["base", "highfreq"])
def test_rendering_forward(setup, color_stage):
    jcfg, _, jparams, model, x = setup
    rng = np.random.default_rng(2)
    n = rng.standard_normal(x.shape).astype(np.float32)
    v = rng.standard_normal(x.shape).astype(np.float32)
    f = rng.standard_normal((x.shape[0], jcfg.render.feature_vector_size)).astype(np.float32)
    out_j = jf.rendering_forward(jcfg.render, jparams["render"], *map(jnp.asarray, (x, n, v, f)),
                                 color_stage=color_stage)
    with torch.no_grad():
        out_t = tf.rendering_forward(model.render, *map(T, (x, n, v, f)), color_stage)
    _close(out_t, out_j)


def _loss_jax(jcfg, params, x, dirs, target, color_stage):
    sdf, feat, g = jf.combine_get_outputs(jcfg.combine, params["implicit"], x, "fine")
    rgb = jf.rendering_forward(jcfg.render, params["render"], x, g, dirs, feat,
                               color_stage=color_stage)
    eik = ((jnp.linalg.norm(g, axis=1) - 1.0) ** 2).mean()
    return eik + jnp.abs(rgb - target).mean() + (sdf ** 2).mean()


def _loss_torch(model, x, dirs, target, color_stage):
    sdf, feat, g = tf.combine_get_outputs(model.implicit, x, "fine")
    rgb = tf.rendering_forward(model.render, x, g, dirs, feat, color_stage)
    eik = ((g.norm(dim=1) - 1.0) ** 2).mean()
    return eik + (rgb - target).abs().mean() + (sdf ** 2).mean()


@pytest.mark.parametrize("color_stage", ["base", "highfreq"])
def test_second_order_gradients_match(setup, color_stage):
    """d(loss)/d(every parameter) where the loss reads the SDF gradient:
    grid tables through K1's backward, MLPs through the double backward."""
    jcfg, _, jparams, model, x = setup
    rng = np.random.default_rng(3)
    dirs = rng.standard_normal(x.shape).astype(np.float32)
    target = rng.uniform(0, 1, x.shape).astype(np.float32)
    g_j = jax.grad(lambda p: _loss_jax(jcfg, p, jnp.asarray(x), jnp.asarray(dirs),
                                       jnp.asarray(target), color_stage))(jparams)
    model.zero_grad(set_to_none=True)
    _loss_torch(model, T(x), T(dirs), T(target), color_stage).backward()
    flat_j = _flatten_pytree(g_j)
    for name, p in model.named_parameters():
        key = name.replace(".", "/")
        if p.grad is None:       # detached color grid in the base stage
            assert color_stage == "base" and key == "render/encoding"
            assert not np.any(flat_j[key])
            continue
        _close(p.grad.numpy(), flat_j[key])


def test_density_cache_matches_fp32_and_bf16_references(setup):
    jcfg, tcfg, jparams, model, _ = setup
    rng = np.random.default_rng(4)
    vox = rng.integers(0, 50, (16, 16, 16)).astype(np.float32)
    cache_t = tsm.build_density_cache(tcfg, model, T(vox)).numpy()
    res = tcfg.sampler.prepass_cache_res
    assert cache_t.shape == (res ** 3,)
    # the JAX package's own cache (bf16-packed tables), column 0 = the corner
    # itself. Both read the same bf16 table values (the K3 features are
    # equal bit for bit); the MLPs' float32 rounding leaves the SDF a few ulp
    # apart (~5e-7 at |sdf| ~ 1.2), which the Laplace density's slope at
    # the surface, 1/(2β²) ~ 2.4e3, turns into ~1.6e-5 of the largest
    # density (1/β ~ 69).
    blocked = np.asarray(jsm.build_density_cache(jcfg, jparams, jnp.asarray(vox)))[:, 0]
    scale = np.abs(blocked).max()
    np.testing.assert_allclose(cache_t, blocked, rtol=0, atol=2e-5 * scale)
    # the fp32 reference: the JAX combine_sdf on the same linspace grid +
    # density. The port's bf16 cache may differ from it by the bf16 rounding
    # of the tables, as the JAX package's bf16 cache does, and no more.
    xs = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    sdf = jf.combine_sdf(jcfg.combine, jparams["implicit"], jnp.asarray(grid), "fine")[:, 0]
    dens_j = np.asarray(jsm._density(jcfg, jparams, jnp.asarray(vox), sdf, jnp.asarray(grid)))
    bf16_effect = np.abs(blocked - dens_j).max()
    assert np.abs(cache_t - dens_j).max() <= bf16_effect + 2e-5 * scale
