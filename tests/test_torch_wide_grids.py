"""K1/K2/K3 beyond 32 levels or 8 channels, on the CPU: the port's plain
versions (what the wrappers run for a CPU tensor) against the JAX
package's ``hash_encode_with_grad`` / ``hash_encode`` /
``hash_encode_packed`` at L40 x C2, L16 x C16 and L8 x C12, values, the
input gradient and the table gradient (through ``jax_layout``), under the
tolerances of tests/test_torch_hash_encoder.py; the wrappers' spec check
at those shapes; and one exact-prepass map_step of a shrunk model with
wide grids (the coarse SDF grid 16 levels x 16 channels, the fine one 40
levels, the colour grid 40 levels) against the JAX package's.

The colour grid's channel count is 2 in both packages (its conf has no
level_dim), so the 16-channel grid of the map_step case is an SDF grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu import config as jconfig
from nicer_slam_tpu.models import scene_model as jsm
from nicer_slam_tpu.ops import hash_encoder as jhe
from nicer_slam_tpu_torch.models import scene_model as tsm
from nicer_slam_tpu_torch.ops import hash_encoder as the

import _torch_tiny
from test_torch_options import BETA_SCALE, H, N_IMAGES, RAY_CHUNK, W
from test_torch_slice import _map_step_case, scene  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

WIDE = [(40, 2), (16, 16), (8, 12)]


def _spec_kwargs(L, C):
    return dict(input_dim=3, num_levels=L, level_dim=C, base_resolution=4,
                log2_hashmap_size=9, desired_resolution=64)


def _case(L, C, seed, n=300):
    rng = np.random.default_rng(seed)
    tspec, jspec = the.make_spec(**_spec_kwargs(L, C)), jhe.make_spec(**_spec_kwargs(L, C))
    table = rng.uniform(-1, 1, (C, tspec.total_entries)).astype(np.float32)   # JAX [C, T]
    x = rng.uniform(-1.05, 1.05, (n, 3)).astype(np.float32)
    gf = rng.normal(size=(n, L * C)).astype(np.float32)
    gd = rng.normal(size=(n, L * C, 3)).astype(np.float32)
    return tspec, jspec, table, x, gf, gd


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("L,C", WIDE)
def test_wide_k1_matches_jax(L, C):
    """K1: features, Jacobian, grad_x and the table gradient."""
    tspec, jspec, table, x, gf, gd = _case(L, C, L * 100 + C)

    def jloss(tab, xx):
        f, d = jhe.hash_encode_with_grad(jspec, tab, xx)
        return (f * gf).sum() + (d * gd).sum(), (f, d)

    (_, (jf, jd)), (jgt, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(table), jnp.asarray(x))
    tt = torch.from_numpy(np.ascontiguousarray(table.T)).requires_grad_(True)
    xx = torch.from_numpy(x).requires_grad_(True)
    f, d = the.hash_encode_with_grad(tspec, tt, xx)
    ((f * torch.from_numpy(gf)).sum() + (d * torch.from_numpy(gd)).sum()).backward()
    _close(f.detach(), jf, 1e-5)
    _close(d.detach(), jd, 1e-5)
    _close(xx.grad, jgx, 1e-4)
    _close(tt.grad.T, jgt, 1e-5)


@pytest.mark.parametrize("L,C", WIDE)
def test_wide_k2_matches_jax(L, C):
    """K2: features, grad_x and the table gradient."""
    tspec, jspec, table, x, gf, _ = _case(L, C, L * 100 + C + 1)

    def jloss(tab, xx):
        f = jhe.hash_encode(jspec, tab, xx)
        return (f * gf).sum(), f

    (_, jf), (jgt, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(table), jnp.asarray(x))
    tt = torch.from_numpy(np.ascontiguousarray(table.T)).requires_grad_(True)
    xx = torch.from_numpy(x).requires_grad_(True)
    f = the.hash_encode(tspec, tt, xx)
    (f * torch.from_numpy(gf)).sum().backward()
    _close(f.detach(), jf, 1e-5)
    _close(xx.grad, jgx, 1e-4)
    _close(tt.grad.T, jgt, 1e-5)


@pytest.mark.parametrize("L,C", WIDE)
def test_wide_k3_matches_jax(L, C):
    """K3: the bf16 encode of the packed table."""
    tspec, jspec, table, x, _, _ = _case(L, C, L * 100 + C + 2)
    jf = jhe.hash_encode_packed(jspec, jhe.pack_table_bf16_pairs(jnp.asarray(table)),
                                jnp.asarray(x))
    packed = the.pack_table_bf16(torch.from_numpy(np.ascontiguousarray(table.T)))
    _close(the.hash_encode_bf16(tspec, packed, torch.from_numpy(x)), jf, 1e-5)


@pytest.mark.parametrize("L,C", WIDE)
def test_wide_specs_pass_the_kernel_check(L, C):
    the._check_spec(the.make_spec(**_spec_kwargs(L, C)))
    the._check_spec(the.make_spec(**_spec_kwargs(L, C)), bf16=True)


@pytest.mark.parametrize("kw,bf16", [(dict(input_dim=2), False), (dict(level_dim=5), True)])
def test_kernel_check_still_refuses(kw, bf16):
    """Where the JAX package refuses too: other than 3 inputs, and an odd C
    for the packed (bf16) encode."""
    spec = the.make_spec(**{**_spec_kwargs(40, 2), **kw})
    with pytest.raises(ValueError, match="kernel supports"):
        the._check_spec(spec, bf16=bf16)


# the shrunk model of tests/_torch_tiny.py with wide grids and the exact
# prepass: the coarse SDF grid 16 levels x 16 channels, the fine one 40
# levels x 2 channels, the colour grid 40 levels
WIDE_EDITS = (("num_levels = 2  level_dim = 8", "num_levels = 16  level_dim = 16"),
              ("num_levels = 3  level_dim = 4", "num_levels = 40  level_dim = 2"),
              ("color_num_levels = 3", "color_num_levels = 40"),
              ("prepass_mode = cached", f"prepass_ray_chunk = {RAY_CHUNK}"))


def wide_configs():
    text = _torch_tiny.MODEL_CONF
    for a, b in WIDE_EDITS:
        assert a in text
        text = text.replace(a, b)
    c = jconfig.parse_string(text).get_config("model")
    return (jsm.scene_config_from_conf(c, (H, W), N_IMAGES),
            tsm.scene_config_from_conf(c, (H, W), N_IMAGES))


def test_wide_grid_exact_map_step_matches_jax(scene):  # noqa: F811
    """test_torch_slice's map_step with BA on the wide-grid model, the
    exact prepass (chunked) widened by test_torch_options's β scale, the
    monocular depth term off as in test_torch_options_slam's exact case."""
    jcfg, tcfg = wide_configs()
    assert tcfg.combine.coarse.hash_spec().level_dim == 16
    assert tcfg.combine.fine.hash_spec().num_levels == 40
    assert tcfg.render.hash_spec().num_levels == 40
    _map_step_case(scene, color_topk=0, cfgs=(jcfg, tcfg),
                   loss_edits=dict(depth_weight=0.0), beta_scale=BETA_SCALE)
