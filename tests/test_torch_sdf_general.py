"""K6's selector and its general kernel's packer
(``nicer_slam_tpu_torch/ops/sdf_density.py``) over SDF networks that the
shipped kernel does not serve, on the CPU against the JAX package:

  * ``check_sdf_network`` names the variant of each network (chip_smoke.py's
    GENERAL_NETS: the JAX package's end-to-end test conf, the port's
    parity-test networks, one with skip_in, the fine clamp, divide_factor
    1.5, multires 0 and a 16 x 2 grid; one whose widths are no multiple of 8
    (coarse 20, fine 36 x 3 with skip_in [2], multires 2 and 1, a 3 x 6
    grid); one without grid features; the
    flagship's networks with an 8 x 256 fine network with skip_in [4], and
    with concat_coarse_feature) and raises only for networks the JAX package
    cannot run either;
  * the SDF computed from ``pack_general``'s weights and descriptor in the
    general kernel's row layout (``sdf_general_reference``: padding, the
    interleaved unit order, skip rows, dropped zero grid columns, the coarse
    feature rows of concat)
    reproduces the plain version ``sdf_plain`` within 1e-6 of the largest
    |SDF| in float32 (other summation orders) and 2e-6 in float64 (the
    plain version's float32 hidden layers);
  * the plain density at those networks' points is the JAX package's
    (``combine_sdf_packed``, or fp32 ``combine_sdf`` with concat, and the
    voxel β) within 2e-5 of the largest density, the bound of
    test_torch_prepass.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu import config as jconfig
from nicer_slam_tpu.models import fields as jf
from nicer_slam_tpu.ops import density as jdens
from nicer_slam_tpu_torch.config import parse_string
from nicer_slam_tpu_torch.models import fields as tf
from nicer_slam_tpu_torch.ops import sdf_density as sd

import chip_smoke
from _torch_threads import one_torch_thread  # noqa: F401



REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
DENSITY_RTOL = 2e-5

# network -> the variant the selector picks
NETS = {"tiny-jax": "general", "tiny-port": "general", "skip-clamp": "general",
        "odd-widths": "general", "no-grid": "general", "volsdf-8x256": "general",
        "concat": "concat", "shipped": "shipped"}


def _configs(which: str):
    """(port CombineConfig, JAX CombineConfig) of one network."""
    if which in chip_smoke.GENERAL_NETS or which == "no-grid":
        fvs, text = chip_smoke.GENERAL_NETS["tiny-port" if which == "no-grid" else which]
        if which == "no-grid":
            text = text.replace("use_grid_feature = true\n            base_size = 8  end_size = 8",
                                "use_grid_feature = false\n            base_size = 8  end_size = 8")
            assert "use_grid_feature = false" in text
        text = f"implicit_network {{{text}\n}}"
        return (tf.combine_config_from_conf(parse_string(text).get_config("implicit_network"),
                                            fvs),
                jf.combine_config_from_conf(
                    jconfig.parse_string(text).get_config("implicit_network"), fvs))
    c = jconfig.parse_file(os.path.join(REPO, "confs", "replica", "runconf_replica_2.conf"))
    m = c.get_config("model")
    t = tf.combine_config_from_conf(m.get_config("implicit_network"),
                                    m.get_int("feature_vector_size"))
    j = jf.combine_config_from_conf(m.get_config("implicit_network"),
                                    m.get_int("feature_vector_size"))
    edits = {"volsdf-8x256": dict(dims=(256,) * 8, skip_in=(4,), geometric_init=True,
                                  bias=0.6),
             "concat": dict(concat_coarse_feature=True), "shipped": {}}[which]
    return (t._replace(fine=t.fine._replace(**edits)),
            j._replace(fine=j.fine._replace(**edits)))


def _nets(which: str):
    """The same weights in both packages, tables U(-0.05, 0.05)."""
    tcfg, jcfg = _configs(which)
    net = tf.CombineNet(tcfg, np.random.default_rng(0))
    jparams = jf.init_combine(np.random.default_rng(0), jcfg)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name in ("coarse", "fine"):
            enc = getattr(net, name).encoding
            enc.copy_(torch.rand(enc.shape, generator=g) * 0.1 - 0.05)
            jparams[name]["encoding"] = jnp.asarray(enc.numpy().T)
    return net, jparams, jcfg


@pytest.mark.parametrize("which", list(NETS))
def test_selector_and_general_pack(which):
    net, _, _ = _nets(which)
    assert sd.check_sdf_network(net.cfg) == NETS[which]
    pack = sd.pack_sdf(net)            # on the CPU: the tables, no weights
    assert pack.weights is None
    assert (pack.tables["coarse"].dtype == torch.float32) == (which == "concat")
    flat, desc = sd.pack_general(net)
    assert flat.numel() % 4 == 0 and desc.shape == (2, sd.DESC_INTS)
    x = T(np.random.default_rng(6).uniform(-1.05, 1.05, (600, 3)).astype(np.float32))
    want = sd.sdf_plain(net, pack.tables, x)
    scale = float(want.abs().max())
    got = sd.sdf_general_reference(net, pack.tables, flat, desc, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6 * scale)
    exact = sd.sdf_general_reference(net, pack.tables, flat, desc, x, torch.float64)
    np.testing.assert_allclose(want.double().numpy(), exact.numpy(), rtol=0,
                               atol=2e-6 * scale)


@pytest.mark.parametrize("which", list(NETS))
def test_plain_density_matches_jax(which):
    net, jparams, jcfg = _nets(which)
    rng = np.random.default_rng(8)
    x = rng.uniform(-1.0, 1.0, (1200, 3)).astype(np.float32)
    vox = rng.integers(0, 50, (64, 64, 64)).astype(np.float32)
    if jcfg.fine.concat_coarse_feature:
        sdf = jf.combine_sdf(jcfg, jparams, jnp.asarray(x), "fine")[:, 0]
    else:
        sdf = jf.combine_sdf_packed(jcfg, jparams, jf.pack_combine_tables(jcfg, jparams),
                                    jnp.asarray(x), "fine")
    want = np.asarray(jdens.laplace_density(
        sdf[:, None], jdens.grid_predefined_beta(jnp.asarray(vox), jnp.asarray(x), 64))[:, 0])
    pack = sd.pack_sdf(net)
    got = sd.sdf_density_plain(net, pack.tables, T(x), T(vox)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DENSITY_RTOL * np.abs(want).max())


@pytest.mark.parametrize("edits,match", [
    (dict(d_in=4), "d_in 4"),
    (dict(level_dim=3), "level_dim 3 is odd"),
    (dict(dims=(64, 64, 64), skip_in=(2,)), "no units left"),
    (dict(skip_in=(0,)), "skip_in holds 0"),
])
def test_selector_raises_only_where_jax_cannot_run(edits, match):
    """d_in other than 3; an odd level_dim with grid features (the JAX
    package's packed bf16 encoder asserts an even one,
    nicer_slam_tpu/ops/hash_encoder.py:865); a layer left with no units
    beside a skip's input columns; a skip into the first layer."""
    tcfg, _ = _configs("shipped")
    with pytest.raises(ValueError, match="runs in neither package.*" + match):
        sd.check_sdf_network(tcfg._replace(fine=tcfg.fine._replace(**edits)))
    # an odd level_dim without grid features, or with concat (fp32 tables),
    # is fine
    ok = tcfg._replace(fine=tcfg.fine._replace(level_dim=3, use_grid_feature=False))
    assert sd.check_sdf_network(ok) == "general"


def test_concat_has_no_density_cache():
    """The JAX package cannot build a density cache with
    concat_coarse_feature (its build_density_cache reads
    combine_sdf_packed, whose fine input lacks the coarse features: a shape
    error); the port's grid mode raises a ValueError, and so does the bf16
    SDF."""
    net, jparams, jcfg = _nets("concat")
    pack = sd.pack_sdf(net)
    vox = torch.zeros((64, 64, 64))
    with pytest.raises(ValueError, match="build_density_cache"):
        sd.density_grid(net, pack, 8, vox)
    with pytest.raises(ValueError, match="shape error"):
        tf.combine_sdf_packed(net, tf.pack_combine_tables(net), torch.zeros((4, 3)))
    with pytest.raises(TypeError):
        jf.combine_sdf_packed(jcfg, jparams, jf.pack_combine_tables(jcfg, jparams),
                              jnp.zeros((4, 3)), "fine")
