"""K6, SDF to prepass density (``nicer_slam_tpu_torch/ops/sdf_density.py``),
on the CPU against the JAX package, and the parts of its kernel that run
in Python: the weight packer, the grid index map and the shape check.

  * grid mode (the density cache) and ray mode (the exact prepass of an
    eval render) against the JAX package's ``build_density_cache`` and its
    exact-prepass density at the same points, for the voxel counter's β,
    the learned β, and a β scale: 2e-5 of the largest density (the
    Laplace density turns the SDF's float32 rounding, a few ulp, into
    ~1.6e-5 of its largest value: its slope at the surface is 1/(2β²),
    ~35 times the largest density 1/β; see test_torch_fields.py);
  * the packed weights round-trip exactly, and the SDF computed in the
    kernel's layer order from them reproduces ``combine_sdf_packed`` within
    1e-6 (float32 sums in another order; SDF values up to ~1.5);
  * the grid index map reproduces meshgrid's rows bit for bit;
  * the selector (``check_sdf_network``) takes every shipped
    configuration to the shipped kernel and the networks it refused before
    the general kernel to the general one, whose plain density is the JAX
    package's (tests/test_torch_sdf_general.py holds the general kernel's
    packer and selector over more shapes).
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu.models import fields as jf
from nicer_slam_tpu.models import scene_model as jsm
from nicer_slam_tpu.ops import density as jdens
from nicer_slam_tpu_torch.config import parse_file
from nicer_slam_tpu_torch.models import fields as tf
from nicer_slam_tpu_torch.models import scene_model as tsm
from nicer_slam_tpu_torch.ops import sdf_density as sd

import _torch_tiny
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
DENSITY_RTOL = 2e-5


def _setup(method: str):
    jcfg, tcfg, _, _ = _torch_tiny.configs()
    jcfg = jcfg._replace(density_method=method)
    tcfg = tcfg._replace(density_method=method)
    jparams, model = _torch_tiny.models(jcfg, tcfg)
    if method == "volsdf_laplace":
        jparams["density"]["beta"] = jnp.asarray(0.02, jnp.float32)
        with torch.no_grad():
            model.density["beta"].fill_(0.02)
    vox = np.random.default_rng(4).integers(0, 50, (16, 16, 16)).astype(np.float32)
    return jcfg, tcfg, jparams, model, vox


# (density method, beta_scale): the runner's warmup scale runs from
# beta_warmup_scale (7 in the shipped confs) down to 1, widening β
CASES = [("volsdf_gridpredefined", None), ("volsdf_laplace", None),
         ("volsdf_gridpredefined", 2.0)]


def _close_density(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=DENSITY_RTOL * scale)


@pytest.mark.parametrize("method,beta_scale", CASES)
def test_density_grid_plain_matches_jax_cache(method, beta_scale):
    jcfg, tcfg, jparams, model, vox = _setup(method)
    res = tcfg.sampler.prepass_cache_res
    bs = None if beta_scale is None else jnp.asarray(beta_scale, jnp.float32)
    want = np.asarray(jsm.build_density_cache(jcfg, jparams, jnp.asarray(vox), bs))[:, 0]
    beta = tsm._learned_beta(tcfg, model)
    got = sd.density_grid(model.implicit, sd.pack_sdf(model.implicit), res, T(vox), beta,
                          None if beta_scale is None else torch.tensor(beta_scale),
                          tcfg.voxel_res).numpy()
    assert got.shape == (res ** 3,)
    _close_density(got, want)
    if beta_scale is None:
        # the slice's entry point runs the same
        np.testing.assert_array_equal(tsm.build_density_cache(tcfg, model, T(vox)).numpy(),
                                      got)


@pytest.mark.parametrize("method,beta_scale", CASES)
def test_density_rays_plain_matches_jax_exact_prepass(method, beta_scale):
    """The exact prepass's density: JAX's combine_sdf_packed and _density at
    o + z·d (its sdf_prepass and density_prepass)."""
    jcfg, tcfg, jparams, model, vox = _setup(method)
    rng = np.random.default_rng(5)
    R, S = 24, 48
    o = rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 2.0, (R, S)).astype(np.float32), axis=1)
    pts = (jnp.asarray(o)[:, None, :] + jnp.asarray(z)[..., None]
           * jnp.asarray(d)[:, None, :]).reshape(-1, 3)
    sdf = jf.combine_sdf_packed(jcfg.combine, jparams["implicit"],
                                jf.pack_combine_tables(jcfg.combine, jparams["implicit"]),
                                pts, "fine")
    bs = None if beta_scale is None else jnp.asarray(beta_scale, jnp.float32)
    want = np.asarray(jsm._density(jcfg, jparams, jnp.asarray(vox), sdf, pts, bs)).reshape(R, S)
    got = sd.density_rays(model.implicit, sd.pack_sdf(model.implicit), T(o), T(d), T(z),
                          T(vox), tsm._learned_beta(tcfg, model),
                          None if beta_scale is None else torch.tensor(beta_scale),
                          tcfg.voxel_res).numpy()
    assert got.shape == (R, S)
    _close_density(got, want)


def _unpack(flat, dims):
    """The inverse of ``sd.pack_sdf_weights`` for networks with layer dims
    ``dims[name]``: {name: [(W [out, in], b [out]) per hidden layer] +
    [(SDF row [width], bias [1])]}, units in natural order."""
    out, pos = {}, 0

    def take(n):
        nonlocal pos
        pos += n
        return flat[pos - n:pos]

    for name in ("coarse", "fine"):
        d = dims[name]
        width = d[1]
        inv = torch.argsort(sd.unit_order(width)).to(flat.device)
        layers = []
        for k_in in d[:-2]:
            w = take(k_in * width).reshape(k_in, width).t()[inv]
            layers.append((w, take(width)[inv]))
        layers.append((take(width)[inv], take(4)[:1]))
        out[name] = layers
    if pos != flat.numel():
        raise ValueError(f"packed weights hold {flat.numel()} floats, the dims {pos}")
    return out


def _shipped_combine():
    """The flagship configuration's SDF networks at full width (the
    colour network is not built: its grid alone is 1 GB)."""
    c = parse_file(os.path.join(REPO, "confs", "replica", "runconf_replica_2.conf"))
    m = c.get_config("model")
    cfg = tf.combine_config_from_conf(m.get_config("implicit_network"),
                                      m.get_int("feature_vector_size"))
    return tf.CombineNet(cfg, np.random.default_rng(0))


@pytest.fixture(scope="module")
def nets():
    _, tcfg, _, _ = _torch_tiny.configs()
    tiny = tsm.SceneModel(tcfg, np.random.default_rng(0)).implicit
    return {"tiny": tiny, "shipped": _shipped_combine()}


@pytest.mark.parametrize("which", ["tiny", "shipped"])
def test_pack_round_trip(nets, which):
    net = nets[which]
    flat = sd.pack_sdf_weights(net)
    dims = {n: getattr(net.cfg, n).layer_dims for n in ("coarse", "fine")}
    assert flat.shape == (sd.packed_floats(dims["coarse"]) + sd.packed_floats(dims["fine"]),)
    if which == "shipped":
        sd.check_sdf_network(net.cfg)
        assert flat.numel() == 17672   # the kernel's shared-memory weight block
    back = _unpack(flat, dims)
    for name in ("coarse", "fine"):
        layers = sd.effective_layers(getattr(net, name))
        for (w, b), (wu, bu) in zip(layers[:-1], back[name][:-1]):
            assert torch.equal(w, wu) and torch.equal(b, bu)
        wl, bl = back[name][-1]
        assert torch.equal(wl, layers[-1][0][0]) and torch.equal(bl, layers[-1][1][:1])
    # the layout the kernel reads: hidden layer 0's packed column 4·og + j
    # is unit og + (width/4)·j
    width = dims["coarse"][1]
    w0 = sd.effective_layers(net.coarse)[0][0]
    k_in = dims["coarse"][0]
    t0 = flat[:k_in * width].reshape(k_in, width)
    for og, j in ((0, 1), (1, 0), (width // 4 - 1, 3)):
        assert torch.equal(t0[:, 4 * og + j], w0[og + (width // 4) * j])


@pytest.mark.parametrize("which", ["tiny", "shipped"])
def test_packed_reference_matches_combine_sdf_packed(nets, which):
    net = nets[which]
    x = T(np.random.default_rng(6).uniform(-1.05, 1.05, (2000, 3)).astype(np.float32))
    tables = tf.pack_combine_tables(net)
    flat = sd.pack_sdf_weights(net)
    want = tf.combine_sdf_packed(net, tables, x, "fine")
    got = sd.sdf_packed_reference(net, tables, flat, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    # in float64 the kernel's order is the exact reference; float32 is
    # within its rounding of it
    exact = sd.sdf_packed_reference(net, tables, flat, x, torch.float64)
    np.testing.assert_allclose(want.double().numpy(), exact.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("res", [16, 37, 128])
def test_grid_index_map_bit_exact(res):
    """(i·res + j)·res + k -> (xs[i], xs[j], xs[k]) is meshgrid's row, where
    torch's linspace fills its second half from the end (so -1 + i·step is
    not the same bits)."""
    xs = torch.linspace(-1.0, 1.0, res)
    naive = -1.0 + torch.arange(res, dtype=torch.float32) * torch.tensor(2.0 / (res - 1))
    assert not torch.equal(naive, xs)
    grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    n = torch.arange(res ** 3)
    assert torch.equal(sd.grid_points(xs, n), grid)


def _combine_cfg(**edits):
    base = _shipped_combine_cfg()
    return base._replace(fine=base.fine._replace(**edits))


def _shipped_combine_cfg():
    c = parse_file(os.path.join(REPO, "confs", "replica", "runconf_replica_2.conf"))
    m = c.get_config("model")
    return tf.combine_config_from_conf(m.get_config("implicit_network"),
                                       m.get_int("feature_vector_size"))


@pytest.mark.parametrize("edits", [
    dict(dims=(128, 128, 128, 128), skip_in=(2,)),
    dict(dims=(64, 32, 64)),
    dict(dims=(64, 64, 64, 64)),
], ids=["edits0-skip_in", r"edits1-layer dims \(71, 64, 32, 64, 65\)",
        r"edits2-layer dims \(71, 64, 64, 64, 64, 65\)"])
def test_shape_check_raises(edits):
    """The networks the shape check refused before the general kernel (a
    skip, other widths, more layers on the flagship's fine network; the
    skip at width 128, since at 64 its layer 1 would have 64 - 71 units in
    either package, which the selector refuses): the
    selector now takes them to the general kernel, and raises for none; the
    plain density of the exact prepass at their points is the JAX
    package's within DENSITY_RTOL of the largest."""
    cfg = _combine_cfg(**edits)
    assert sd.check_sdf_network(cfg) == "general"
    jbase = _shipped_combine_cfg_jax()
    jcfg = jbase._replace(fine=jbase.fine._replace(**edits))
    net = tf.CombineNet(cfg, np.random.default_rng(0))
    jparams = jf.init_combine(np.random.default_rng(0), jcfg)
    rng = np.random.default_rng(8)
    x = rng.uniform(-1.0, 1.0, (1500, 3)).astype(np.float32)
    vox = rng.integers(0, 50, (64, 64, 64)).astype(np.float32)
    sdf = jf.combine_sdf_packed(jcfg, jparams, jf.pack_combine_tables(jcfg, jparams),
                                jnp.asarray(x), "fine")
    want = np.asarray(jdens.laplace_density(
        sdf[:, None], jdens.grid_predefined_beta(jnp.asarray(vox), jnp.asarray(x), 64))[:, 0])
    pack = sd.pack_sdf(net)
    got = sd.sdf_density_plain(net, pack.tables, T(x), T(vox)).numpy()
    _close_density(got, want)


def _shipped_combine_cfg_jax():
    from nicer_slam_tpu import config as jconfig
    c = jconfig.parse_file(os.path.join(REPO, "confs", "replica", "runconf_replica_2.conf"))
    m = c.get_config("model")
    return jf.combine_config_from_conf(m.get_config("implicit_network"),
                                       m.get_int("feature_vector_size"))


def test_shape_check_passes_every_shipped_conf():
    confs = sorted(glob.glob(os.path.join(REPO, "confs", "**", "*.conf"), recursive=True))
    assert len(confs) == 24
    for path in confs:
        m = parse_file(path).get_config("model")
        sd.check_sdf_network(tf.combine_config_from_conf(
            m.get_config("implicit_network"), m.get_int("feature_vector_size")))
