"""The flagship configuration's parts of the torch port against the JAX
package, on the CPU (the kernels' plain versions; chip_smoke.py holds each
CUDA kernel against its plain version on the card):

  * K7, the voxel counter: scatter and β read;
  * K3, the bf16 inference encode: the bf16 rounding of the tables, the
    encode, and the packed SDF of both grids;
  * K4 with colour top-k: the weights pass with its picks and the top-k
    colour composite, forward and backward;
  * K5 given densities (the exact prepass);
  * a full-frame render with the exact prepass, the mesh, and the CLI on a
    tiny flagship-derived conf, which ends by writing vis/.

Tolerances (each stated where it is used): the counter bit for bit (adds
of 1.0 are exact); bf16 bits equal; float32 values atol 1e-6 of O(1e-2)
features and rtol 1e-5 elsewhere (the packages sum in other orders).
"""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu import config
from nicer_slam_tpu.datasets.synthetic import camera_trajectory
from nicer_slam_tpu.models import fields as jf
from nicer_slam_tpu.ops import density as jdens
from nicer_slam_tpu.ops import hash_encoder as jhe
from nicer_slam_tpu.ops import ray_sampling as jrs
from nicer_slam_tpu.ops import volume_rendering as jvr
from nicer_slam_tpu.slam import render as jrender
from nicer_slam_tpu.utils import plots as jplots
from nicer_slam_tpu.utils.ply import read_ply
from nicer_slam_tpu_torch.models import fields as tf
from nicer_slam_tpu_torch.ops import density as tdens
from nicer_slam_tpu_torch.ops import hash_encoder as the
from nicer_slam_tpu_torch.ops import ray_sampling as trs
from nicer_slam_tpu_torch.ops import volume_rendering as tvr
from nicer_slam_tpu_torch.slam import render as trender
from nicer_slam_tpu_torch.slam.checkpoint import port_layout
from nicer_slam_tpu_torch.utils import plots as tplots

import _torch_tiny
from test_torch_hash_encoder import SPECS
from test_torch_ops import _match_all_but_one
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg, _, _ = _torch_tiny.configs()
    jparams, model = _torch_tiny.models(jcfg, tcfg)
    vox = np.random.default_rng(11).integers(0, 40, (16, 16, 16)).astype(np.float32)
    return jcfg, tcfg, jparams, model, vox


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def test_voxel_counter_matches_jax_bit_for_bit():
    """Scatter with many points per voxel and boundary points: the counter
    bit for bit; the β read rtol 1e-6 (exp in float32)."""
    rng = np.random.default_rng(0)
    res = 16
    x = rng.uniform(-1.02, 1.02, (4000, 3)).astype(np.float32)
    x[:500] = x[:500] * 0.05                     # a crowded voxel near the origin
    x[500:520, 1] = 0.995                        # boundary points
    vox = rng.integers(0, 9, (res,) * 3).astype(np.float32)
    v_t = tdens.update_voxels(T(vox), T(x), res)
    v_j = np.asarray(jdens.update_voxels(jnp.asarray(vox), jnp.asarray(x), res))
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert v_t.numpy().max() > 40 and np.all(vox <= 8)         # a new tensor
    b_t = tdens.grid_predefined_beta(v_t, T(x), res).numpy()
    b_j = np.asarray(jdens.grid_predefined_beta(jnp.asarray(v_j), jnp.asarray(x), res))
    np.testing.assert_allclose(b_t, b_j, rtol=1e-6)
    assert np.all(b_t[500:520] == b_t[500])                   # boundary: count 0


def _scatter_as_the_kernel(vox: np.ndarray, x: np.ndarray, res: int,
                           rng: np.random.Generator) -> np.ndarray:
    """numpy emulation of the K7 scatter kernel's arithmetic: a warp holds
    32 consecutive points (one per thread); where two neighbouring lanes
    share a voxel, the lanes on one voxel add their count as one float32
    add, otherwise each lane adds 1; the adds land in a random order."""
    idx = np.clip(((x + np.float32(1.0)) / np.float32(2.0) * np.float32(res))
                  .astype(np.int64), 0, res - 1)
    flat = (idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]
    flat[(np.abs(x) > np.float32(0.99)).any(1)] = -1
    adds = []
    for w in range(0, len(flat), 32):
        warp = flat[w:w + 32]
        if ((warp[1:] == warp[:-1]) & (warp[1:] >= 0)).any():
            ids, counts = np.unique(warp, return_counts=True)
            adds += [(i, c) for i, c in zip(ids, counts) if i >= 0]
        else:
            adds += [(i, 1) for i in warp if i >= 0]
    out = vox.reshape(-1).copy()
    for k in rng.permutation(len(adds)):
        i, c = adds[k]
        out[i] = np.float32(out[i] + np.float32(c))
    return out.reshape(vox.shape)


def _voxel_case(name: str, rng: np.random.Generator) -> np.ndarray:
    """Points of one K7 case: 'edges' puts coordinates at exactly ±0.99
    (counted) and ±1.0 (boundary: not counted, β of count 0); 'run' holds
    a run of 40 consecutive points in one voxel (more than a warp) and
    runs of 33 and 31 across warp edges; 'rays' is ray-ordered samples."""
    if name == "edges":
        x = rng.uniform(-0.9, 0.9, (300, 3)).astype(np.float32)
        for d in range(3):
            for k, v in enumerate((0.99, -0.99, 1.0, -1.0)):
                x[d * 40 + 10 * k:d * 40 + 10 * k + 10, d] = v
        return x
    if name == "run":
        x = rng.uniform(-1.0, 1.0, (200, 3)).astype(np.float32)
        x[5:45] = np.float32([0.31, -0.2, 0.05]) + rng.uniform(0, 0.01, (40, 3))
        x[60:93] = np.float32([-0.5, 0.5, 0.7]) + rng.uniform(0, 0.01, (33, 3))
        x[130:161] = np.float32([0.8, 0.8, -0.8]) + rng.uniform(0, 0.01, (31, 3))
        return x.astype(np.float32)
    o = rng.uniform(-0.3, 0.3, (24, 1, 3))
    d = rng.normal(size=(24, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 1.6, (24, 50, 1)), axis=1)
    return (o + z * d).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("name", ["edges", "run", "rays"])
def test_voxel_counter_cases_match_jax(name):
    """The plain scatter and an emulation of the kernel's warp-merged adds
    give JAX's counter bit for bit on points at ±0.99 and ±1.0, runs of
    more than 32 points in one voxel and ray-ordered samples; the input
    counter is left unchanged; the β read rtol 1e-6 (exp in float32), and
    boundary points read count 0."""
    rng = np.random.default_rng(["edges", "run", "rays"].index(name))
    res = 16
    x = _voxel_case(name, rng)
    vox = rng.integers(0, 9, (res,) * 3).astype(np.float32)
    vox_t = T(vox.copy())
    v_t = tdens.update_voxels(vox_t, T(x), res)
    v_j = np.asarray(jdens.update_voxels(jnp.asarray(vox), jnp.asarray(x), res))
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    np.testing.assert_array_equal(_scatter_as_the_kernel(vox, x, res, rng), v_j)
    np.testing.assert_array_equal(vox_t.numpy(), vox)
    assert (v_j - vox).sum() == (np.abs(x) <= np.float32(0.99)).all(1).sum()
    b_t = tdens.grid_predefined_beta(v_t, T(x), res).numpy()
    b_j = np.asarray(jdens.grid_predefined_beta(jnp.asarray(v_j), jnp.asarray(x), res))
    np.testing.assert_allclose(b_t, b_j, rtol=1e-6)
    outside = (np.abs(x) > np.float32(0.99)).any(1)
    if name == "edges":
        assert outside.sum() == 60 and (~outside).sum() == 240
        assert (v_j - vox).max() > 0
    if name == "run":
        assert (v_j - vox).max() >= 40
    zero = tdens.grid_predefined_beta(T(np.zeros_like(vox)), T(x[:1]), res).numpy()
    np.testing.assert_array_equal(b_t[outside], np.broadcast_to(zero, b_t[outside].shape))


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def test_bf16_pack_rounds_as_xla():
    """torch's float32 -> bfloat16 cast gives XLA's bits, ties to even
    included: the K3 table holds the JAX package's packed values."""
    rng = np.random.default_rng(1)
    C, n = 4, 4096
    bits = rng.integers(0, 2 ** 32, (C, n), dtype=np.uint64).astype(np.uint32)
    bits[:, : n // 4] = (bits[:, : n // 4] & 0xFFFF0000) | 0x8000   # exact ties
    bits = (bits & 0x3FFFFFFF) | 0x38000000                  # finite, O(1e-3..1e3)
    table = bits.view(np.float32)
    packed_j = np.asarray(jhe.pack_table_bf16_pairs(jnp.asarray(table)))      # [C/2, T]
    packed_t = the.pack_table_bf16(port_layout("encoding", table)).view(
        torch.int16).numpy().view(np.uint16)                                # [T, C]
    np.testing.assert_array_equal((packed_j >> 16).astype(np.uint16), packed_t[:, 0::2].T)
    np.testing.assert_array_equal((packed_j & 0xFFFF).astype(np.uint16), packed_t[:, 1::2].T)


@pytest.mark.parametrize("name", ["dense_c4", "mixed_c4", "dense_c8", "hashed_c2"])
def test_hash_encode_bf16_matches_jax(name):
    spec_j = jhe.make_spec(input_dim=3, **SPECS[name])
    spec_t = the.make_spec(input_dim=3, **SPECS[name])
    rng = np.random.default_rng(2)
    table = rng.uniform(-0.01, 0.01, (spec_j.level_dim, spec_j.total_entries)
                        ).astype(np.float32)
    x = rng.uniform(-1.05, 1.05, (257, 3)).astype(np.float32)
    f_j = np.asarray(jhe.hash_encode_packed(
        spec_j, jhe.pack_table_bf16_pairs(jnp.asarray(table)), jnp.asarray(x)))
    table_t = port_layout("encoding", table)
    f_t = the.hash_encode_bf16(spec_t, the.pack_table_bf16(table_t), T(x)).numpy()
    np.testing.assert_allclose(f_t, f_j, atol=1e-6, rtol=0)
    # the bf16 rounding is visible: the fp32 encode differs by more
    f_32 = the.hash_encode(spec_t, table_t, T(x)).numpy()
    assert np.abs(f_32 - f_j).max() > 1e-5
    with pytest.raises(ValueError, match="no backward"):
        the.hash_encode_bf16(spec_t, the.pack_table_bf16(table_t),
                             T(x).requires_grad_(True))


def test_combine_sdf_packed_matches_jax(tiny):
    """Both grids through K3 and the MLPs: SDF atol 2e-6 (float32 MLPs,
    values up to ~1.5)."""
    jcfg, _, jparams, model, _ = tiny
    x = np.random.default_rng(3).uniform(-1.05, 1.05, (500, 3)).astype(np.float32)
    for stage in ("fine", "coarse"):
        s_j = np.asarray(jf.combine_sdf_packed(
            jcfg.combine, jparams["implicit"],
            jf.pack_combine_tables(jcfg.combine, jparams["implicit"]), jnp.asarray(x), stage))
        s_t = tf.combine_sdf_packed(model.implicit, tf.pack_combine_tables(model.implicit),
                                    T(x), stage).numpy()
        np.testing.assert_allclose(s_t, s_j, atol=2e-6, rtol=0)


# ---------------------------------------------------------------------------
# K4 with colour top-k
# ---------------------------------------------------------------------------

def _topk_jax(z, density, rgb_all, normals, Kc):
    """scene_model.py:321-357 and 489-491 of the JAX package."""
    w = jvr.render_weights(z, density)
    topk_w, topk_i = jax.lax.top_k(w, Kc)
    rgb = jnp.take_along_axis(rgb_all, topk_i[..., None], axis=1)
    wsum = w.sum(1, keepdims=True)
    renorm = wsum / (topk_w.sum(1, keepdims=True) + 1e-8)
    rgb_values = ((topk_w * renorm)[..., None] * rgb).sum(1)
    depth = (w * z).sum(1, keepdims=True) / (w.sum(1, keepdims=True) + 1e-8)
    return (w, rgb_values, depth, (w[..., None] * normals).sum(1), topk_w, wsum), topk_i


def _topk_torch(z, density, rgb_all, normals, Kc):
    w, depth, normal_map, topk_w, wsum, picks = tvr.weights_topk(z, density, normals, Kc)
    R, S = w.shape
    rgb = rgb_all.reshape(R * S, 3)[picks.reshape(-1)].reshape(R, Kc, 3)
    rgb_values = tvr.topk_rgb(topk_w, wsum, rgb)
    idx = picks - torch.arange(R)[:, None] * S
    return (w, rgb_values, depth, normal_map, topk_w, wsum), idx


def test_weights_topk_and_topk_rgb_match_jax():
    """Outputs atol 1e-5 (topk_w and wsum against lax.top_k's values and
    w.sum), picks equal (ray 0 ties at exact zeros: both take the lower
    index), gradients to density, colours and normals through the kept
    weights and their sum: atol 1e-5, rtol 1e-5."""
    rng = np.random.default_rng(4)
    R, S, Kc = 24, 30, 8
    z = np.sort(rng.uniform(0.1, 3.0, (R, S)), 1).astype(np.float32)
    dens = rng.uniform(0, 8, (R, S)).astype(np.float32)
    dens[0] = 0.0
    dens[0, 1:3] = [50.0, 1e4]        # opaque at sample 2: every other weight is 0
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    nrm = rng.standard_normal((R, S, 3)).astype(np.float32)
    cots = [rng.standard_normal(s).astype(np.float32) for s in ((R, S), (R, 3), (R, 1), (R, 3))]

    def f_j(d, c, n):
        return _topk_jax(jnp.asarray(z), d, c, n, Kc)[0][:4]

    outs_j, vjp = jax.vjp(f_j, jnp.asarray(dens), jnp.asarray(rgb), jnp.asarray(nrm))
    grads_j = vjp(tuple(jnp.asarray(c) for c in cots))
    full_j, idx_j = _topk_jax(jnp.asarray(z), jnp.asarray(dens), jnp.asarray(rgb),
                              jnp.asarray(nrm), Kc)
    ins = [T(a).requires_grad_(True) for a in (dens, rgb, nrm)]
    outs_t, idx_t = _topk_torch(T(z), *ins, Kc)
    grads_t = torch.autograd.grad(outs_t[:4], ins, [T(c) for c in cots])
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert list(idx_t[0].numpy()) == [1, 2, 0, 3, 4, 5, 6, 7]
    for a, b in zip(outs_t, full_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# K5 given densities
# ---------------------------------------------------------------------------

def _given_matches_jax(Ne):
    cfg_j = jrs.SamplerConfig(N_samples=16, N_samples_eval=Ne, N_samples_extra=8)
    cfg_t = trs.SamplerConfig(N_samples=16, N_samples_eval=Ne, N_samples_extra=8)
    rng = np.random.default_rng(5)
    R = 32
    o = np.tile(np.array([[0.0, 0.0, -0.95]], np.float32), (R, 1))
    d = np.concatenate([rng.uniform(-0.4, 0.4, (R, 2)), np.ones((R, 1))], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    def sdf_np(p):
        return np.linalg.norm(p, axis=-1) - 0.5

    beta = 0.2
    z_j, _ = jrs.importance_z_vals(
        cfg_j, jnp.asarray(o), jnp.asarray(d), lambda p: jnp.linalg.norm(p, axis=-1) - 0.5,
        lambda s, p: jdens.laplace_density(s, beta), jax.random.PRNGKey(0), training=False)
    z, near, far = trs.uniform_z_vals(cfg_t, T(o), T(d), None)
    pts = (T(o)[:, None] + z[..., None] * T(d)[:, None]).reshape(-1, 3)
    dens = tdens.laplace_density(T(sdf_np(pts.numpy()).astype(np.float32)),
                                 torch.tensor(beta)).reshape(R, -1)
    perm = T(np.linspace(0, Ne - 1, 8).astype(np.int64))
    z_t, e_t = trs.importance_sample_given(cfg_t, z, near, far, dens, perm,
                                           torch.zeros(R, dtype=torch.int64))
    z_j, z_t = np.asarray(z_j), z_t.numpy()
    assert z_t.shape == z_j.shape == (R, 26)
    assert _match_all_but_one(z_t, z_j, 1e-5).all()
    assert (np.abs(z_t - z_j).max(1) <= 1e-5).mean() > 0.5
    np.testing.assert_array_equal(e_t.numpy()[:, 0], z_t[:, 0])


def test_importance_sample_given_matches_jax():
    """The exact prepass (eval: no jitter, perm = linspace) on densities of
    an analytic SDF: z_vals to 1e-5 except the u = 1 inverse-CDF sample of
    a ray (test_torch_ops.test_sample_cdf_matches_jax). β = 0.2 leaves the
    far end of a ray some weight, so most rays match on every sample."""
    _given_matches_jax(64)


def test_importance_sample_given_matches_jax_at_ne_100():
    """The same at 100 prepass samples, no multiple of the kernel's 32
    lanes."""
    _given_matches_jax(100)


# ---------------------------------------------------------------------------
# full-frame render, mesh, CLI
# ---------------------------------------------------------------------------

def _camera(H, W):
    c2w = camera_trajectory(3)[1].astype(np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.9 * W
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0
    return c2w, K


def test_render_image_exact_prepass_matches_jax(tiny):
    """24x32 frame, chunks of 160 rays (the tail padded), exact prepass on
    both sides: rgb and normals atol 1e-4, depth rtol 1e-4, on every pixel
    but those of rays that meet no surface in one of the packages (at most
    1 %; 5 of 768 here). On such a ray every weight is 0 but the last,
    1 - exp(-1e10 σ), and σ there is the Laplace density at |sdf|/β ~ 17:
    0.5 + 0.5·expm1(-17) cancels to 0 or to 2^-25 depending on the last bit
    of expm1, which torch and XLA round differently. The ray then renders
    the far sample (weight 1) in one package and nothing (depth 0) in the
    other."""
    jcfg, tcfg, jparams, model, vox = tiny
    c2w, K = _camera(24, 32)
    out_j = jrender.render_image(jcfg, jparams, jnp.asarray(vox), c2w, K, chunk=160,
                                 key=jax.random.PRNGKey(0))
    out_t = trender.render_image(tcfg, model, T(vox), c2w, K, chunk=160)
    ok = np.ones((24, 32), bool)
    for k, tol in (("rgb", 1e-4), ("normal", 1e-4)):
        assert out_t[k].shape == out_j[k].shape and np.isfinite(out_t[k]).all()
        ok &= (np.abs(out_t[k] - out_j[k]) <= tol).all(-1)
    ok &= np.abs(out_t["depth"] - out_j["depth"]) <= 1e-4 * np.abs(out_j["depth"])
    assert ok.mean() >= 0.99, ok.mean()
    assert np.all((out_t["depth"][~ok] == 0) | (out_j["depth"][~ok] == 0))
    assert out_t["rgb"].std() > 1e-3                  # not a constant image


def test_save_mesh_matches_jax(tiny, tmp_path):
    """plot.resolution 32: the SDF volume rtol 1e-5 (atol 1e-5 of its
    largest magnitude), then equal vertex and face counts, vertices and
    normals atol 1e-4, uint8 colours within 1 (a colour may sit on a
    rounding boundary)."""
    jcfg, tcfg, jparams, model, _ = tiny
    conf = config.parse_string("plot { resolution = 32  grid_boundary = [ -1.0 1.0 ] }")
    dirs = {p: tmp_path / p for p in ("jax", "torch")}
    for d in dirs.values():
        d.mkdir()
    j_runner = types.SimpleNamespace(conf=conf, scene_cfg=jcfg, params=jparams,
                                     plots_dir=str(dirs["jax"]), log=print)
    t_runner = types.SimpleNamespace(conf=conf, model=model, device=torch.device("cpu"),
                                     plots_dir=str(dirs["torch"]), log=print)
    xs = np.linspace(-1, 1, 32, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    v_t = tplots.mesh_sdf_fn(model, torch.device("cpu"))(grid)
    v_j = np.asarray(jf.combine_sdf(jcfg.combine, jparams["implicit"], jnp.asarray(grid),
                                    "fine")[:, 0])
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5, atol=1e-5 * np.abs(v_j).max())
    m_j = read_ply(jplots.save_mesh(j_runner, 7))
    m_t = read_ply(tplots.save_mesh(t_runner, 7))
    assert os.path.basename(tplots.save_mesh(t_runner, 7)) == "surface_0007.ply"
    assert len(m_t["faces"]) == len(m_j["faces"]) > 100
    assert sorted(m_t) == sorted(m_j) == ["colors", "faces", "normals", "verts"]
    np.testing.assert_array_equal(m_t["faces"], m_j["faces"])
    for k, tol in (("verts", 1e-4), ("normals", 1e-4), ("colors", 1)):
        np.testing.assert_allclose(m_t[k].astype(np.float64), m_j[k], atol=tol, err_msg=k)


def test_cli_on_a_flagship_derived_conf_writes_vis(tmp_path):
    """confs/replica/runconf_replica_2.conf (colour top-k, warp loss, GT
    depth, BA) with the tiny model widths, 3 frames at 24x32: the CLI runs
    on the CPU and ends with vis/rendering_*.png and vis/surface_*.ply."""
    from nicer_slam_tpu_torch.datasets.synthetic import generate

    data_dir = str(tmp_path / "Synthetic")
    generate(data_dir, scan_id=2, n_frames=3, H=24, W=32, keyframe_every=10,
             with_flow=True)
    text = open(os.path.join(REPO, "confs", "replica", "runconf_replica_2.conf")).read()
    model = _torch_tiny.MODEL_CONF.replace("use_warp_loss = true",
                                           "use_warp_loss = true\n    color_topk = 6")
    text = text[:text.index("\nmodel {")] + model
    for old, new in (('"../Datasets/processed/Replica"', f'"{data_dir}"'),
                     ("680\n        1200", "24\n        32"), ("n_images = 2000", "n_images = 3"),
                     ("iters = 100", "iters = 3"), ("mapping_num_pixels = 8192",
                                                    "mapping_num_pixels = 64"),
                     ("tracking_num_pixels = 1024", "tracking_num_pixels = 32"),
                     ("split_n_pixels = 2580", "split_n_pixels = 200"),
                     ("resolution = 512", "resolution = 32")):
        assert old in text, old
        text = text.replace(old, new)
    conf = tmp_path / "flagship_tiny.conf"
    conf.write_text(text)
    # one torch thread: the suite runs files in parallel workers, where a
    # many-threaded subprocess stalls on its descheduled threads
    out = subprocess.run(
        [sys.executable, "-m", "nicer_slam_tpu_torch.training.exp_runner", "--conf",
         str(conf), "--root_dir", str(tmp_path), "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    vis = next(os.path.join(r, "vis") for r, ds_, _ in os.walk(tmp_path / "exps")
               if "vis" in ds_)
    names = sorted(os.listdir(vis))
    assert "rendering_2_0_0.png" in names and "merge_2_0_0.png" in names, names
    mesh = read_ply(os.path.join(vis, "surface_0002.ply"))
    assert len(mesh["faces"]) > 0 and np.isfinite(mesh["verts"]).all()
