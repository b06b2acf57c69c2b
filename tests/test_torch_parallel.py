"""Ray-parallel mapping (parallel/mesh.py, ``map_step(shard=...)``) on the
CPU: two gloo ranks, each a spawned process, against the one-process step
of the port and against the JAX package's two-device sharded step.

The case is tests/_torch_parallel_case.py's (test_torch_slice's map_step
with flow, warp and BA). The bounds against the one-process step are the
JAX package's own multichip ones (tests/_multichip_equiv_main.py:
139-151, and tests/_grid_collectives_main.py:77-79 for psum_bf16).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu_torch.parallel import mesh
from nicer_slam_tpu_torch.slam.checkpoint import jax_layout

import _torch_draws
import _torch_parallel_case as case
from _torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
# the colour grid's rows in the case (3 levels, at most 2^10 rows each):
# psum_bf16 takes it with the threshold lowered to this, as the JAX
# package's collective-modes test lowers GRID_SHARD_MIN_ENTRIES
BF16_MIN_ROWS = 1 << 10


def _key():
    """The slice test's draw: the first key whose rays avoid pixel row and
    column 0 (the warp's in-bounds test compares a rounding-size number
    with 0 there)."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(20000))
    pix = np.asarray(jax.vmap(lambda k: jax.random.randint(
        jax.random.split(k)[0], (case.R,), 0, case.H * case.W))(keys))
    clear = np.all((pix % case.W >= 1) & (pix // case.W >= 1), axis=1)
    assert clear.any()
    return int(np.argmax(clear))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from nicer_slam_tpu_torch.datasets.synthetic import generate

    tmp = tmp_path_factory.mktemp("parallel")
    data = str(tmp / "Synthetic")
    generate(data, scan_id=1, n_frames=case.N_IMAGES, H=case.H, W=case.W, keyframe_every=4,
             with_flow=True)
    arrays = case.scene_arrays(data)
    key = _key()
    tcfg, _ = case.port_configs()
    d = _torch_draws.map_draws(jax.random.PRNGKey(key), tcfg, case.R)
    draws = (d.pix, tuple(d.render))
    blob = str(tmp / "case.pt")
    torch.save({"arrays": arrays, "draws": draws}, blob)
    out = {"one": case.port_step(arrays, draws), "arrays": arrays, "key": key,
           "tmp": tmp}
    for mode, repeats, rows in (("replicated", 2, 1 << 22), ("psum_bf16", 1, BF16_MIN_ROWS),
                                ("sharded", 1, BF16_MIN_ROWS)):
        d = tmp / mode
        d.mkdir()
        out[mode] = case.run_ranks(blob, str(d), 2, mode, rows, repeats)
    return out


def _updates(res, arrays_params):
    return {n: res["params"][n] - arrays_params[n] for n in res["params"]}


def _initial_params():
    from nicer_slam_tpu_torch.models import scene_model as tsm
    tcfg, _ = case.port_configs()
    return {n: p.detach().numpy() for n, p in
            tsm.SceneModel(tcfg, np.random.default_rng(0)).named_parameters()}


def _against_one_rank(one, two, bf16_rows=()):
    """JAX's multichip bounds: loss rtol 2e-4, poses rtol 1e-3 / atol 1e-6,
    voxels equal, parameter updates within 5e-3 of the largest update; the
    bf16-reduced tables' gradients within 4e-2 of the largest gradient (the
    collective-modes test's bound; their first Adam update, -lr·sign(g)
    where g is not 0, flips with the bf16 rounding of a gradient near 0,
    so it is not compared)."""
    assert np.isfinite(one["terms"]["loss"])
    np.testing.assert_allclose(two["terms"]["loss"], one["terms"]["loss"], rtol=2e-4)
    np.testing.assert_allclose(two["q"], one["q"], rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(two["voxels"], one["voxels"])
    p0 = _initial_params()
    for n, u1 in _updates(one, p0).items():
        if n in bf16_rows:
            continue
        u2 = two["params"][n] - p0[n]
        scale = max(np.abs(u1).max(), 1e-8)
        np.testing.assert_allclose(u2, u1, rtol=0, atol=5e-3 * scale, err_msg=n)
    for n in bf16_rows:
        g1, g2 = one["grads"][n], two["grads"][n]
        np.testing.assert_allclose(g2, g1, rtol=0, atol=4e-2 * np.abs(g1).max(), err_msg=n)


def _same(a, b):
    for k in ("q", "voxels"):
        np.testing.assert_array_equal(a[k], b[k])
    for n in a["params"]:
        np.testing.assert_array_equal(a["params"][n], b["params"][n], err_msg=n)
    for n in a["terms"]:
        np.testing.assert_array_equal(a["terms"][n], b["terms"][n], err_msg=n)


def test_two_ranks_match_one_rank_replicated(runs):
    two = runs["replicated"][0][0]
    _against_one_rank(runs["one"], two)
    # every weighted term is live, and the all-reduce carried every gradient
    for k in ("flow_loss", "warp_loss", "eikonal_loss", "depth_loss", "rgb_loss"):
        assert float(two["terms"][k]) > 0, k
    n_grad = sum(g.size for g in runs["one"]["grads"].values())
    assert two["sent"]["grads"] == 4 * (n_grad + case.SMAX * 7)
    assert float(two["terms"]["allreduce_bytes"]) == sum(two["sent"].values())


def test_two_ranks_match_one_rank_psum_bf16(runs):
    two = runs["psum_bf16"][0][0]
    assert "render.encoding" in two["grads"]
    assert two["params"]["render.encoding"].shape[0] >= BF16_MIN_ROWS
    _against_one_rank(runs["one"], two, bf16_rows=("render.encoding",))
    # the colour grid's gradient went as bf16: half its float32 bytes
    rep = runs["replicated"][0][0]
    table = two["params"]["render.encoding"].size
    assert float(rep["terms"]["allreduce_bytes"]) - float(two["terms"]["allreduce_bytes"]) \
        == 2 * table


def test_ranks_hold_equal_parameters_and_poses(runs):
    for mode in ("replicated", "psum_bf16", "sharded"):
        r0, r1 = runs[mode]
        _same(r0[0], r1[0])


def test_two_ranks_match_one_rank_sharded(runs):
    """The colour grid and its Adam moments row-sharded: each rank held
    half the table, and the step matches the one-process step under the
    JAX collective-modes test's bounds (tests/_grid_collectives_main.py:
    91-92; the forward reads the table in bf16): the loss within 4e-3 ·
    max(|loss|, 1), every gradient within 4e-2 of its largest entry; the
    poses and the voxel counter as in the other modes."""
    two, one = runs["sharded"][0][0], runs["one"]
    assert two["sharded_tables"] == 1
    assert two["params"]["render.encoding"].shape == one["params"]["render.encoding"].shape
    l1, l2 = float(one["terms"]["loss"]), float(two["terms"]["loss"])
    assert abs(l2 - l1) <= 4e-3 * max(abs(l1), 1.0)
    np.testing.assert_allclose(two["q"], one["q"], rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(two["voxels"], one["voxels"])
    assert set(two["grads"]) == set(one["grads"])
    for n, g1 in one["grads"].items():
        np.testing.assert_allclose(two["grads"][n], g1, rtol=0,
                                   atol=4e-2 * np.abs(g1).max(), err_msg=n)
    # the shards took the Adam step: the gathered table moved
    assert np.any(two["params"]["render.encoding"] != _initial_params()["render.encoding"])


@pytest.mark.parametrize("mode", ["replicated", "psum_bf16", "sharded"])
def test_sent_bytes_match_the_tensors(runs, mode):
    """allreduce_bytes is every byte the rank sent in the step (a ring:
    an all-reduce of B bytes sends 2 (N - 1) / N B, B at two ranks),
    gathers included, against the tensors' sizes: the gradients (float32;
    psum_bf16's colour grid in bf16; sharded's colour grid not at all), the
    voxel counter's increment, and sharded's bf16 row gather and
    reduce-scatter (each a gloo all-reduce of the [T, C] bf16 table); the
    per-ray outputs' gathers are the same in every mode."""
    two, one = runs[mode][0][0], runs["one"]
    sent = two["sent"]
    n_grad = sum(g.size for g in one["grads"].values())
    table = one["params"]["render.encoding"].size
    grads = {"replicated": 4 * n_grad, "psum_bf16": 4 * n_grad - 2 * table,
             "sharded": 4 * (n_grad - table)}[mode]
    assert sent["grads"] == grads + 4 * case.SMAX * 7
    assert sent["counts"] == 4 * runs["arrays"]["vox"].size
    assert sent["rays"] > 0 and sent["rays"] == runs["replicated"][0][0]["sent"]["rays"]
    grid = {k: sent.get(k, 0) for k in ("grid_gather", "grid_reduce_scatter")}
    assert grid == ({"grid_gather": 2 * table, "grid_reduce_scatter": 2 * table}
                    if mode == "sharded" else {"grid_gather": 0, "grid_reduce_scatter": 0})
    assert set(sent) <= {"grads", "counts", "rays", "grid_gather", "grid_reduce_scatter"}
    assert float(two["terms"]["allreduce_bytes"]) == sum(sent.values())


def test_two_rank_step_repeats_bit_for_bit(runs):
    first, second = runs["replicated"][0]
    _same(first, second)


def test_shard_slices_the_global_draws():
    """Rays, prepass chunks and eikonal points of a rank's slice."""
    from nicer_slam_tpu_torch.models import scene_model as tsm
    from nicer_slam_tpu_torch.slam.mapping import shard_render_draws

    R = 8
    d = tsm.RenderDraws(t_rand=torch.arange(R)[:, None].float(),
                        perm=torch.arange(4)[:, None].repeat(1, 3),
                        eik_idx=torch.arange(R), eik_uniform=torch.arange(10 * R)[:, None],
                        eik_nei=torch.arange(11 * R)[:, None])
    s = mesh.RayShard(1, 2)
    lo, hi = s.rays(R)
    got = shard_render_draws(d, R, lo, hi)
    assert (lo, hi) == (4, 8)
    assert got.t_rand[:, 0].tolist() == [4, 5, 6, 7]
    assert got.perm[:, 0].tolist() == [2, 3]          # chunks of 2 rays: rows 2, 3
    assert got.eik_uniform[:, 0].tolist() == list(range(40, 80))
    assert got.eik_nei[:, 0].tolist() == list(range(40, 80)) + list(range(84, 88))
    with pytest.raises(ValueError, match="whole prepass chunks"):
        shard_render_draws(d._replace(perm=torch.zeros((8, 3), dtype=torch.int64)[:3]),
                           9, 2, 5)
    for mode in ("replicated", "psum_bf16", "sharded"):
        mesh.check_mode(mode)
    with pytest.raises(ValueError, match="unknown grid collective mode"):
        mesh.check_mode("ici")
    with pytest.raises(ValueError, match="do not split"):
        mesh.RayShard(0, 3).rays(8)


def test_two_ranks_match_jax_sharded_step(runs):
    """The JAX package's map_step(shard_rays=ray_sharding(make_mesh(2))) in
    a subprocess (as tests/_multichip_equiv_main.py runs it), on the same
    inputs, weights and draws, against the port's two-rank step under
    test_torch_slice's bounds: loss terms, the voxel counter equal, the
    gradients (from JAX's first Adam moment), the moved BA pose entries."""
    tmp = runs["tmp"]
    npz = str(tmp / "jax_in.npz")
    np.savez(npz, key=runs["key"], **runs["arrays"])
    out = str(tmp / "jax_out.npz")
    proc = subprocess.run([sys.executable, os.path.join(HERE, "_torch_parallel_jax_main.py"),
                           npz, out], capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SHARDED OK n_devices=2" in proc.stdout
    j = dict(np.load(out))
    two = runs["replicated"][0][0]
    for k, v in two["terms"].items():
        if k == "allreduce_bytes":
            continue
        a, b = np.float64(v), np.float64(j["term/" + k])
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7 * max(abs(b), 1e-30), err_msg=k)
    np.testing.assert_array_equal(two["voxels"], j["voxels"])
    for n, g_t in two["grads"].items():
        key_ = n.replace(".", "/")
        g_j = j["mu/" + key_] / np.float32(0.1)
        g_t = jax_layout(key_, torch.from_numpy(g_t))
        # test_torch_slice's bounds: the colour side elementwise, the SDF
        # side (float32 rounding amplified by the Laplace density) 2e-3
        # relative L2
        if key_.startswith("render/"):
            np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-4 * np.abs(g_j).max(),
                                       err_msg=key_)
        else:
            rel = np.linalg.norm(g_t - g_j) / max(np.linalg.norm(g_j), 1e-30)
            assert rel <= 2e-3, (key_, rel)
    q0 = runs["arrays"]["q"]
    moved = np.abs(j["q"] - q0) > 0.5e-3
    assert moved[:2].sum() >= 10 and not moved[2:].any()
    np.testing.assert_allclose(two["q"][moved], j["q"][moved], atol=1e-6)
