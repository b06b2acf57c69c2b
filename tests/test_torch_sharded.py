"""The ``sharded`` collective mode (parallel/mesh.py,
ops/hash_encoder.hash_encode_sharded) on the CPU, and the long run's
NaN extrapolation PSNR.

  * the encode: two spawned gloo ranks, each holding half the rows of the
    JAX collective-modes test's grid (tests/_grid_collectives_main.py:
    33-37), against the JAX package's two-device sharded encode in a
    subprocess: the loss within 1e-5 relative (both round the same table
    to bf16), the table gradient within 4e-2 · max|g| (the JAX test's
    bound), the points' gradient within 1e-6 of its largest entry (both
    differentiate the same bf16 rows);
  * the predicate: ``mesh.sharded_applies`` against the JAX package's
    ``_collective_mode_applies`` over rows, points and world sizes, and
    ``shard_color_grid``'s cut and its fall-back to the replicated path;
  * the extrapolation NaN: seed 0's held-out cameras of the 250-frame
    long run (LONG_SEQ_TORCH_GUARDED_s0_poses.npz), rendered through both
    packages at tiny widths.

The map_step-level sharded cases share tests/test_torch_parallel.py's
module fixture.
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

from nicer_slam_tpu.ops import hash_encoder as jhe
from nicer_slam_tpu.parallel.mesh import make_mesh
from nicer_slam_tpu.slam import render as jrender
from nicer_slam_tpu_torch.models import scene_model as tsm
from nicer_slam_tpu_torch.ops import density as tdens
from nicer_slam_tpu_torch.parallel import mesh
from nicer_slam_tpu_torch.slam import render as trender
from nicer_slam_tpu_torch.utils.camera import near_far_from_cube, rays_from_uv

import _torch_sharded_case as case
import _torch_tiny
from _torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# the flagship's colour grid (16 levels x 2 channels, logmap 24)
FLAGSHIP_ROWS = 133_023_682


def test_sharded_encode_matches_jax_two_devices(tmp_path):
    np.savez(tmp_path / "in.npz", **case.inputs())
    proc = subprocess.run([sys.executable, os.path.join(HERE, "_torch_sharded_jax_main.py"),
                           str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SHARDED ENCODE OK n_devices=2" in proc.stdout
    j = dict(np.load(tmp_path / "out.npz"))
    got = case.run_encode_ranks(str(tmp_path))
    np.testing.assert_allclose(got["loss"], j["f2"], rtol=1e-5)
    # and the bf16 forward against the float32 one, as the JAX test holds it
    assert abs(float(got["loss"]) - float(j["f0"])) <= 4e-3 * max(abs(float(j["f0"])), 1.0)
    g2 = j["g2"].T                                          # [C, T] -> [T, C]
    np.testing.assert_allclose(got["g_table"], g2, rtol=0, atol=4e-2 * np.abs(g2).max())
    np.testing.assert_allclose(got["g_table"], j["g0"].T, rtol=0,
                               atol=4e-2 * np.abs(j["g0"]).max())
    np.testing.assert_allclose(got["g_x"], j["gx2"], rtol=0,
                               atol=1e-6 * np.abs(j["gx2"]).max())
    # one bf16 gather and one bf16 reduce-scatter of the [T, C] table, each a
    # gloo all-reduce (2 (N - 1) / N of its bytes: all of them at two ranks)
    table_bf16 = 2 * g2.size
    assert int(got["sent_grid_gather"]) == table_bf16
    assert int(got["sent_grid_reduce_scatter"]) == table_bf16


# (rows, points over all ranks, world): the flagship's colour grid at two
# ranks and at four (133,023,682 = 2 mod 4), one rank, the threshold and
# a row under it, points or rows that do not divide
PREDICATE_CASES = [
    (FLAGSHIP_ROWS, 131_072, 2), (FLAGSHIP_ROWS, 131_072, 4), (FLAGSHIP_ROWS, 131_072, 1),
    (FLAGSHIP_ROWS, 401_408, 2), (1 << 22, 8, 2), ((1 << 22) - 2, 8, 2), (1 << 22, 9, 2),
    (3 << 22, 9, 3), ((3 << 22) + 1, 9, 3), ((1 << 22) + 2, 8, 4), (1 << 23, 12, 4),
]


@pytest.mark.parametrize("rows,points,world", PREDICATE_CASES)
def test_sharded_applies_as_jax(monkeypatch, rows, points, world):
    monkeypatch.setattr(jhe, "GRID_SHARD_MESH", make_mesh(world))
    monkeypatch.setattr(jhe, "GRID_COLLECTIVE_MODE", "sharded")
    spec = types.SimpleNamespace(total_entries=rows)
    want = jhe._collective_mode_applies(spec, "sharded", points)
    assert mesh.sharded_applies(rows, points, world) == want
    if (rows, world) == (FLAGSHIP_ROWS, 2):
        assert want
    if (rows, world) == (FLAGSHIP_ROWS, 4):
        assert not want


def test_shard_color_grid_cuts_or_falls_back(capsys):
    """The cut: rank 1 of two keeps rows T/2 .. T - 1 as a new parameter
    (the Adam moments then take its shape), and allreduce_grads skips it;
    one rank, or a table under the threshold, keeps the whole table and
    says why (``sharded_tables: 0``). No process group is needed."""
    from nicer_slam_tpu_torch.slam.state import OptimConfig, make_optimizer

    _, tcfg, _, _ = _torch_tiny.configs()
    model = tsm.SceneModel(tcfg, np.random.default_rng(0))
    whole = model.render.encoding.detach().clone()
    T = whole.shape[0]
    for shard, why in ((mesh.RayShard(0, 1, "sharded", 1 << 10), "1 rank"),
                       (mesh.RayShard(0, 2, "sharded"), f"{T} rows < {1 << 22}"),
                       (mesh.RayShard(0, 2, "psum_bf16", 1 << 10), None)):
        assert mesh.shard_color_grid(model, shard) == 0
        assert model.render.encoding.shape[0] == T
        assert mesh.sharded_tables(model, shard) == set()
        out = capsys.readouterr().out
        assert (f"sharded_tables: 0 ({why})" in out) if why else out == ""
    shard = mesh.RayShard(1, 2, "sharded", 1 << 10)
    with pytest.raises(ValueError, match="shard_color_grid"):
        mesh.sharded_tables(model, shard)
    assert mesh.shard_color_grid(model, shard) == 1
    table = model.render.encoding
    assert torch.equal(table, whole[T // 2:]) and model.render.color_shard == shard
    assert mesh.sharded_tables(model, shard) == {id(table)}
    assert mesh.bf16_tables(model, shard) == set()
    opt = make_optimizer(OptimConfig(), model)
    group = next(g for g in opt.param_groups if g["name"] == "color_grid")
    assert group["params"] == [table]


def _fogged(jparams, model):
    """The coarse SDF network's output bias lowered by 10 in both
    packages: the SDF is negative everywhere, the density 1/β everywhere,
    as in a map that has fogged."""
    b = np.asarray(jparams["implicit"]["coarse"]["lins"][1]["b"]).copy()
    b[0] -= 10.0
    jparams["implicit"]["coarse"]["lins"][1]["b"] = jnp.asarray(b)
    with torch.no_grad():
        model.implicit.coarse.lins[1].b[0] -= 10.0


def test_extrapolation_nan_is_the_algorithms(tmp_path):
    """Seed 0's 250-frame long run gave a NaN extrapolation PSNR.
    Its held-out cameras, rebuilt as eval_rendering.prealign_eval_poses
    builds them from the run's poses (LONG_SEQ_TORCH_GUARDED_s0_poses.npz),
    stand outside the cube from view 4 on (the est trajectory is 0.32 of
    the GT's scale), so some rays exit the cube behind the camera: far < 0
    = near, and the prepass samples run backwards. Their free energies are
    negative, and where σ · |far| > log(FLT_MAX) ≈ 88.72 the prepass's
    transmittance exp(-cumsum) overflows to inf, the pdf sums inf and -inf,
    and the ray's colour, depth and normal are NaN. Both packages give NaN
    on the same rays of a fogged map (density 1/β_max off the voxel grid,
    β_max = A + C), and on none with the tiny weights as drawn; every other
    pixel agrees within 1e-4."""
    from nicer_slam_tpu_torch.datasets.scene_dataset import SLAMDataset
    from nicer_slam_tpu_torch.datasets.synthetic import generate_eval
    from nicer_slam_tpu_torch.evaluation.eval_rendering import prealign_eval_poses

    jcfg, tcfg, _, _ = _torch_tiny.configs()
    H, W = tcfg.H, tcfg.W
    data = str(tmp_path / "Synthetic")
    generate_eval(data, scan_id=1, n_views=8, H=H, W=W, world_scale=3.0)
    ev = SLAMDataset(data_dir=data + "_eval", img_res=[H, W], scan_id=1, n_images=8)
    with np.load(os.path.join(REPO, "LONG_SEQ_TORCH_GUARDED_s0_poses.npz")) as z:
        keys, est, gt = z["keys"], z["est"], z["gt"]
    gt_all = [np.eye(4, dtype=np.float32)] * (int(keys.max()) + 1)
    for k, g in zip(keys, gt):
        gt_all[int(k)] = g
    poses = prealign_eval_poses({int(k): e for k, e in zip(keys, est)}, gt_all,
                                np.stack(ev.gt_pose_all))
    assert np.abs(poses[4:, :3, 3]).max() > 1.0              # outside the cube
    c2w = poses[4].astype(np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.9 * W
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0

    pix = torch.arange(H * W)
    uv = torch.stack([pix % W, pix // W], -1).to(torch.float32)
    c2w_t, K_t = torch.from_numpy(c2w), torch.from_numpy(K)
    rd, ro, _ = rays_from_uv(uv, c2w_t[None].expand(H * W, 4, 4), K_t[None].expand(H * W, 4, 4))
    _, far = near_far_from_cube(ro, rd, tcfg.sampler.scene_bounding_sphere,
                                tcfg.sampler.near, tcfg.sampler.uniform_far)
    far = far[:, 0].numpy().reshape(H, W)
    sigma_max = 1.0 / np.float32(tdens.BETA_A + tdens.BETA_C)
    overflow = sigma_max * -far > np.log(np.finfo(np.float32).max)
    assert (far < 0).sum() > overflow.sum() > 0

    vox = np.random.default_rng(11).integers(0, 40, (16, 16, 16)).astype(np.float32)
    for fog in (False, True):
        jparams, model = _torch_tiny.models(jcfg, tcfg)
        if fog:
            _fogged(jparams, model)
        out_j = jrender.render_image(jcfg, jparams, jnp.asarray(vox), c2w, K, chunk=160,
                                     key=jax.random.PRNGKey(0))
        out_t = trender.render_image(tcfg, model, torch.from_numpy(vox), c2w, K, chunk=160)
        for k in ("rgb", "depth", "normal"):
            bad_j, bad_t = ~np.isfinite(out_j[k]), ~np.isfinite(out_t[k])
            if bad_j.ndim == 3:
                bad_j, bad_t = bad_j.any(-1), bad_t.any(-1)
            np.testing.assert_array_equal(bad_t, bad_j, err_msg=k)
            np.testing.assert_array_equal(bad_t, overflow if fog else np.zeros_like(overflow),
                                          err_msg=k)
            ok = ~bad_t
            np.testing.assert_allclose(out_t[k][ok], out_j[k][ok], rtol=0, atol=1e-4,
                                       err_msg=k)
