"""The SLAM slice of the torch port against the JAX package, on the CPU:
one map_step with BA, flow edges, warp and fractional slot confidence, and a
5-iteration track_frame, each with every sample colored and with colour
top-k (the flagship configuration's color_topk), on shrunk grids with the
JAX package's random draws replayed (tests/_torch_draws.py) and the same
prepass cache. Then the CLI end to end, and checkpoints in both directions.

Tolerances: loss terms rtol 1e-4; color-side gradients rtol 1e-4 with an
atol of 1e-4 of the largest entry of each parameter (float32 sums in
different orders); SDF-side gradients relative L2 5e-4 against a float64 run
of the port and 2e-3 against the JAX package (see the test: the steep
density amplifies float32 rounding, the JAX package's more than the
port's); poses after tracking atol 1e-5. Adam-updated parameters are
compared only where the JAX gradient is above 1e-2 of the parameter's
largest: with eps 1e-15, a gradient of rounding size still takes a full
step of size lr, in whichever direction its rounding noise points.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu.models import scene_model as jsm
from nicer_slam_tpu.slam import checkpoint as jckpt
from nicer_slam_tpu.slam import mapping as jmap
from nicer_slam_tpu.slam import state as jstate
from nicer_slam_tpu.slam import tracking as jtrack
from nicer_slam_tpu.slam.checkpoint import _flatten_pytree
from nicer_slam_tpu.utils.camera import tensor_from_camera_np
from nicer_slam_tpu_torch.models import scene_model as tsm
from nicer_slam_tpu_torch.slam import mapping as tmap
from nicer_slam_tpu_torch.slam import state as tstate
from nicer_slam_tpu_torch.slam import tracking as ttrack
from nicer_slam_tpu_torch.slam.checkpoint import jax_layout

import _torch_draws
import _torch_tiny
from test_slam_e2e import FLOW_REGIME_EXTRA, TINY_CONF
from test_torch_ops import _blocked_cache
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 24, 32
T = torch.from_numpy


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30))


def _close(a, b, rtol=1e-4, rel_atol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rel_atol * max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from nicer_slam_tpu_torch.datasets.synthetic import generate
    from nicer_slam_tpu_torch.datasets.scene_dataset import SLAMDataset

    d = str(tmp_path_factory.mktemp("slice") / "Synthetic")
    generate(d, scan_id=1, n_frames=5, H=H, W=W, keyframe_every=4, with_flow=True)
    ds = SLAMDataset(data_dir=d, img_res=[H, W], scan_id=1, use_gt_depth=True,
                     n_images=5)
    jcfg, tcfg, jloss, tloss = _torch_tiny.configs(H, W, n_images=5)
    jparams, model = _torch_tiny.models(jcfg, tcfg)
    vox = np.random.default_rng(0).integers(0, 30, (16, 16, 16)).astype(np.float32)
    # A thin, smooth prepass density: transmittance stays well above 0 to the
    # far end of every ray, so the inverse CDF has no tie at u = 1 (where a
    # sharp surface leaves the last pdf bin under 1e-5 and the bin choice
    # follows the last bit of the cdf total; see test_torch_ops). Both
    # packages then place the same samples and the comparison is exact.
    res = tcfg.sampler.prepass_cache_res
    g = np.linspace(-1, 1, res)
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    vol = (0.3 + 0.2 * np.cos(3 * gx) * np.cos(2 * gy) * np.cos(gz)).astype(np.float32)
    cache = T(vol.reshape(-1))
    blocked = jnp.asarray(_blocked_cache(vol))
    return dict(ds=ds, jcfg=jcfg, tcfg=tcfg, jloss=jloss, tloss=tloss, jparams=jparams,
                model=model, vox=vox, cache=cache, blocked=blocked)


def _adam_mu(opt_state):
    """{param path: first moment} from the JAX package's optax state."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(k, "name", getattr(k, "key", getattr(k, "idx", None)))
                 for k in path]
        if "mu" in names:
            out["/".join(str(n) for n in names[names.index("mu") + 1:])] = np.asarray(leaf)
    return out


# colour top-k of the top-k cases: S = 12 + 6 + 2 = 20 samples per ray
TOPK = 6


def test_map_step_with_ba_matches_jax(scene):
    _map_step_case(scene, color_topk=0)


def test_map_step_with_ba_and_color_topk_matches_jax(scene):
    _map_step_case(scene, color_topk=TOPK)


def _map_step_case(scene, color_topk, cfgs=None, loss_edits=None, beta_scale=None):
    """One map_step of both packages on the scene's frames 0 and 4. By
    default the scene's configuration with its prepass cache; ``cfgs`` (a
    (jax, torch) SceneConfig pair, fresh seed-0 weights) with the exact
    prepass, whose densities ``beta_scale`` widens; ``loss_edits`` replace
    fields of both packages' mapping LossConfig."""
    s = scene
    ds = s["ds"]
    exact = cfgs is not None
    jcfg, tcfg = cfgs if exact else (s["jcfg"], s["tcfg"])
    jcfg = jcfg._replace(color_topk=color_topk)
    tcfg = tcfg._replace(color_topk=color_topk)
    jparams0 = _torch_tiny.models(jcfg, tcfg)[0] if exact else s["jparams"]
    jloss = s["jloss"][0]._replace(**(loss_edits or {}))
    tloss = s["tloss"][0]._replace(**(loss_edits or {}))
    blocked, cache = (None, None) if exact else (s["blocked"], s["cache"])
    frames, Smax, R = [0, 4], 4, 48
    rows = [ds.frame(f) for f in frames]
    rgb = np.stack([np.clip(r["rgb"] * 255 + 0.5, 0, 255).astype(np.uint8) for r in rows])
    depth = np.stack([r["depth"] for r in rows]).astype(np.float16)
    normal = np.stack([r["normal"] for r in rows]).astype(np.float16)
    gtd = np.stack([r["gt_depth"] for r in rows]).astype(np.float16)
    mask = np.stack([r["mask"] for r in rows])
    flow01, ok01 = ds.flow_pair(0, 4)
    flow10, ok10 = ds.flow_pair(4, 0)
    flows = np.stack([np.where(o.reshape(-1, 1), f.reshape(-1, 2), 0)
                      for f, o in ((flow01, ok01), (flow10, ok10))]).astype(np.float16)
    occ = np.stack([ok01.reshape(-1), ok10.reshape(-1)])
    intr = np.tile(np.eye(4, dtype=np.float32), (Smax, 1, 1))
    intr[:2] = [ds.intrinsics_all[f] for f in frames]
    q = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (Smax, 1))
    for i, f in enumerate(frames):
        q[i] = tensor_from_camera_np(ds.gt_pose_all[f])
    q[1, 4:] += np.array([0.02, -0.01, 0.015], np.float32)     # a tracking error
    slot_rows = np.array([0, 1, 0, 0])
    conf = np.array([1.0, 0.6, 1.0, 1.0], np.float32)          # fractional weights
    # A warp pixel in column or row 0 projects onto the border of its own
    # frame, where the warp's in-bounds test (u/W*2-1 > -1) compares a
    # rounding-size number with 0: jitted XLA and eager code may disagree.
    # Take the first key whose rays' patches (ps // 2 pixels around each
    # ray) avoid those pixels.
    margin = max(tcfg.patchsizes) // 2 + 1
    pix = np.asarray(jax.vmap(lambda k: jax.random.randint(jax.random.split(k)[0], (R,), 0,
                                                           H * W))(
        jax.vmap(jax.random.PRNGKey)(jnp.arange(20000))))
    clear = np.all((pix % W >= margin) & (pix // W >= margin), axis=1)
    key = jax.random.PRNGKey(int(np.argmax(clear)))
    assert clear.any()

    map_j = jmap.MapConfig(num_pixels=R, max_slots=Smax, max_edges=2, BA_cam_lr=1e-3)
    refs_j = jmap.MapBatchRefs(
        slot_rows=jnp.asarray(slot_rows, jnp.int32), frame_ids=jnp.asarray([0, 4, 0, 0], jnp.int32),
        n_valid=jnp.asarray(2, jnp.int32), intrinsics=jnp.asarray(intr),
        edge_idii=jnp.asarray([0, 1], jnp.int32), edge_idjj=jnp.asarray([1, 0], jnp.int32),
        edge_valid=jnp.asarray([True, True]), flow_imgs=jnp.asarray(flows),
        flow_occ=jnp.asarray(occ), slot_conf=jnp.asarray(conf))
    ocfg = jstate.OptimConfig(learning_rate=0.002, lr_factor_for_fine_grid=20.0,
                              lr_factor_for_coarse_grid=20.0, lr_factor_for_color_grid=5.0)
    jparams = jax.tree.map(jnp.array, jparams0)
    optimizer = jstate.make_optimizer(ocfg, jparams)
    p_j, st_j, vox_j, q_j, terms_j = jmap.map_step(
        jcfg, map_j, jloss, jparams, optimizer.init(jparams),
        jnp.asarray(s["vox"]), optimizer, jnp.asarray(q), refs_j, jnp.asarray(rgb),
        jnp.asarray(depth), jnp.asarray(normal), jnp.asarray(gtd), jnp.asarray(mask), key,
        blocked, None if beta_scale is None else jnp.asarray(beta_scale, jnp.float32),
        stage="fine", color_stage="highfreq", ba=True, is_first_frame=False, use_flow=True)

    def port_step(dtype):
        """The port's map_step on the same inputs, with its float inputs and
        parameters in ``dtype``."""
        f = lambda a: T(a).to(dtype)
        model = tsm.SceneModel(tcfg, np.random.default_rng(0)).to(dtype)
        opt_t = tstate.make_optimizer(tstate.OptimConfig(*ocfg), model)
        refs_t = tmap.MapBatchRefs(
            slot_rows=T(slot_rows), frame_ids=T(np.array([0, 4, 0, 0])), n_valid=2,
            intrinsics=f(intr), edge_idii=T(np.array([0, 1])), edge_idjj=T(np.array([1, 0])),
            flow_imgs=T(flows), flow_occ=T(occ), slot_conf=f(conf))
        store = tmap.FrameData(*map(T, (rgb, depth, normal, gtd, mask)))
        draws = _torch_draws.map_draws(key, tcfg, R)
        rd = draws.render
        draws = draws._replace(render=rd._replace(
            t_rand=rd.t_rand.to(dtype), eik_uniform=rd.eik_uniform.to(dtype),
            eik_nei=rd.eik_nei.to(dtype)))
        out = tmap.map_step(
            tcfg, tmap.MapConfig(num_pixels=R, max_slots=Smax, BA_cam_lr=1e-3), tloss,
            model, opt_t, f(s["vox"]), f(q), refs_t, store, draws,
            None if cache is None else cache.to(dtype), beta_scale,
            stage="fine", color_stage="highfreq", ba=True, is_first_frame=False)
        return (model,) + out

    model, vox_t, q_t, terms_t = port_step(torch.float32)
    model64 = port_step(torch.float64)[0]
    # the port's [T, C] tables and their gradients in the JAX package's [C, T]
    grads64 = {n: jax_layout(n.replace(".", "/"), p.grad)
               for n, p in model64.named_parameters() if p.grad is not None}

    for k, v in terms_j.items():
        _close(terms_t[k], v, rel_atol=1e-7)
    for k, w in (("flow_loss", tloss.flow_weight), ("warp_loss", tloss.warp_loss_weight),
                 ("eikonal_loss", tloss.eikonal_weight), ("depth_loss", tloss.depth_weight),
                 ("normal_cos", tloss.normal_cos_weight)):
        assert float(terms_t[k]) > 0 or w == 0, k     # every weighted term is live
    np.testing.assert_array_equal(vox_t.numpy(), np.asarray(vox_j))

    # gradients: the JAX first Adam moment after one step is 0.1 * grad
    mu = _adam_mu(st_j)
    new_j = _flatten_pytree(p_j)
    for name, p in model.named_parameters():
        key_ = name.replace(".", "/")
        if key_ not in mu:
            # frozen: the fine MLP and the per-image / exposure codes
            assert not p.requires_grad and key_.startswith(("implicit/fine/lins",
                                                            "render/embeddings"))
            np.testing.assert_array_equal(jax_layout(key_, p), new_j[key_])
            continue
        g_j = mu[key_] / np.float32(0.1)
        g_t = jax_layout(key_, p.grad)
        if key_.startswith("render/"):
            _close(g_t, g_j)
        else:
            # SDF-side gradients pass through the Laplace density (beta about
            # 1.4e-2 at these voxel counts), which amplifies float32 rounding
            # of the SDF by ~1/beta. The port's float64 run is the arbiter:
            # measured, the port's float32 gradients are within 1.6e-4 of it
            # (relative L2) and the JAX package's within 8.4e-4.
            assert _rel_l2(g_t, grads64[name]) <= 5e-4, key_
            assert _rel_l2(g_j, grads64[name]) <= 2e-3, key_
            assert _rel_l2(g_t, g_j) <= 2e-3, key_
        big = np.abs(g_j) > 1e-2 * np.abs(g_j).max()
        np.testing.assert_allclose(jax_layout(key_, p)[big], new_j[key_][big], atol=1e-6)
    # BA: fresh-Adam sign step, lr 1e-3, on the two valid slots
    step_j = np.asarray(q_j) - q
    moved = np.abs(step_j) > 0.5e-3
    assert moved[:2].sum() >= 10 and not moved[2:].any()
    np.testing.assert_allclose(q_t.numpy()[moved], np.asarray(q_j)[moved], atol=1e-6)


def test_track_frame_matches_jax(scene):
    _track_frame_case(scene, color_topk=0)


def test_track_frame_with_color_topk_matches_jax(scene):
    _track_frame_case(scene, color_topk=TOPK)


def _track_frame_case(scene, color_topk, cfgs=None, edit=None):
    """Five tracking iterations of both packages on the scene's frame 2. By
    default the scene's configuration with its prepass cache; ``cfgs`` (a
    (jax, torch) SceneConfig pair) with the exact prepass on fresh seed-0
    weights, which ``edit(jparams, model)`` may change first. Returns the
    port's inputs and result: (tcfg, model, track_frame's arguments after
    the model, best_q)."""
    s = scene
    ds = s["ds"]
    exact = cfgs is not None
    jcfg, tcfg = cfgs if exact else (s["jcfg"], s["tcfg"])
    jcfg = jcfg._replace(color_topk=color_topk)
    tcfg = tcfg._replace(color_topk=color_topk)
    if exact:
        jparams, model = _torch_tiny.models(jcfg, tcfg)
        if edit is not None:
            jparams = edit(jparams, model)
    else:
        jparams, model = s["jparams"], s["model"]
    blocked, cache = (None, None) if exact else (s["blocked"], s["cache"])
    frame = 2
    rgb = np.clip(ds.frame(frame)["rgb"] * 255 + 0.5, 0, 255).astype(np.uint8)
    K = ds.intrinsics_all[frame]
    q0 = tensor_from_camera_np(ds.gt_pose_all[frame])
    q0[4:] += np.array([0.01, 0.02, -0.01], np.float32)
    tr_j = jtrack.TrackConfig(num_iters=5, num_pixels=64, cam_lr=0.005, lr_step_size=2,
                              lr_gamma=0.5)
    key = jax.random.PRNGKey(5)
    best_j, final_j, aux_j = jtrack.track_frame(
        jcfg, tr_j, s["jloss"][1], jparams, jnp.asarray(s["vox"]), jnp.asarray(rgb),
        jnp.asarray(K), jnp.asarray(q0), key, blocked)
    tr_t = ttrack.TrackConfig(*tr_j)
    args = (T(s["vox"]), T(rgb), T(K), T(q0))
    kwargs = dict(density_cache=cache, draws=_torch_draws.track_draws(key, tcfg, tr_t))
    best_t, final_t, aux_t = ttrack.track_frame(tcfg, tr_t, s["tloss"][1], model, *args,
                                                **kwargs)
    _close(aux_t["losses"].numpy(), np.asarray(aux_j["losses"]))
    np.testing.assert_allclose(final_t.numpy(), np.asarray(final_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(best_t.numpy(), np.asarray(best_j), atol=1e-5, rtol=0)
    assert np.abs(final_t.numpy() - q0).max() > 1e-3        # the pose moved
    # tracking takes no map gradient and leaves requires_grad as it was
    assert all(p.grad is None for p in model.parameters())
    assert model.implicit.coarse.encoding.requires_grad
    return tcfg, model, (tr_t, s["tloss"][1]), args, kwargs, best_t


def _tiny_conf(tmp_path, data_dir, n_images):
    conf = TINY_CONF.format(data_dir=data_dir, H=H, W=W, n_images=n_images,
                            map_iters=4, track_iters=3)
    conf = conf.replace("N_samples_extra = 8 }",
                        "N_samples_extra = 8  prepass_mode = cached  prepass_cache_res = 16 }")
    path = str(tmp_path / "tiny.conf")
    with open(path, "w") as f:
        f.write(conf)
    return path


def _jax_template(conf_path, n_images):
    from nicer_slam_tpu import config

    c = config.parse_file(conf_path)
    cfg = jsm.scene_config_from_conf(c.get_config("model"), (H, W), n_images)
    return jsm.init_scene_params(np.random.default_rng(0), cfg)


def test_exp_runner_cli_writes_checkpoints_the_jax_package_reads(scene, tmp_path):
    data_dir = os.path.dirname(scene["ds"].instance_dir)
    conf = _tiny_conf(tmp_path, data_dir, 5)
    # one torch thread: the suite runs files in parallel workers, where a
    # many-threaded subprocess stalls on its descheduled threads
    out = subprocess.run(
        [sys.executable, "-m", "nicer_slam_tpu_torch.training.exp_runner", "--conf", conf,
         "--root_dir", str(tmp_path), "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    run = next(os.path.join(r, "checkpoints") for r, ds_, _ in os.walk(tmp_path)
               if "checkpoints" in ds_)
    params, voxels, fidx = jckpt.load_model(os.path.join(run, "ModelParameters"),
                                            _jax_template(conf, 5))
    assert fidx == 4 and voxels.shape == (64, 64, 64) and voxels.sum() > 0
    assert all(np.isfinite(np.asarray(l)).all() for l in jax.tree.leaves(params))
    est, gt, _ = jckpt.load_poses(os.path.join(run, "PoseParameters"))
    assert sorted(est) == list(range(5)) and len(gt) == 5
    assert all(np.isfinite(p).all() for p in est.values())
    assert os.path.exists(os.path.join(run, "OptimizerParameters", "latest.npz"))


def test_jax_checkpoint_restores_into_the_port_runner(scene, tmp_path):
    from nicer_slam_tpu_torch.slam.checkpoint import params_to_numpy
    from nicer_slam_tpu_torch.slam.runner import SLAMRunner

    data_dir = os.path.dirname(scene["ds"].instance_dir)
    conf = _tiny_conf(tmp_path, data_dir, 5)
    params = jax.tree.map(lambda a: a + 0.5, _jax_template(conf, 5))
    run = tmp_path / "exps" / "tiny_1" / "2026_01_01_00_00_00test" / "checkpoints"
    vox = np.arange(64 ** 3, dtype=np.float32).reshape(64, 64, 64) % 7
    jckpt.save_model(str(run / "ModelParameters"), params, vox, 3)
    poses = {i: np.asarray(scene["ds"].gt_pose_all[i]) for i in range(4)}
    jckpt.save_poses(str(run / "PoseParameters"), poses, scene["ds"].gt_pose_all, 3)
    r = SLAMRunner(conf=conf, root_dir=str(tmp_path), is_continue=True, quiet=True,
                   device="cpu")
    assert r.start_frame_idx == 3
    flat = params_to_numpy(r.model)
    for k, v in _flatten_pytree(params).items():
        np.testing.assert_array_equal(flat[k], v)
    np.testing.assert_array_equal(r.voxels.numpy(), vox)
    np.testing.assert_array_equal(r.est_pose_all[2], poses[2])


def test_runner_global_window_maps_with_live_flow_edges(tmp_path):
    """From global_window_start on, the port's runner draws the global
    keyframe window and feeds the flow edges loaded from disk into map_step:
    the frame-8 mapping call has edges and a positive, finite flow loss."""
    from nicer_slam_tpu_torch.datasets.synthetic import generate
    from nicer_slam_tpu_torch.slam.runner import SLAMRunner

    data_dir = str(tmp_path / "Synthetic")
    generate(data_dir, scan_id=1, n_frames=10, H=H, W=W, keyframe_every=2,
             flow_thresh=6, with_flow=True)
    body = open(_tiny_conf(tmp_path, data_dir, 10)).read()
    conf = str(tmp_path / "flow.conf")
    with open(conf, "w") as f:
        f.write(FLOW_REGIME_EXTRA.format(map_iters=4) + body[body.index("\ntrain {"):])
    r = SLAMRunner(conf=conf, root_dir=str(tmp_path), quiet=True, device="cpu")
    terms, edges = {}, {}
    for frame_idx in range(r.n_images):
        r.track(frame_idx)
        if frame_idx % r.mapping_every_frame == 0:
            terms[frame_idx] = r.map(frame_idx)
            edges[frame_idx] = 0 if r._edge_refs is None else r._edge_refs[0].numel()
    assert edges[0] == edges[4] == 0 and edges[8] > 0, edges
    fl = float(terms[8]["flow_loss"])
    assert np.isfinite(fl) and fl > 0.0, fl
    assert np.isfinite(float(terms[8]["loss"]))
