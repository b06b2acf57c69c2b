"""The optimizer file across the packages, on the CPU: the port writes and
reads the JAX package's optax layout (``leaf_<i>``, ``keypaths``,
``frame_idx``; nicer_slam_tpu/slam/checkpoint.py:68-105).

  * the port's keypaths and leaf shapes are ``_opt_state_keypaths`` and the
    leaves of the JAX optimizer's state for the same model (the shrunk
    model with its colour grid, without it and with per-image codes, with
    exposure, with the learned β);
  * a port run directory (the runner on tests/test_slam_e2e.py's
    TINY_CONF, 3 frames) resumes in the JAX package's runner with its Adam
    state bit for bit, and a run directory the JAX package's checkpoint
    functions wrote (after two optax updates) resumes in the port's runner
    the same way;
  * after each resume one Adam step on the same gradients in both packages
    gives parameters within 1e-6 (the bias corrections are computed in
    float32 by optax and in float64 by torch);
  * a file of the port's earlier layout still loads bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu import config as jconfig
from nicer_slam_tpu.models import scene_model as jsm
from nicer_slam_tpu.slam import checkpoint as jckpt
from nicer_slam_tpu.slam import state as jstate
from nicer_slam_tpu.slam.checkpoint import _flatten_pytree, _opt_state_keypaths
from nicer_slam_tpu.slam.runner import SLAMRunner as JaxRunner
from nicer_slam_tpu_torch.models import scene_model as tsm
from nicer_slam_tpu_torch.slam import checkpoint as tckpt
from nicer_slam_tpu_torch.slam import state as tstate
from nicer_slam_tpu_torch.slam.runner import SLAMRunner as PortRunner

import _torch_tiny
from test_slam_e2e import TINY_CONF
from _torch_threads import one_torch_thread  # noqa: F401



VARIANTS = {
    "color_grid": [],
    "per_image_code": [("mode = \"idr\"  d_in = 9", "mode = \"nerf\"  d_in = 3"),
                       ("per_image_code = false\n        use_grid_feature = true",
                        "per_image_code = true\n        use_grid_feature = false")],
    "model_exposure": [("per_image_code = false",
                        "per_image_code = false  model_exposure = true")],
    "volsdf_laplace": [('density_method = "volsdf_gridpredefined"',
                        'density_method = "volsdf_laplace"')],
}


def _configs(variant):
    text = _torch_tiny.MODEL_CONF
    for old, new in VARIANTS[variant]:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    c = jconfig.parse_string(text).get_config("model")
    return (jsm.scene_config_from_conf(c, (24, 32), 8),
            tsm.scene_config_from_conf(c, (24, 32), 8))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_keypaths_and_leaves_are_the_jax_optimizers(variant, tmp_path):
    jcfg, tcfg = _configs(variant)
    jparams, model = _torch_tiny.models(jcfg, tcfg)
    jopt = jstate.make_optimizer(jstate.OptimConfig(), jparams)
    jst = jopt.init(jparams)
    opt = tstate.make_optimizer(tstate.OptimConfig(), model)
    assert [k for k, *_ in tckpt.optax_layout(model, opt)] == _opt_state_keypaths(jst)
    tckpt.save_optimizer(str(tmp_path), model, opt, 0)
    with np.load(tmp_path / "latest.npz") as d:
        leaves = jax.tree.leaves(jst)
        assert len(d.files) == len(leaves) + 2
        for i, leaf in enumerate(leaves):
            assert d[f"leaf_{i}"].shape == np.shape(leaf)
            assert d[f"leaf_{i}"].dtype == np.asarray(leaf).dtype
    # and the JAX package's reader takes the port's file
    back = jckpt.load_optimizer(str(tmp_path), jst)
    assert len(jax.tree.leaves(back)) == len(leaves)


def _grads(jparams, seed):
    """Random gradients for every parameter, in the JAX tree."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(np.shape(p))
                                              .astype(np.float32) * 0.01), jparams)


def _port_step(model, opt, jgrads):
    """One port Adam step with the JAX tree's gradients."""
    flat = _flatten_pytree(jgrads)
    for name, p in model.named_parameters():
        if p.requires_grad:
            path = name.replace(".", "/")
            p.grad = tckpt.port_layout(path, np.asarray(flat[path])).to(p.device)
    tstate.fill_missing_grads(opt)
    opt.step()


def _jax_step(jopt, jst, jparams, jgrads):
    import optax

    updates, jst = jopt.update(jgrads, jst, jparams)
    return optax.apply_updates(jparams, updates), jst


def _same_state(model, opt, jst):
    """The port optimizer's state in the optax layout is the JAX state's."""
    leaves = jax.tree.leaves(jst)
    for i, (key, group, field, param) in enumerate(tckpt.optax_layout(model, opt)):
        want = np.asarray(leaves[i])
        if field == "count":
            steps = {int(opt.state[p]["step"]) for p in
                     (q for g in opt.param_groups for q in g["params"]) if p in opt.state}
            assert steps <= {int(want)}, (key, steps, int(want))
            continue
        path, p = param
        got = tckpt.jax_layout(path, opt.state[p]["exp_avg" if field == "mu" else "exp_avg_sq"])
        np.testing.assert_array_equal(got, want, err_msg=key)


def _same_params(model, jparams, atol=1e-6):
    flat_j = _flatten_pytree(jparams)
    for k, v in tckpt.params_to_numpy(model).items():
        np.testing.assert_allclose(v, np.asarray(flat_j[k]), rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from nicer_slam_tpu_torch.datasets.synthetic import generate

    root = tmp_path_factory.mktemp("resume")
    data_dir = str(root / "Synthetic")
    generate(data_dir, scan_id=1, n_frames=3, H=60, W=80, world_scale=3.0,
             keyframe_every=10, with_flow=True)
    conf = str(root / "tiny.conf")
    with open(conf, "w") as f:
        f.write(TINY_CONF.format(data_dir=data_dir, H=60, W=80, n_images=3, map_iters=2,
                                 track_iters=2))
    return conf


def test_port_run_dir_resumes_in_jax(tiny, tmp_path):
    from nicer_slam_tpu_torch.training import exp_runner

    r = exp_runner.main(["--conf", tiny, "--root_dir", str(tmp_path), "--device", "cpu"])
    assert any(int(st["step"]) > 0 for st in r.optimizer.state.values())
    jr = JaxRunner(conf=tiny, root_dir=str(tmp_path), is_continue=True, quiet=True)
    assert jr.start_frame_idx == 2
    _same_state(r.model, r.optimizer, jr.opt_state)
    _same_params(r.model, jr.params, atol=0)
    g = _grads(jr.params, 5)
    jparams, _ = _jax_step(jr.optimizer, jr.opt_state, jr.params, g)
    _port_step(r.model, r.optimizer, g)
    _same_params(r.model, jparams)


def test_jax_run_dir_resumes_in_port(tiny, tmp_path):
    jr = JaxRunner(conf=tiny, root_dir=str(tmp_path), quiet=True)
    jparams, jst = jr.params, jr.opt_state
    for seed in (1, 2):
        jparams, jst = _jax_step(jr.optimizer, jst, jparams, _grads(jparams, seed))
    ck = jr.checkpoints_path
    jckpt.save_model(os.path.join(ck, "ModelParameters"), jparams, jr.voxels, 2)
    jckpt.save_optimizer(os.path.join(ck, "OptimizerParameters"), jst, 2)
    jckpt.save_poses(os.path.join(ck, "PoseParameters"),
                     {i: np.eye(4, dtype=np.float32) for i in range(3)},
                     jr.dataset.gt_pose_all, 2)
    r = PortRunner(conf=tiny, root_dir=str(tmp_path), is_continue=True, quiet=True,
                   device="cpu")
    assert r.start_frame_idx == 2 and r.rundir == jr.rundir
    _same_state(r.model, r.optimizer, jst)
    _same_params(r.model, jparams, atol=0)
    g = _grads(jparams, 3)
    jparams, _ = _jax_step(jr.optimizer, jst, jparams, g)
    _port_step(r.model, r.optimizer, g)
    _same_params(r.model, jparams)


def test_the_ports_earlier_layout_still_loads(tmp_path):
    """Run directories that the port wrote before it took the optax layout
    (``<param path>/{step,exp_avg,exp_avg_sq}``, tables' moments [C, T])
    still resume with their Adam state."""
    _, tcfg = _configs("color_grid")
    model = tsm.SceneModel(tcfg, np.random.default_rng(0))
    opt = tstate.make_optimizer(tstate.OptimConfig(), model)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.randn_like(p)
    opt.step()
    flat = {"frame_idx": np.asarray(3)}
    for name, p in tckpt._param_paths(model, opt):
        for k, v in opt.state[p].items():
            flat[f"{name}/{k}"] = (v.numpy() if k == "step" else tckpt.jax_layout(name, v))
    np.savez(tmp_path / "latest.npz", **flat)
    fresh = tstate.make_optimizer(tstate.OptimConfig(), model)
    tckpt.load_optimizer(str(tmp_path), model, fresh)
    for p in model.parameters():
        if p in opt.state:
            for k, v in opt.state[p].items():
                assert torch.equal(fresh.state[p][k], v), k
