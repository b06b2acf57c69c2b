"""The SLAM loop of the torch port with the JAX package's default exact
prepass and the model options, on the CPU:

  * one exact-prepass map_step with BA against the JAX package's, with warp
    patches [1, 5] under the SSIM warp loss and exposure, and one
    exact-prepass track_frame (exposure on, learned β), each to the
    tolerances of tests/test_torch_slice.py (whose cases these reuse);
    tracking renders with frame index 0, as the JAX package does;
  * the port's runner and CLI on tests/test_slam_e2e.py's TINY_CONF, which
    leaves prepass_mode unset (exact), and on its per_image_code and
    model_exposure variants, 3 frames each: finite poses, the frozen
    per-image codes unchanged, no density cache, and a model checkpoint
    the JAX package reads, whose tree loads back into the port.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicer_slam_tpu import config as jconfig
from nicer_slam_tpu.models import scene_model as jsm
from nicer_slam_tpu.slam import checkpoint as jckpt
from nicer_slam_tpu.slam.checkpoint import _flatten_pytree
from nicer_slam_tpu_torch.models import scene_model as tsm
from nicer_slam_tpu_torch.slam import tracking as ttrack
from nicer_slam_tpu_torch.slam.checkpoint import params_from_numpy, params_to_numpy

from test_slam_e2e import TINY_CONF
from test_torch_options import BETA_SCALE, options_configs
from test_torch_slice import _map_step_case, _track_frame_case, scene  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


def test_exact_map_step_with_ssim_patches_and_exposure_matches_jax(scene):  # noqa: F811
    """48 rays in 6 prepass chunks of 8, warp patches 1 and 5 (SSIM at 5),
    exposure; the β scale keeps every ray clear of the u = 1 tie (see
    test_torch_options.BETA_SCALE). The draw is the first whose rays' 5 x 5
    patches stay off pixel row and column 0 (the in-bounds hazard of
    test_torch_slice). The monocular depth term is off: on this draw its
    per-slot least-squares fit has 3 and 2 rays, so it is nearly exact and
    its residual is float32 rounding (3.8e-5 in the port, 8.5e-6 in the
    JAX package, in a loss of 0.41), and so are the SDF gradients it feeds
    (each package then 0.5-1.5 % off a float64 run on the coarse MLP's
    biases; with the term off, 1.4e-6)."""
    _map_step_case(scene, color_topk=0, cfgs=options_configs(),
                   loss_edits=dict(warp_loss_type="ssim", depth_weight=0.0),
                   beta_scale=BETA_SCALE)


def _laplace_and_frame0_code(jparams, model):
    """The learned β at 0.5 (prepass densities under ~2: no u = 1 tie) and a
    frame-0 exposure code unlike the others (what tracking must read)."""
    code = np.array([0.3, -0.2, 0.1, 0.05], np.float32)
    jparams["density"]["beta"] = jnp.asarray(0.5, jnp.float32)
    jparams["render"]["embeddings"] = jparams["render"]["embeddings"].at[0].set(code)
    with torch.no_grad():
        model.density["beta"].fill_(0.5)
        model.render.embeddings[0] = torch.from_numpy(code)
    return jparams


def test_exact_track_frame_with_exposure_matches_jax(scene):  # noqa: F811
    """Five iterations with the exact prepass, the learned β and exposure;
    then the quirk the port keeps: every ray renders as frame 0, so the
    tracked frame's own code (frame 2) changes nothing and frame 0's does."""
    jcfg, tcfg = (c._replace(density_method="volsdf_laplace") for c in options_configs("1"))
    tcfg, model, (tr, loss), args, kwargs, best = _track_frame_case(
        scene, 0, cfgs=(jcfg, tcfg), edit=_laplace_and_frame0_code)

    def track_with_code(row, value):
        with torch.no_grad():
            saved = model.render.embeddings[row].clone()
            model.render.embeddings[row] = value
        try:
            return ttrack.track_frame(tcfg, tr, loss, model, *args, **kwargs)[0]
        finally:
            with torch.no_grad():
                model.render.embeddings[row] = saved

    assert torch.equal(track_with_code(2, torch.full((4,), 0.7)), best)
    assert not torch.equal(track_with_code(0, torch.full((4,), 0.7)), best)


# ---------------------------------------------------------------------------
# the runner on TINY_CONF
# ---------------------------------------------------------------------------

VARIANTS = {"exact": [],
            "per_image_code": [("per_image_code = false", "per_image_code = true")],
            "model_exposure": [("per_image_code = false",
                                "per_image_code = false  model_exposure = true")]}


@pytest.fixture(scope="module")
def tiny_scan(tmp_path_factory):
    from nicer_slam_tpu_torch.datasets.synthetic import generate

    data_dir = str(tmp_path_factory.mktemp("tiny_options") / "Synthetic")
    generate(data_dir, scan_id=1, n_frames=3, H=60, W=80, world_scale=3.0,
             keyframe_every=10, with_flow=True)
    return data_dir


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_runner_on_tiny_conf(variant, tiny_scan, tmp_path):
    """The port's CLI entry point (exp_runner.main, vis hook included) on
    TINY_CONF as the JAX package's tests write it, 3 frames of 3 tracking
    and 3 mapping iterations."""
    from nicer_slam_tpu_torch.training import exp_runner

    text = TINY_CONF.format(data_dir=tiny_scan, H=60, W=80, n_images=3, map_iters=3,
                            track_iters=3)
    for old, new in VARIANTS[variant]:
        assert text.count(old) == 1
        text = text.replace(old, new)
    assert "prepass_mode" not in text
    conf = str(tmp_path / "tiny.conf")
    with open(conf, "w") as f:
        f.write(text)
    r = exp_runner.main(["--conf", conf, "--root_dir", str(tmp_path), "--device", "cpu"])
    assert r.scene_cfg.sampler.prepass_mode == "exact" and r.density_cache is None
    assert "cache" not in r.timer.summary()
    assert sorted(r.est_pose_all) == [0, 1, 2]
    assert all(np.isfinite(p).all() for p in r.est_pose_all.values())
    vis = os.listdir(r.plots_dir)
    assert any(v.startswith("rendering_") for v in vis)
    fresh = tsm.SceneModel(r.scene_cfg, np.random.default_rng(0))
    if variant != "exact":
        # frozen, as in the JAX package: bit for bit the initial codes
        width = 32 if variant == "per_image_code" else 4
        assert r.model.render.embeddings.shape == (3, width)
        assert torch.equal(r.model.render.embeddings.detach(), fresh.render.embeddings)
    if variant == "model_exposure":
        # the exposure MLP trains with the color MLP
        assert not torch.equal(r.model.render.exp_lins[0].v.detach(),
                               fresh.render.exp_lins[0].v)
    # the model file, read by the JAX package into its own tree of this conf
    c = jconfig.parse_file(conf)
    template = jsm.init_scene_params(
        np.random.default_rng(0), jsm.scene_config_from_conf(c.get_config("model"), (60, 80), 3))
    params, voxels, fidx = jckpt.load_model(
        os.path.join(r.checkpoints_path, "ModelParameters"), template)
    assert fidx == 2 and voxels.sum() > 0
    flat_j, flat_t = _flatten_pytree(params), params_to_numpy(r.model)
    assert sorted(flat_j) == sorted(flat_t)
    for k in flat_j:
        np.testing.assert_array_equal(np.asarray(flat_j[k]), flat_t[k])
    # and back: the JAX package's tree into a port model of another seed
    other = tsm.SceneModel(r.scene_cfg, np.random.default_rng(1))
    params_from_numpy({k: np.asarray(v) for k, v in flat_j.items()}, other)
    for k, v in params_to_numpy(other).items():
        np.testing.assert_array_equal(v, flat_t[k])
