"""The port's training tools against the JAX package's, on the CPU at tiny
sizes:

  * ``training/pretrain.py`` (tools/pretrain.py): the same rooms, points and
    initial weights from one numpy Generator; two steps of both on the
    shrunk model's networks (512 points) give the same losses (rtol 1e-5:
    float32 sums in other orders) and the same fine MLP (within 1e-5 of the
    largest weight of each array plus 1e-2 of the learning rate: the
    gradients differ by float32 rounding, and an Adam step moves a weight
    by lr·m/√v whatever its gradient's size, so near-zero arrays such as
    fresh biases differ by that rounding relative to lr, and a weight whose
    gradient is itself near rounding size (1 of 82,944 in the mono prior's
    second step, at 0.8 % of lr) by more); the written
    ``fine_lin{i}_{k}`` npz loads into both packages' runners;
  * ``training/train_mono_prior.py`` (tools/train_mono_prior.py): the same
    rendered scenes bit for bit, the same initial weights bit for bit, and
    two steps with the same batches give the same losses (rtol 1e-5) and
    weights (as above); the written flat npz
    loads into both packages' mono prior, whose outputs agree within 1e-5.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nicer_slam_tpu import config as jconfig
from nicer_slam_tpu.models import fields as jf
from nicer_slam_tpu.models import mono_prior as jmp
from nicer_slam_tpu.slam.runner import SLAMRunner as JaxRunner
from nicer_slam_tpu_torch.config import parse_string
from nicer_slam_tpu_torch.models import mono_prior as tmp_
from nicer_slam_tpu_torch.models import scene_model as tsm
from nicer_slam_tpu_torch.slam.runner import SLAMRunner as PortRunner
from nicer_slam_tpu_torch.training import pretrain as tpre
from nicer_slam_tpu_torch.training import train_mono_prior as tmono

import _torch_tiny
from _torch_threads import one_torch_thread  # noqa: F401



REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name: str):
    """tools/<name>.py as a module (its functions; nothing of it runs)."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a, b, lr, rel=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max() + 1e-2 * lr)


def test_pretrain_steps_match_jax_and_load_in_both(tmp_path):
    conf = tmp_path / "nets.conf"
    conf.write_text(_torch_tiny.MODEL_CONF)
    steps, batch, lr = 2, 512, 2e-3
    out = str(tmp_path / "pretrain.npz")
    hist = tpre.train(steps, batch, lr, str(conf), out, device="cpu")

    # the JAX tool's recipe (tools/pretrain.py main), step for step
    jtool = _jax_tool("pretrain")
    c = jconfig.parse_string(_torch_tiny.MODEL_CONF)
    cfg = jf.combine_config_from_conf(c.get_config("model.implicit_network"),
                                      c.get_int("model.feature_vector_size"))
    rng = np.random.default_rng(0)
    params = jf.init_combine(rng, cfg)
    opt = optax.adam(lr, b1=0.9, b2=0.99, eps=1e-15)
    state = opt.init(params)

    def loss_fn(p, pts, target):
        sdf, _, grad = jf.combine_get_outputs(cfg, p, pts, "fine")
        data = jnp.abs(sdf[:, 0] - target).mean()
        eik = ((jnp.linalg.norm(grad, axis=-1) - 1.0) ** 2).mean()
        return data + 0.05 * eik

    step = jax.jit(jax.value_and_grad(loss_fn))
    scene = jtool.random_scene_sdf(rng)
    port_rng = np.random.default_rng(0)
    tpre.make_networks(str(conf), port_rng)
    port_scene = tpre.random_scene_sdf(port_rng)
    for i in range(steps):
        if i % 200 == 0:
            scene, port_scene = jtool.random_scene_sdf(rng), tpre.random_scene_sdf(port_rng)
        pts = rng.uniform(-1, 1, (batch, 3)).astype(np.float32)
        assert np.array_equal(scene(pts), port_scene(pts))
        loss, g = step(params, jnp.asarray(pts), jnp.asarray(scene(pts).astype(np.float32)))
        np.testing.assert_allclose(hist[i]["loss"], float(loss), rtol=1e-5)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        port_rng.uniform(-1, 1, (batch, 3))
    with np.load(out) as d:
        saved = {k: d[k] for k in d.files}
    want = {f"fine_lin{i}_{k}": np.asarray(v) for i, lp in enumerate(params["fine"]["lins"])
            for k, v in lp.items()}
    assert sorted(saved) == sorted(want)
    for k in want:
        _close(saved[k], want[k], lr)

    # both runners' loaders take the file
    jns = types.SimpleNamespace(params={"implicit": jf.init_combine(np.random.default_rng(1),
                                                                    cfg)},
                                log=print)
    assert JaxRunner._load_pretrained_fine_mlp(jns, out)
    for i, lp in enumerate(jns.params["implicit"]["fine"]["lins"]):
        for k, v in lp.items():
            assert np.array_equal(np.asarray(v), saved[f"fine_lin{i}_{k}"])
    _, tcfg, _, _ = _torch_tiny.configs()
    pns = types.SimpleNamespace(model=tsm.SceneModel(tcfg, np.random.default_rng(1)),
                                scene_cfg=tcfg, log=print)
    PortRunner._init_fine_mlp(pns, parse_string(f'train {{ pretrain_path = "{out}" }}'),
                              str(conf), str(tmp_path), 0)
    for i, lin in enumerate(pns.model.implicit.fine.lins):
        for k, p in lin.named_parameters():
            assert np.array_equal(p.detach().numpy(), saved[f"fine_lin{i}_{k}"])


def test_train_mono_prior_steps_match_jax_and_load_in_both(tmp_path):
    steps, n_scenes, frames, H, W, batch, lr, seed = 2, 2, 2, 32, 48, 2, 3e-4, 0
    jtool = _jax_tool("train_mono_prior")
    j_data = jtool.render_dataset(n_scenes, frames, H, W, seed)
    t_data = tmono.render_dataset(n_scenes, frames, H, W, seed)
    for a, b in zip(j_data, t_data):
        assert np.array_equal(a, b)
    flat0 = tmono.init_weights(seed)
    jflat0 = {k: np.asarray(v) for k, v in jtool._flatten(jmp.init_mono_prior(seed)).items()}
    assert sorted(flat0) == sorted(jflat0)
    for k in flat0:
        assert np.array_equal(flat0[k], jflat0[k]), k

    out = str(tmp_path / "mono_prior.npz")
    hist = tmono.train(steps, n_scenes, frames, H, W, batch, lr, seed, out, device="cpu")

    params = jmp.init_mono_prior(seed)
    opt = optax.adam(lr)
    state = opt.init(params)

    def loss_fn(p, x, d, n):
        pd, pn = jmp.mono_prior_forward(p, x)
        return jnp.abs(pd - d).mean() + 0.5 * (1.0 - (pn * n).sum(-1)).mean()

    step = jax.jit(jax.value_and_grad(loss_fn))
    rng = np.random.default_rng(seed + 1)
    rgb, dep, nrm = j_data
    for it in range(steps):
        idx = rng.integers(0, rgb.shape[0], batch)
        loss, g = step(params, jnp.asarray(rgb[idx]), jnp.asarray(dep[idx]),
                       jnp.asarray(nrm[idx]))
        np.testing.assert_allclose(hist[it]["loss"], float(loss), rtol=1e-5)
        up, state = opt.update(g, state, params)
        params = optax.apply_updates(params, up)
    with np.load(out) as d:
        saved = {k: d[k] for k in d.files}
    want = {k: np.asarray(v) for k, v in jtool._flatten(params).items()}
    assert sorted(saved) == sorted(want)
    for k in want:
        _close(saved[k], want[k], lr)

    # both packages' mono prior load the file
    img = np.random.default_rng(4).uniform(0, 1, (H, W, 3)).astype(np.float32)
    dj, nj = jmp.MonoPriorInference(out)(img)
    dt, nt = tmp_.MonoPriorInference(out, device="cpu")(img)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-5)
