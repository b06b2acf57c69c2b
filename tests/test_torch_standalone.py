"""The port stands alone: no module of nicer_slam_tpu_torch, and nothing in
chip_smoke.py, imports the JAX package or JAX. The port keeps its own
copies of the JAX package's stdlib/numpy modules (config, keyframes,
fastio, the synthetic generator, marching tetrahedra, PLY IO); each copy
is held here against its original on the CPU at tiny sizes, and so is the
checkpoint boundary where the port's ``[T, C]`` hash tables meet the JAX
package's ``[C, T]``.
"""

import ast
import glob
import lzma
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from nicer_slam_tpu import config as jconfig
from nicer_slam_tpu.datasets import synthetic as jsyn
from nicer_slam_tpu.ops import marching_cubes as jmc
from nicer_slam_tpu.slam import keyframes as jkf
from nicer_slam_tpu.slam.checkpoint import _flatten_pytree
from nicer_slam_tpu.utils import ply as jply
from nicer_slam_tpu_torch import config as tconfig
from nicer_slam_tpu_torch.datasets import synthetic as tsyn
from nicer_slam_tpu_torch.models import scene_model as tsm
from nicer_slam_tpu_torch.ops import marching_cubes as tmc
from nicer_slam_tpu_torch.slam import checkpoint as tckpt
from nicer_slam_tpu_torch.slam import keyframes as tkf
from nicer_slam_tpu_torch.slam import state as tstate
from nicer_slam_tpu_torch.utils import ply as tply

import _torch_tiny
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nicer_slam_tpu_torch")
CONFS = sorted(os.path.relpath(p, REPO)
               for p in glob.glob(os.path.join(REPO, "confs", "**", "*.conf"), recursive=True))
FORBIDDEN = ("jax", "nicer_slam_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_source_imports_the_jax_package():
    """Static scan: no import statement of the port or chip_smoke.py names
    jax or nicer_slam_tpu (relative imports stay inside the port)."""
    files = sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), node.lineno, n) for n in names
                    if _forbidden(n)]
    assert len(files) > 30 and not bad, bad


_RUN_ALONE = r"""
import importlib, os, pkgutil, sys, tempfile, types
import numpy as np
import nicer_slam_tpu_torch
for m in pkgutil.walk_packages(nicer_slam_tpu_torch.__path__, "nicer_slam_tpu_torch."):
    importlib.import_module(m.name)
from nicer_slam_tpu_torch.config import parse_string
from nicer_slam_tpu_torch.datasets.scene_dataset import SLAMDataset
from nicer_slam_tpu_torch.datasets.synthetic import generate
from nicer_slam_tpu_torch.models.scene_model import SceneModel, scene_config_from_conf
from nicer_slam_tpu_torch.utils import plots
from nicer_slam_tpu_torch.utils.ply import read_ply
from _torch_tiny import MODEL_CONF

tmp = tempfile.mkdtemp()
generate(os.path.join(tmp, "scan"), scan_id=1, n_frames=2, H=24, W=32, keyframe_every=1)
ds = SLAMDataset(os.path.join(tmp, "scan"), (24, 32), scan_id=1, n_images=2,
                 use_gt_depth=True)
assert ds.frame(1)["rgb"].shape == (24 * 32, 3)
conf = parse_string(MODEL_CONF + "plot { resolution = 24 }")
model = SceneModel(scene_config_from_conf(conf.get_config("model"), (24, 32), 2),
                   np.random.default_rng(0))
runner = types.SimpleNamespace(conf=conf, model=model, device="cpu", plots_dir=tmp,
                               log=print)
path = plots.save_mesh(runner, 1)
mesh = read_ply(path)
assert len(mesh["verts"]) > 0 and len(mesh["faces"]) > 0
bad = sorted(k for k in sys.modules
             if k in ("jax", "nicer_slam_tpu") or k.startswith(("jax.", "nicer_slam_tpu.")))
assert not bad, bad
print("ok")
"""


def _device_defaults():
    """(module, default) of every ``add_argument("--device", ...)`` in the
    port: the command-line entry points that take a device."""
    out = []
    for path in sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value == "--device"):
                kw = {k.arg: k.value for k in node.keywords}
                out.append((os.path.relpath(path, REPO),
                            kw["default"].value if isinstance(kw.get("default"), ast.Constant)
                            else None))
    return out


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    """Every command-line entry point of the port that takes a device
    defaults to the card (the CPU only when the caller asks), and so does
    the SLAM runner that they build; the CLIs without the option do no
    device work (numpy and matplotlib: eval_cam, eval_rec, the visualizer,
    the GT-trajectory export and the eval-scan converter)."""
    import inspect

    from nicer_slam_tpu_torch.slam.runner import SLAMRunner
    found = _device_defaults()
    assert len(found) >= 14, found
    assert all(d == "cuda" for _, d in found), [f for f in found if f[1] != "cuda"]
    assert inspect.signature(SLAMRunner.__init__).parameters["device"].default == "cuda"


def test_port_runs_without_the_jax_package():
    """Every module imported, a scan generated and read, a mesh written and
    read back, all in one process in which neither jax nor nicer_slam_tpu
    (nor any of their submodules) was ever imported."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    out = subprocess.run([sys.executable, "-c", _RUN_ALONE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


@pytest.mark.parametrize("conf", CONFS)
def test_conf_parses_as_the_jax_package_parses_it(conf):
    path = os.path.join(REPO, conf)
    port, ref = tconfig.parse_file(path), jconfig.parse_file(path)
    assert port.as_dict() == ref.as_dict() and port.dumps() == ref.dumps()


def test_keyframe_windows_match():
    """The same seeded window and flow-edge draws over a short sequence that
    reaches the global-window regime."""
    cfg = dict(mapping_window_size=15, keyframe_every=5, num_mapping_iters=10,
               global_window_start=20)
    js = jkf.KeyframeSelector(jkf.KeyframeConfig(**cfg), seed=3)
    ts = tkf.KeyframeSelector(tkf.KeyframeConfig(**cfg), seed=3)
    n_edges = 0
    for frame in range(0, 60, 5):
        for it in (0, 5, 9):
            a, b = js.window(frame, it), ts.window(frame, it)
            assert a.keyframe_list == b.keyframe_list
            assert a.writeback_eligible == b.writeback_eligible
            assert (a.edges is None) == (b.edges is None)
            if a.edges is not None:
                n_edges += len(a.edges[0])
                for x, y in zip(a.edges, b.edges):
                    np.testing.assert_array_equal(x, y)
    assert n_edges > 0


def _read_any(path):
    if path.endswith(".png"):
        return cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if path.endswith(".npz"):
        with np.load(path) as d:
            return {k: d[k] for k in d.files}
    with lzma.open(path) as f:          # the lzma-compressed .npy files
        return np.load(f)


def test_generator_raises_on_a_camera_inside_the_clearance(monkeypatch):
    """The port's generator refuses a camera pose closer to the geometry
    than the clearance with an explicit raise, which ``python -O`` keeps:
    with the clearing step switched off, the raw orbit's frame at 0.6 rad
    lies inside sphere 1 (sdf < 0)."""
    assert tsyn.scene_sdf(np.array([0.35 * np.sin(0.6), 0.12 * np.sin(1.2) + 0.05,
                                    0.35 * np.cos(0.6) - 0.1])) < 0
    assert len(tsyn.camera_trajectory(2, rad_per_frame=0.6)) == 2
    monkeypatch.setattr(tsyn, "_clear_camera_position", lambda pos: pos)
    with pytest.raises(RuntimeError, match="camera frame 1 could not be cleared"):
        tsyn.camera_trajectory(2, rad_per_frame=0.6)


def test_generator_writes_what_the_jax_package_writes(tmp_path):
    """2 frames at 24×32 with flow: every file, decoded, is equal (the PNG
    encoders may differ, the pixels may not)."""
    kw = dict(scan_id=1, n_frames=2, H=24, W=32, keyframe_every=1, with_flow=True)
    jsyn.generate(str(tmp_path / "jax"), **kw)
    tsyn.generate(str(tmp_path / "port"), **kw)
    rel = sorted(os.path.relpath(p, tmp_path / "jax")
                 for p in glob.glob(str(tmp_path / "jax" / "**" / "*"), recursive=True)
                 if os.path.isfile(p))
    rel_t = sorted(os.path.relpath(p, tmp_path / "port")
                   for p in glob.glob(str(tmp_path / "port" / "**" / "*"), recursive=True)
                   if os.path.isfile(p))
    assert rel == rel_t and any(r.endswith("_flow.npy") for r in rel)
    for r in rel:
        a, b = _read_any(str(tmp_path / "jax" / r)), _read_any(str(tmp_path / "port" / r))
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)


def test_extract_mesh_matches():
    def sdf(x):
        return np.linalg.norm(x - np.array([0.1, -0.05, 0.0], np.float32), axis=-1) - 0.55

    a = jmc.extract_mesh(sdf, resolution=24)
    b = tmc.extract_mesh(sdf, resolution=24)
    assert len(a[0]) > 100
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_ply_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    verts = rng.standard_normal((50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (80, 3))
    normals = rng.standard_normal((50, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    tply.write_ply(str(tmp_path / "t.ply"), verts, faces, normals=normals, colors=colors)
    jply.write_ply(str(tmp_path / "j.ply"), verts, faces, normals=normals, colors=colors)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    got, ref = tply.read_ply(str(tmp_path / "t.ply")), jply.read_ply(str(tmp_path / "t.ply"))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got["verts"], verts)
    np.testing.assert_array_equal(got["faces"], faces)


def test_jax_params_round_trip_through_the_port_layout():
    """JAX ModelParameters ([C, T] tables) -> the port ([T, C]) ->
    params_to_numpy: the JAX arrays back, bit for bit."""
    jcfg, tcfg, _, _ = _torch_tiny.configs()
    jparams, _ = _torch_tiny.models(jcfg, tcfg, seed=4)
    flat_j = {k: np.asarray(v) for k, v in _flatten_pytree(jparams).items()}
    model = tsm.SceneModel(tcfg, np.random.default_rng(11))
    tckpt.params_from_numpy(flat_j, model)
    tables = [k for k in flat_j if k.endswith("/encoding")]
    assert sorted(tables) == ["implicit/coarse/encoding", "implicit/fine/encoding",
                              "render/encoding"]
    state = model.state_dict()
    for k in tables:
        C, T = flat_j[k].shape
        t = state[k.replace("/", ".")]
        assert tuple(t.shape) == (T, C) and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), flat_j[k].T)
    back = tckpt.params_to_numpy(model)
    assert sorted(back) == sorted(flat_j)
    for k in flat_j:
        assert back[k].dtype == flat_j[k].dtype
        np.testing.assert_array_equal(back[k], flat_j[k])


def test_adam_state_files_keep_the_jax_layout(tmp_path):
    """The Adam moments of a table are written [C, T] and read back into
    [T, C] bit for bit."""
    _, tcfg, _, _ = _torch_tiny.configs()
    model = tsm.SceneModel(tcfg, np.random.default_rng(0))
    opt = tstate.make_optimizer(tstate.OptimConfig(), model)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.randn_like(p)
    opt.step()
    tckpt.save_optimizer(str(tmp_path), model, opt, 3)
    enc = model.render.encoding
    with np.load(tmp_path / "latest.npz") as d:
        keys = [str(k) for k in d["keypaths"]]
        mu = ".inner_states['color_grid'].inner_state[0].mu['render']['encoding']"
        saved = d[f"leaf_{keys.index(mu)}"]
    assert saved.shape == tuple(enc.shape)[::-1]
    np.testing.assert_array_equal(saved, opt.state[enc]["exp_avg"].numpy().T)
    fresh = tstate.make_optimizer(tstate.OptimConfig(), model)
    tckpt.load_optimizer(str(tmp_path), model, fresh)
    for p in model.parameters():
        if p in opt.state:
            for k, v in opt.state[p].items():
                assert torch.equal(fresh.state[p][k], v), k


_CLI_HELP = r"""
import runpy, sys
for mod in ("nicer_slam_tpu_torch.preprocess.replica_2_volsdf",
            "nicer_slam_tpu_torch.preprocess.tsdf_fusion"):
    sys.argv = [mod, "--help"]
    try:
        runpy.run_module(mod, run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (mod, e.code)
bad = sorted(k for k in sys.modules
             if k in ("jax", "nicer_slam_tpu") or k.startswith(("jax.", "nicer_slam_tpu.")))
assert not bad, bad
print("ok")
"""


def test_preprocess_clis_run_without_the_jax_package():
    """``python -m ...replica_2_volsdf --help`` and ``...tsdf_fusion --help``
    in one process that never imports jax or nicer_slam_tpu."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CLI_HELP], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
    helps = out.stdout.split("usage:")[1:]
    assert len(helps) == 2 and "--dataset_folder" in helps[0] and "--scan_dir" in helps[1]
    assert all("--device" in h for h in helps)


def test_training_tool_clis_run_without_the_jax_package():
    """``python -m ...training.pretrain --help`` and
    ``...training.train_mono_prior --help`` in one process that never
    imports jax or nicer_slam_tpu: the JAX tools' flags, and --device."""
    code = _CLI_HELP.replace('"nicer_slam_tpu_torch.preprocess.replica_2_volsdf"',
                             '"nicer_slam_tpu_torch.training.pretrain"').replace(
        '"nicer_slam_tpu_torch.preprocess.tsdf_fusion"',
        '"nicer_slam_tpu_torch.training.train_mono_prior"')
    assert code != _CLI_HELP
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
    helps = out.stdout.split("usage:")[1:]
    assert len(helps) == 2
    assert all(f in helps[0] for f in ("--out", "--steps", "--batch", "--lr", "--conf",
                                       "--cpu", "--device"))
    assert all(f in helps[1] for f in ("--steps", "--n-scenes", "--frames-per-scene", "--H",
                                       "--W", "--batch", "--lr", "--out", "--device"))


@pytest.mark.parametrize("module", ["common", "colmap", "extract_monocular_cues",
                                    "extract_flows", "replica_2_volsdf",
                                    "replica_eval_2_volsdf", "sevenscenes_2_volsdf",
                                    "azure_2_volsdf", "tsdf_fusion"])
def test_every_preprocess_module_has_its_counterpart(module):
    """The port holds a counterpart of every file of nicer_slam_tpu/preprocess/
    (and nothing it names is missing): its public functions are the JAX
    module's."""
    import importlib

    j = importlib.import_module(f"nicer_slam_tpu.preprocess.{module}")
    t = importlib.import_module(f"nicer_slam_tpu_torch.preprocess.{module}")
    public = {n for n, v in vars(j).items() if callable(v) and not n.startswith("_")
              and getattr(v, "__module__", "") == j.__name__}
    missing = sorted(n for n in public if not callable(getattr(t, n, None)))
    # the JAX package's jit factory is the port's ops/tsdf.py (K9)
    assert missing == (["make_integrate_fn"] if module == "tsdf_fusion" else []), missing
