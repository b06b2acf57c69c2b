"""The evaluation layer of the torch port against the JAX package, on the CPU:

  * the numpy copies (camera helpers, ``evaluation/ate``, ``eval_rec``,
    ``metrics.psnr/ssim``, ``get_scale_mat``) on random poses, meshes and
    images: bit for bit; the TUM reader, whose quaternions become float32
    rotations in each package's own ops, within 1e-6;
  * LPIPS from seed 0 (random features) and from a synthetic npz in the
    converted layout, and the converter of the JAX package's parameter
    tree: rtol 1e-5 of the JAX value, an image against itself exactly 0;
  * the runner's ``render_full_image(pose=, chunk=)`` and
    ``save_mesh(resolution=, suffix=)``;
  * the slice on one finished run of the JAX package (its tiny conf at
    48x64, 3 frames, 3 held-out views), restored into the port:
    ``evaluate_run`` within 1e-9 with the same keys; ``evaluate_rendering``
    per view, interpolate and extrapolate, PSNR within 0.01 dB, SSIM and
    LPIPS within 1e-4; the mesh at 32³ within the tolerance of
    ``test_torch_flagship.py::test_save_mesh_matches_jax`` and its
    ``calc_3d_metric`` against the analytic scene mesh within 2e-4 (5e-3
    through ICP); the
    visualizer's frame count; the port's battery and CLIs on that run.
"""

import csv
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from nicer_slam_tpu.datasets import scene_dataset as jds
from nicer_slam_tpu.evaluation import ate as jate
from nicer_slam_tpu.evaluation import eval_cam as jcam
from nicer_slam_tpu.evaluation import eval_rec as jrec
from nicer_slam_tpu.evaluation import eval_rendering as jrend
from nicer_slam_tpu.models import lpips as jlpips
from nicer_slam_tpu.utils import camera as jcamera
from nicer_slam_tpu.utils import metrics as jmetrics
from nicer_slam_tpu.utils.ply import read_ply
from nicer_slam_tpu_torch.datasets import scene_dataset as tds
from nicer_slam_tpu_torch.evaluation import ate as tate
from nicer_slam_tpu_torch.evaluation import eval_cam as tcam
from nicer_slam_tpu_torch.evaluation import eval_rec as trec
from nicer_slam_tpu_torch.evaluation import eval_rendering as trend
from nicer_slam_tpu_torch.models import lpips as tlpips
from nicer_slam_tpu_torch.utils import camera as tcamera
from nicer_slam_tpu_torch.utils import metrics as tmetrics
from nicer_slam_tpu_torch.utils.ply import write_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs test files in parallel workers, and
    torch's spinning thread pool in each of them starves the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(a, b, path="out"):
    """Equal bit for bit, through dicts, tuples and lists; a number equals
    a number of the same dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), (path, x.dtype, y.dtype,
                                                          x.shape, y.shape)
        assert x.tobytes() == y.tobytes(), (path, x, y)


def _poses(rng, n, dtype=np.float64):
    """n random c2w [n,4,4]: rotations from QR (det +1), translations in a
    unit cube."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        out[i, :3, :3] = q
        out[i, :3, 3] = rng.uniform(-1, 1, 3)
    return out.astype(dtype)


def _noisy(rng, poses, sigma=0.05):
    """poses with a small rotation and translation error each, then a
    global similarity (so the alignments have something to undo)."""
    out = poses.copy()
    for i in range(len(out)):
        w = rng.normal(0, sigma, 3)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) + np.sin(np.linalg.norm(w)) / max(np.linalg.norm(w), 1e-12) * K
        u, _, vt = np.linalg.svd(R)
        out[i, :3, :3] = (u @ vt) @ out[i, :3, :3]
        out[i, :3, 3] += rng.normal(0, sigma, 3)
    G = _poses(rng, 1)[0]
    out = np.einsum("ij,njk->nik", G, out)
    out[:, :3, 3] *= 1.7
    return out.astype(poses.dtype)


def _sphere_mesh(radius, res, center=(0.0, 0.0, 0.0)):
    from nicer_slam_tpu_torch.ops.marching_cubes import extract_mesh

    c = np.asarray(center)
    return extract_mesh(lambda p: radius - np.linalg.norm(p - c, axis=-1), resolution=res)


def _case_camera(rng):
    p, gt, apply = _poses(rng, 9), _poses(rng, 9), _poses(rng, 4)
    pf = p.astype(np.float32)
    return [(m.invert_pose_np(p[:, :3, :4]), m.invert_pose_np(pf[:, :3, :4]),
             m.procrustes_analysis_np(gt[:, :3, 3], p[:, :3, 3]),
             m.prealign_cameras_apply_another_np(p[:, :3, :4], _noisy(rng, p)[:, :3, :4],
                                                 apply[:, :3, :4]),
             m.prealign_cameras_apply_another_np(pf[:, :3, :4], gt[:, :3, :4].astype(np.float32),
                                                 apply[:, :3, :4].astype(np.float32)))
            for m, rng in ((jcamera, np.random.default_rng(1)),
                           (tcamera, np.random.default_rng(1)))]


def _case_ate(rng):
    gt = _poses(rng, 12)
    est = _noisy(rng, gt)
    out = []
    for m in (jate, tate):
        aligned, sim3 = m.prealign_cameras(est, gt)
        out.append((m.horn_align(est[:, :3, 3].T, gt[:, :3, 3].T, True),
                    m.horn_align(est[:, :3, 3].T, gt[:, :3, 3].T, False),
                    m.evaluate_ate(gt, est), m.evaluate_ate(gt, est, with_scale=False),
                    aligned, sim3, m.camera_alignment_errors(aligned, gt[:, :3, :4]),
                    m.rotation_drift(gt, est, return_curve=True),
                    m.rotation_drift(gt[:1], est[:1])))
    return out


def _case_tum_writer(rng, tmp_path):
    c2w = _poses(rng, 7).astype(np.float32)
    out = []
    for name, m in (("jax", jate), ("port", tate)):
        path = str(tmp_path / f"{name}.txt")
        m.write_tum_trajectory(path, c2w, timestamps=np.arange(7) * 0.5)
        m.write_tum_trajectory(path + ".default", c2w)
        out.append((open(path).read(), open(path + ".default").read()))
    return out


def _case_metrics(rng):
    a = rng.uniform(size=(H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return [(m.psnr(a, b), m.psnr(a, a), m.ssim(a, b), m.ssim(a[..., 0], b[..., 0]),
             m.ssim(a, b, data_range=2.0, win_size=7, sigma=1.0))
            for m in (jmetrics, tmetrics)]


def _case_eval_rec(rng, tmp_path):
    v1, f1, n1 = _sphere_mesh(0.5, 24)
    v2, f2, n2 = _sphere_mesh(0.52, 20, center=(0.03, -0.02, 0.01))
    p1, p2 = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    write_ply(p1, v1, f1, normals=n1)
    write_ply(p2, v2, f2, normals=n2)
    sim3 = np.eye(4)
    sim3[:3, :3] *= 1.01
    sim3[:3, 3] = [0.01, 0.0, -0.02]
    out = []
    for m in (jrec, trec):
        r = np.random.default_rng(3)
        pts, nrm = m.sample_mesh_points(v1, f1, 3000, r)
        pts2, nrm2 = m.sample_mesh_points(v2, f2, 2500, r)
        out.append((pts, nrm, m.icp_align(pts2, pts, iters=10),
                    m.nn_distances(pts, pts2),
                    m.eval_pointcloud(pts, pts2, nrm, nrm2),
                    m.eval_pointcloud(pts, pts2, thresholds=(0.005, 0.05)),
                    m.calc_3d_metric(p2, p1, n_points=4000),
                    m.calc_3d_metric(p2, p1, align_sim3=sim3, n_points=3000, do_icp=False)))
    return out


def _case_scale_mat(rng, tmp_path):
    from nicer_slam_tpu_torch.datasets.synthetic import generate

    d = str(tmp_path / "Synthetic")
    generate(d, scan_id=1, n_frames=2, H=24, W=32, world_scale=2.5, with_flow=False)
    return [(ds.get_scale_mat(), ds.scene_scale) for ds in
            (jds.SLAMDataset(d, (24, 32), scan_id=1, n_images=2),
             tds.SLAMDataset(d, (24, 32), scan_id=1, n_images=2))]


NUMPY_CASES = {"camera": _case_camera, "ate": _case_ate, "tum_writer": _case_tum_writer,
               "metrics": _case_metrics, "eval_rec": _case_eval_rec,
               "scale_mat": _case_scale_mat}


@pytest.mark.parametrize("case", sorted(NUMPY_CASES))
def test_numpy_copies_match_jax_bit_for_bit(case, tmp_path):
    fn = NUMPY_CASES[case]
    args = (np.random.default_rng(0),) + ((tmp_path,) if "tmp_path" in
                                         fn.__code__.co_varnames else ())
    j, t = fn(*args)
    _same(j, t, case)


def test_read_tum_trajectory_matches_jax(tmp_path):
    """Random poses plus the quaternion branches of the writer (a rotation
    by pi about each axis, the identity), written once and read by both
    packages: the c2w within 1e-6, the timestamps equal."""
    rng = np.random.default_rng(4)
    c2w = _poses(rng, 9).astype(np.float32)
    for i, axis in enumerate(np.eye(3)):
        R = 2 * np.outer(axis, axis) - np.eye(3)
        c2w[i, :3, :3] = R
    c2w[3, :3, :3] = np.eye(3)
    path = str(tmp_path / "traj.txt")
    jate.write_tum_trajectory(path, c2w, timestamps=np.arange(9) * 2.0)
    with open(path, "a") as f:
        f.write("# a comment\n\n")
    (pj, tj), (pt, tt) = (m.read_tum_trajectory(path, return_timestamps=True)
                          for m in (jate, tate))
    assert pj.dtype == pt.dtype == np.float32 and pt.shape == (9, 4, 4)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(pt, c2w, atol=1e-5)
    np.testing.assert_array_equal(tate.read_tum_trajectory(path), pt)


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def _image_pair(h, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    return a, b


def _lpips_npz(path):
    """A random checkpoint in the official layouts (torchvision AlexNet
    features, the LPIPS lin heads), converted to the flat npz by the JAX
    package's tools/convert_lpips.py."""
    spec = importlib.util.spec_from_file_location(
        "convert_lpips", os.path.join(REPO, "tools", "convert_lpips.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rng = np.random.default_rng(7)
    alex, lins = {}, {}
    for i, (k, _, _, ci, co, _) in enumerate(tlpips._ALEX):
        fi = mod._FEATURE_IDX[i]
        alex[f"features.{fi}.weight"] = rng.normal(0, np.sqrt(2 / (k * k * ci)),
                                                   (co, ci, k, k)).astype(np.float32)
        alex[f"features.{fi}.bias"] = rng.normal(0, 0.05, co).astype(np.float32)
        lins[f"lin{i}.model.1.weight"] = rng.uniform(0, 0.1, (1, co, 1, 1)).astype(np.float32)
    np.savez(path, **mod.convert_state_dicts(alex, lins))
    return path


@pytest.mark.parametrize("shape", [(48, 64), (96, 128)])
@pytest.mark.parametrize("weights", ["randfeat", "npz"])
def test_lpips_matches_jax(shape, weights, tmp_path):
    """The same network in both packages from seed 0 (random features) or
    from a converted npz: rtol 1e-5 of the JAX value on a random pair, an
    image against itself exactly 0 in both, the same metric name."""
    path = _lpips_npz(str(tmp_path / "lpips_alex.npz")) if weights == "npz" else None
    jm, tm = jlpips.LPIPSMetric(path), tlpips.LPIPSMetric(path)
    assert jm.metric_name == tm.metric_name == ("lpips" if path else "lpips_randfeat")
    a, b = _image_pair(*shape, seed=shape[0])
    vj, vt = jm(a, b), tm(a, b)
    assert vj > 1e-3
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=0)
    assert jm(a, a) == tm(a, a) == 0.0


def test_lpips_params_converter_builds_the_same_network(tmp_path):
    """The JAX package's LPIPS parameter tree as numpy (its seed-0 init, and
    a tree loaded from a converted npz) through ``lpips_from_params``:
    every weight equal to the port's own init or load bit for bit, and the
    distance within rtol 1e-5 of the JAX one."""
    path = _lpips_npz(str(tmp_path / "lpips_alex.npz"))
    a, b = _image_pair(48, 64, seed=9)
    for jm, tm in ((jlpips.LPIPSMetric(None), tlpips.LPIPSMetric(None)),
                   (jlpips.LPIPSMetric(path), tlpips.LPIPSMetric(path))):
        tree = jax.tree.map(np.asarray, jm.params)
        net = tlpips.lpips_from_params(tree)
        own = tm.net.state_dict()
        assert sorted(net.state_dict()) == sorted(own)
        for k, v in net.state_dict().items():
            assert torch.equal(v, own[k]), k
        with torch.no_grad():
            v = float(net(torch.from_numpy(a)[None], torch.from_numpy(b)[None])[0])
        np.testing.assert_allclose(v, jm(a, b), rtol=1e-5, atol=0)
    # the port's numpy init is the JAX package's draw, leaf by leaf
    _same(jax.tree.map(np.asarray, jlpips.init_lpips()), tlpips.init_lpips())


def test_metrics_lpips_resolves_to_the_port_metric(monkeypatch):
    """Without an injected callable, ``metrics.lpips`` builds the port's
    LPIPS (random features here: no lpips_alex.npz at the repo root) and
    gives the JAX package's value; an injected callable wins."""
    monkeypatch.setattr(tmetrics, "_lpips_fn", None)
    monkeypatch.setattr(jmetrics, "_lpips_fn", None)
    a, b = _image_pair(48, 64, seed=2)
    v = tmetrics.lpips(a, b, device="cpu")
    assert isinstance(tmetrics._lpips_fn, tlpips.LPIPSMetric)
    assert tmetrics._lpips_fn.metric_name == "lpips_randfeat"
    np.testing.assert_allclose(v, jmetrics.lpips(a, b), rtol=1e-5, atol=0)
    tmetrics.set_lpips_fn(lambda x, y: 0.25)
    assert tmetrics.lpips(a, b, device="cpu") == 0.25


# ---------------------------------------------------------------------------
# the runner's render and mesh signatures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_runner(tmp_path_factory):
    from nicer_slam_tpu_torch.datasets.synthetic import generate
    from nicer_slam_tpu_torch.slam.runner import SLAMRunner
    from test_torch_slice import _tiny_conf

    tmp = tmp_path_factory.mktemp("runner")
    data_dir = str(tmp / "Synthetic")
    generate(data_dir, scan_id=1, n_frames=3, H=24, W=32, keyframe_every=4, with_flow=False)
    r = SLAMRunner(conf=_tiny_conf(tmp, data_dir, 3), root_dir=str(tmp), quiet=True,
                   device="cpu")
    for f in range(2):
        r.track(f)
    r.map(0)
    return r


def test_render_full_image_at_the_estimated_pose_equals_the_default(port_runner):
    """``pose=`` set to the frame's estimated pose renders the same image
    bit for bit as the default; another pose renders another image; a
    ``chunk=`` that splits the frame elsewhere gives the same image within
    1e-6 (float32 sums over other batch sizes)."""
    r = port_runner
    default = r.render_full_image(1)
    at_est = r.render_full_image(1, pose=r.est_pose_all[1])
    for k in ("rgb", "depth", "normal"):
        assert default[k].tobytes() == at_est[k].tobytes(), k
    other = r.render_full_image(1, pose=r.dataset.gt_pose_all[2])
    assert np.abs(other["depth"] - default["depth"]).max() > 1e-3
    chunked = r.render_full_image(1, chunk=100)
    for k in ("rgb", "depth", "normal"):
        np.testing.assert_allclose(chunked[k], default[k], rtol=0, atol=1e-6, err_msg=k)
    # frame 2 has no estimate yet: the default is its GT pose
    np.testing.assert_array_equal(r.render_full_image(2)["rgb"],
                                  r.render_full_image(2, pose=r.dataset.gt_pose_all[2])["rgb"])


def test_save_mesh_resolution_and_suffix(port_runner):
    """``resolution=`` overrides plot.resolution and ``suffix=`` goes
    before the extension; the default keeps the vis hook's name and the
    conf's resolution."""
    from nicer_slam_tpu_torch.utils.plots import save_mesh

    r = port_runner
    path = save_mesh(r, 1, resolution=20, suffix="_eval")
    assert os.path.basename(path) == "surface_0001_eval.ply"
    default = save_mesh(r, 1)
    assert os.path.basename(default) == "surface_0001.ply"
    assert r.conf.get_int("plot.resolution") != 20
    small, full = read_ply(path), read_ply(default)
    assert 0 < len(small["verts"]) and len(small["verts"]) != len(full["verts"])


# ---------------------------------------------------------------------------
# the slice on one finished run of the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mini_run(tmp_path_factory):
    """The JAX package's tiny run (TINY_CONF, 48x64, 3 frames, 2 iterations,
    the cached prepass the port trains with) with 3 held-out views, and the
    port's runner restored from its checkpoint on the CPU."""
    from nicer_slam_tpu.datasets.synthetic import generate, generate_eval
    from nicer_slam_tpu.slam.runner import SLAMRunner as JaxRunner
    from nicer_slam_tpu_torch.slam.runner import SLAMRunner
    from test_slam_e2e import TINY_CONF

    root = tmp_path_factory.mktemp("evalrun")
    data_dir = str(root / "Synthetic")
    generate(data_dir, scan_id=1, n_frames=3, H=H, W=W, world_scale=3.0, with_flow=False)
    generate_eval(data_dir, scan_id=1, n_views=3, H=H, W=W, world_scale=3.0)
    conf = TINY_CONF.format(data_dir=data_dir, H=H, W=W, n_images=3, map_iters=2,
                            track_iters=2)
    old = "N_samples_extra = 8 }"
    assert old in conf
    conf = conf.replace(old, "N_samples_extra = 8  prepass_mode = cached  "
                             "prepass_cache_res = 16 }")
    conf_path = str(root / "c.conf")
    with open(conf_path, "w") as f:
        f.write(conf)
    jr = JaxRunner(conf=conf_path, root_dir=str(root), quiet=True)
    jr.run()
    tr = SLAMRunner(conf=os.path.join(jr.rundir, "runconf.conf"), root_dir=str(root),
                    is_continue=True, quiet=True, device="cpu")
    return types.SimpleNamespace(root=root, data_dir=data_dir, jax=jr, port=tr,
                                 rundir=jr.rundir)


def test_port_restores_the_jax_run(mini_run):
    r = mini_run.port
    assert r.rundir == mini_run.rundir and r.start_frame_idx == 2
    assert sorted(r.est_pose_all) == [0, 1, 2]
    for k in range(3):
        np.testing.assert_array_equal(r.est_pose_all[k], mini_run.jax.est_pose_all[k])


def test_eval_cam_matches_jax_on_the_jax_run(mini_run):
    """Same keys, values within 1e-9; the files it writes are the JAX
    package's (trajectory text and the sim3 bit for bit)."""
    out = os.path.join(mini_run.rundir, "eval_cam")
    mj = jcam.evaluate_run(mini_run.rundir, make_plot=False)
    files_j = {f: open(os.path.join(out, f), "rb").read()
               for f in ("metrics.json", "traj.txt", "alignment_transformation_sim3.npy")}
    mt = tcam.evaluate_run(mini_run.rundir, make_plot=True)
    assert sorted(mt) == sorted(mj) and mt["n_frames"] == 3
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=0, atol=1e-9, err_msg=k)
    for f, data in files_j.items():
        assert open(os.path.join(out, f), "rb").read() == data, f
    assert json.load(open(os.path.join(out, "metrics.json"))) == json.loads(files_j["metrics.json"])


def _eval_views(mini_run, method):
    eval_dir = mini_run.data_dir + "_eval"
    out = {}
    for name, runner, ds_mod, mod in (("jax", mini_run.jax, jds, jrend),
                                      ("port", mini_run.port, tds, trend)):
        ds = (ds_mod.SLAMDataset(data_dir=eval_dir, img_res=[H, W], scan_id=1, n_images=3)
              if method == "extrapolate" else None)
        out_dir = str(mini_run.root / f"eval_rendering_{name}")
        agg = mod.evaluate_rendering(runner, method, ds, out_dir=out_dir)
        with open(os.path.join(out_dir, f"{method}.csv")) as f:
            rows = list(csv.DictReader(f))
        with open(os.path.join(out_dir, f"{method}.log")) as f:
            assert json.load(f) == agg
        out[name] = (agg, rows)
    return out["jax"], out["port"]


@pytest.mark.parametrize("method", ["interpolate", "extrapolate"])
def test_eval_rendering_matches_jax_per_view(mini_run, method):
    """Per view: PSNR within 0.01 dB, SSIM and LPIPS within 1e-4; the
    aggregate's keys and view count equal, the metric named
    "lpips_randfeat" in both."""
    (aj, rj), (at, rt) = _eval_views(mini_run, method)
    assert sorted(at) == sorted(aj) and at["n_views"] == aj["n_views"] == (
        1 if method == "interpolate" else 3)
    assert at["lpips_metric"] == aj["lpips_metric"] == "lpips_randfeat"
    assert [r["frame"] for r in rt] == [r["frame"] for r in rj]
    for a, b in zip(rt, rj):
        assert abs(float(a["psnr"]) - float(b["psnr"])) <= 0.01, (a, b)
        for k in ("ssim", "lpips"):
            assert abs(float(a[k]) - float(b[k])) <= 1e-4, (k, a, b)
        assert np.isfinite([float(a[k]) for k in ("psnr", "ssim", "lpips")]).all()


def test_mesh_and_eval_rec_match_jax_on_the_jax_run(mini_run):
    """``save_mesh(resolution=32, suffix=...)`` of both runners: equal
    vertex and face counts, and at every corner of every face the vertex
    and its normal atol 1e-4 and its colour within 1; then
    ``calc_3d_metric`` of each against the analytic scene mesh (20,000
    points): the same keys, every value within 2e-4 without ICP and within
    5e-3 with it (the battery's setting: 30 point-to-point fits amplify the
    meshes' 1e-4 differences, and points near the 1-5 cm thresholds change
    side). Faces are compared through their
    corners, not their vertex indices: the extraction numbers vertices by
    sorting keys rounded to 1/1024 of a cell, and a vertex whose key
    rounds the other way in one package (its SDF ~1e-6 apart) takes
    another place in that order."""
    from nicer_slam_tpu.datasets.synthetic import scene_sdf
    from nicer_slam_tpu.ops.marching_cubes import extract_mesh
    from nicer_slam_tpu.utils import plots as jplots
    from nicer_slam_tpu_torch.utils import plots as tplots

    pj = jplots.save_mesh(mini_run.jax, 2, resolution=32, suffix="_jax")
    pt = tplots.save_mesh(mini_run.port, 2, resolution=32, suffix="_port")
    assert os.path.basename(pt) == "surface_0002_port.ply"
    mj, mt = read_ply(pj), read_ply(pt)
    assert len(mt["faces"]) == len(mj["faces"]) > 100
    assert len(mt["verts"]) == len(mj["verts"])
    for k, tol in (("verts", 1e-4), ("normals", 1e-4), ("colors", 1)):
        np.testing.assert_allclose(mt[k][mt["faces"]].astype(np.float64), mj[k][mj["faces"]],
                                   atol=tol, err_msg=k)
    gv, gf, gn = extract_mesh(scene_sdf, resolution=32, grid_boundary=(-1.0, 1.0))
    gt = str(mini_run.root / "gt_mesh.ply")
    write_ply(gt, gv, gf, normals=gn)
    for icp, tol in ((False, 2e-4), (True, 5e-3)):
        rj = jrec.calc_3d_metric(pj, gt, n_points=20000, do_icp=icp)
        rt = trec.calc_3d_metric(pt, gt, n_points=20000, do_icp=icp)
        assert sorted(rt) == sorted(rj)
        for k in rj:
            np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=tol, err_msg=(icp, k))


def test_visualizer_writes_as_many_frames_as_the_jax_one(mini_run):
    """Both visualizers on the same run (a mesh per vis call under vis/):
    the same number of viz_*.png frames, one at least."""
    frames_dir = os.path.join(mini_run.rundir, "vis_frames")
    counts = {}
    for name, cmd in (("jax", [sys.executable, "visualizer.py"]),
                      ("port", [sys.executable, "-m", "nicer_slam_tpu_torch.visualizer"])):
        shutil.rmtree(frames_dir, ignore_errors=True)
        res = subprocess.run(cmd + ["--output", mini_run.rundir], capture_output=True,
                             text=True, cwd=REPO, timeout=300,
                             env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                                      OMP_NUM_THREADS="1"))
        assert res.returncode == 0, (name, res.stderr[-2000:])
        counts[name] = sum(f.startswith("viz_") for f in os.listdir(frames_dir))
    assert counts["port"] == counts["jax"] >= 1, counts


def test_eval_checkpoint_battery_on_the_jax_run(mini_run):
    """The port's battery on the JAX run, on the CPU: every section, none
    holding an error, finite values, the JSON it writes equal to what it
    returns."""
    from nicer_slam_tpu_torch.evaluation import eval_checkpoint

    out = str(mini_run.root / "battery.json")
    res = eval_checkpoint.main(["--rundir", mini_run.rundir, "--out", out, "--mesh_res", "32",
                                "--synthetic_gt_mesh", "--eval_data_dir",
                                mini_run.data_dir + "_eval", "--n_eval_views", "3",
                                "--device", "cpu"])
    assert eval_checkpoint.failed_sections(res) == []
    assert json.load(open(out)) == res
    for k in ("eval_cam", "eval_rec", "depth_bias", "eval_rendering_interpolate",
              "eval_rendering_extrapolate", "est_mesh", "last_est_frame", "wall_s"):
        assert k in res, k
    assert res["last_est_frame"] == 2 and res["eval_rendering_extrapolate"]["n_views"] == 3
    values = [v for k in ("eval_cam", "eval_rec", "eval_rendering_interpolate",
                          "eval_rendering_extrapolate") for v in res[k].values()]
    values += [v for row in res["depth_bias"] for v in row.values()]
    assert np.isfinite(values).all()
    assert eval_checkpoint.failed_sections({"eval_cam": {"error": "x"},
                                            "eval_rendering_error": "y"}) == [
        "eval_cam", "eval_rendering"]


def test_eval_clis_on_the_jax_run(mini_run, capsys, tmp_path):
    """The port's eval_cam, eval_rec and eval_rendering CLIs (``main(argv)``)
    print the JSON their functions return."""
    tcam.main(["--output", mini_run.rundir, "--no_plot"])
    m = json.loads(capsys.readouterr().out)
    assert m["n_frames"] == 3 and np.isfinite(m["ate_rmse"])
    v, f, n = _sphere_mesh(0.5, 20)
    p = str(tmp_path / "s.ply")
    write_ply(p, v, f, normals=n)
    trec.main(["--pred", p, "--gt", p, "--n_points", "2000", "--no_icp"])
    rec = json.loads(capsys.readouterr().out)
    assert rec["accuracy"] < 0.02 and rec["normal_consistency"] > 0.95
    conf = os.path.join(mini_run.rundir, "runconf.conf")
    trend.main(["--conf", conf, "--root_dir", str(mini_run.root), "--device", "cpu"])
    agg = json.loads(capsys.readouterr().out)
    assert agg["n_views"] == 1 and np.isfinite(agg["psnr"])
