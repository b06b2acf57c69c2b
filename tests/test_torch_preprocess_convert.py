"""The port's dataset converters against the JAX package's, each on a tiny raw
capture in its own layout (Replica, Replica's held-out views, 7-Scenes,
Azure Kinect with COLMAP text files), the port's GT trajectory export
against scripts/export_gt_trajs.py, and the whole chain in the port alone:
raw capture -> converter -> SLAMRunner -> eval_cam / eval_rec.

Every converter runs with cues (the mono prior, ``mono_prior.npz``) and
flows: geometric where the capture has depth (Replica, 7-Scenes),
classical where it has none (Azure). Checks: cameras.npz and every copied
file bit for bit; a PNG converted from a JPEG source within 1/255 (OpenCV
and the JAX package's imageio may decode a JPEG 1 LSB apart); cues within
1e-5; geometric flows and occlusion bit for bit,
classical flows within 1e-9 px (the tolerances of
tests/test_torch_preprocess.py).
"""

import glob
import importlib.util
import lzma
import os

import cv2
import numpy as np
import pytest

from nicer_slam_tpu.preprocess import azure_2_volsdf as jazure
from nicer_slam_tpu.preprocess import replica_2_volsdf as jreplica
from nicer_slam_tpu.preprocess import replica_eval_2_volsdf as jreplica_eval
from nicer_slam_tpu.preprocess import sevenscenes_2_volsdf as jseven
from nicer_slam_tpu_torch.datasets.synthetic import camera_trajectory, render_frame, scene_sdf
from nicer_slam_tpu_torch.ops.marching_cubes import extract_mesh
from nicer_slam_tpu_torch.preprocess import azure_2_volsdf as tazure
from nicer_slam_tpu_torch.preprocess import replica_2_volsdf as treplica
from nicer_slam_tpu_torch.preprocess import replica_eval_2_volsdf as treplica_eval
from nicer_slam_tpu_torch.preprocess import sevenscenes_2_volsdf as tseven
from nicer_slam_tpu_torch.utils.ply import write_ply
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_SCALE = 3.0
H, W = 48, 64
N_FRAMES = 11          # keyframes 0 and 10: one flow pair each way
INTR = (44.0, 44.0, (W - 1) / 2.0, (H - 1) / 2.0)


def _K4():
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = INTR
    return K


def _frames():
    """(rgb uint8 [H, W, 3], z in world units, c2w in world units) per frame
    of the synthetic orbit."""
    out = []
    for c2w in camera_trajectory(N_FRAMES):
        rgb, z_cube, _, _ = render_frame(H, W, _K4(), c2w)
        cw = c2w.copy()
        cw[:3, 3] *= WORLD_SCALE
        out.append(((rgb * 255).astype(np.uint8), z_cube * WORLD_SCALE, cw))
    return out


def _write_rgb(path, rgb, **kw):
    assert cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), *kw.values())


def _write_mesh(path):
    verts, faces, normals = extract_mesh(scene_sdf, resolution=32, grid_boundary=(-1.0, 1.0))
    write_ply(path, (verts * WORLD_SCALE).astype(np.float32), faces, normals=normals)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Raw captures in the four layouts, from one rendering of the orbit."""
    root = tmp_path_factory.mktemp("raw")
    frames = _frames()
    jpeg = [int(cv2.IMWRITE_JPEG_QUALITY), 95]
    # Replica: <root>/synthroom/{traj.txt, results/{frame*.jpg, depth*.png}}
    # and <root>/synthroom_mesh.ply
    replica = root / "replica" / "synthroom"
    (replica / "results").mkdir(parents=True)
    for i, (rgb, z, _) in enumerate(frames):
        _write_rgb(str(replica / "results" / f"frame{i:06d}.jpg"), rgb, q=jpeg)
        cv2.imwrite(str(replica / "results" / f"depth{i:06d}.png"),
                    np.round(z * 6553.5).astype(np.uint16))
    np.savetxt(str(replica / "traj.txt"), np.stack([c for *_, c in frames]).reshape(-1, 16))
    _write_mesh(str(root / "replica" / "synthroom_mesh.ply"))
    # Replica's held-out views: <root>/synthroom/{frame*.jpg, traj.txt}
    ev = root / "replica_eval" / "synthroom"
    ev.mkdir(parents=True)
    for i, (rgb, _, _) in enumerate(frames[:3]):
        _write_rgb(str(ev / f"frame{i:06d}.jpg"), rgb, q=jpeg)
    np.savetxt(str(ev / "traj.txt"), np.stack([c for *_, c in frames[:3]]).reshape(-1, 16))
    # 7-Scenes: <root>/chess/seq-01/frame-*.{color.png, depth.png (mm,
    # 65535 invalid), pose.txt} and <root>/meshes/chess.ply
    seven = root / "7scenes" / "chess" / "seq-01"
    seven.mkdir(parents=True)
    for i, (rgb, z, c2w) in enumerate(frames):
        _write_rgb(str(seven / f"frame-{i:06d}.color.png"), rgb)
        mm = np.round(z * 1000).astype(np.uint16)
        mm[:2, :5] = 65535
        cv2.imwrite(str(seven / f"frame-{i:06d}.depth.png"), mm)
        np.savetxt(str(seven / f"frame-{i:06d}.pose.txt"), c2w)
    (root / "7scenes" / "meshes").mkdir()
    _write_mesh(str(root / "7scenes" / "meshes" / "chess.ply"))
    # Azure: <root>/1/{color/*.png, sparse/0/{cameras,images}.txt,
    # dense/meshed-poisson.ply}
    az = root / "azure" / "1"
    for d in ("color", "sparse/0", "dense"):
        (az / d).mkdir(parents=True)
    lines = ["# image list"]
    for i, (rgb, _, c2w) in enumerate(frames):
        _write_rgb(str(az / "color" / f"{i:05d}.png"), rgb)
        w2c = np.linalg.inv(c2w)
        q = _quat_wxyz(w2c[:3, :3])
        lines += [f"{i + 1} " + " ".join(f"{v:.12f}" for v in (*q, *w2c[:3, 3]))
                  + f" 1 {i:05d}.png", ""]
    (az / "sparse" / "0" / "images.txt").write_text("\n".join(lines) + "\n")
    (az / "sparse" / "0" / "cameras.txt").write_text(
        f"# cameras\n1 PINHOLE {W} {H} " + " ".join(f"{v}" for v in INTR) + "\n")
    _write_mesh(str(az / "dense" / "meshed-poisson.ply"))
    return root


def _quat_wxyz(R):
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2.0
    return (w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
            (R[1, 0] - R[0, 1]) / (4 * w))


def _read(path):
    if path.endswith(".npz"):
        with np.load(path) as d:
            return {k: d[k] for k in d.files}
    if path.endswith(".npy"):
        with lzma.open(path) as f:
            return np.load(f)
    if path.endswith((".png", ".jpg")):
        return cv2.imread(path, cv2.IMREAD_UNCHANGED)
    with open(path, "rb") as f:
        return f.read()


def _same_tree(jax_dir, port_dir, jpeg_pngs=False, flow_tol=0.0):
    """Every file of the JAX package's output is in the port's and agrees."""
    rel = sorted(os.path.relpath(p, jax_dir)
                 for p in glob.glob(os.path.join(jax_dir, "**", "*"), recursive=True)
                 if os.path.isfile(p))
    rel_t = sorted(os.path.relpath(p, port_dir)
                   for p in glob.glob(os.path.join(port_dir, "**", "*"), recursive=True)
                   if os.path.isfile(p))
    assert rel == rel_t and rel
    for r in rel:
        a, b = _read(os.path.join(jax_dir, r)), _read(os.path.join(port_dir, r))
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{r}:{k}")
        elif r.endswith("_rgb.png") and jpeg_pngs:
            assert np.abs(a.astype(int) - b).max() <= 1, r
        elif r.endswith(("_depth.npy", "_normal.npy")):
            assert a.shape == b.shape and np.abs(a - b).max() <= 1e-5, r
        elif r.endswith("_flow.npy"):
            assert a.shape == b.shape and np.abs(a.astype(np.float64) - b).max() <= flow_tol, r
        else:
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, r
    return rel


@pytest.fixture(scope="module")
def replica(raw, tmp_path_factory):
    """The Replica capture converted by both packages (cues, geometric
    flows): (JAX root, port root)."""
    out = tmp_path_factory.mktemp("replica")
    scene = str(raw / "replica" / "synthroom")
    jreplica.convert_scene(scene, str(out / "jax" / "scan1"), 1, with_cues=True,
                           with_flow=True, intrinsics=INTR)
    treplica.convert_scene(scene, str(out / "port" / "scan1"), 1, with_cues=True,
                           with_flow=True, intrinsics=INTR, device="cpu")
    return str(out / "jax"), str(out / "port")


def test_replica_converter_matches(replica):
    jroot, troot = replica
    rel = _same_tree(jroot, troot, jpeg_pngs=True)
    assert "synthroom_mesh_01.ply" in rel and "scan1/cameras.npz" in rel
    assert "scan1_pair/0000_0010_flow.npy" in rel and "scan1/000010_normal.npy" in rel


def test_replica_eval_converter_matches(raw, replica, tmp_path):
    """The held-out views take the training scan's scale_mat; JPEGs are
    copied."""
    jroot, _ = replica
    src = str(raw / "replica_eval" / "synthroom")
    jreplica_eval.convert_scene(src, str(tmp_path / "jax" / "scan1"), os.path.join(jroot, "scan1"))
    treplica_eval.convert_scene(src, str(tmp_path / "port" / "scan1"),
                                os.path.join(jroot, "scan1"))
    rel = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert "scan1/000002_rgb.jpg" in rel


def test_sevenscenes_converter_matches(raw, tmp_path):
    src = str(raw / "7scenes" / "chess" / "seq-01")
    jseven.convert_scene(src, str(tmp_path / "jax" / "scan1"), 1, "chess", with_cues=True,
                         with_flow=True)
    tseven.convert_scene(src, str(tmp_path / "port" / "scan1"), 1, "chess", with_cues=True,
                         with_flow=True, device="cpu")
    rel = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert "scan1/000010_gt_depth.png" in rel and "scan1_pair/0010_0000_occ.png" in rel
    d = cv2.imread(str(tmp_path / "port" / "scan1" / "000003_gt_depth.png"), -1)
    assert d[0, 0] == 0 and d.max() < 65535


def test_azure_converter_matches(raw, tmp_path):
    """COLMAP text files; no depth, so the flows are the classical ones."""
    src = str(raw / "azure" / "1")
    jazure.convert_scene(src, str(tmp_path / "jax" / "scan1"), 1, with_cues=True,
                         with_flow=True)
    tazure.convert_scene(src, str(tmp_path / "port" / "scan1"), 1, with_cues=True,
                         with_flow=True, device="cpu")
    rel = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"), flow_tol=1e-9)
    assert "scan1_pair/0000_0010_flow.npy" in rel
    with np.load(str(tmp_path / "port" / "scan1" / "cameras.npz")) as cams:
        assert len([k for k in cams.files if k.startswith("world_mat_")]) == N_FRAMES


@pytest.mark.parametrize("cube", [False, True], ids=["world", "cube"])
def test_export_gt_trajs_matches_the_script(replica, tmp_path, cube):
    from nicer_slam_tpu_torch.evaluation import export_gt_trajs

    spec = importlib.util.spec_from_file_location(
        "export_gt_trajs_script", os.path.join(REPO, "scripts", "export_gt_trajs.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    jroot, _ = replica
    args = ["--data_dir", jroot, "--scan_id", "1"] + (["--cube"] if cube else [])
    script.main(args + ["--out", str(tmp_path / "jax.txt")])
    export_gt_trajs.main(args + ["--out", str(tmp_path / "port.txt")])
    a = (tmp_path / "jax.txt").read_text().splitlines()
    b = (tmp_path / "port.txt").read_text().splitlines()
    assert len(a) == N_FRAMES and a == b


def test_capture_to_converter_to_runner_to_eval(replica, tmp_path):
    """The port alone: its converter's scan through SLAMRunner (the tiny
    conf of tests/test_slam_e2e.py with the cached prepass the port
    trains with), then eval_cam and eval_rec."""
    from test_slam_e2e import TINY_CONF

    from nicer_slam_tpu_torch.evaluation.eval_cam import evaluate_run
    from nicer_slam_tpu_torch.evaluation.eval_rec import calc_3d_metric
    from nicer_slam_tpu_torch.slam.runner import SLAMRunner
    from nicer_slam_tpu_torch.utils.plots import save_mesh

    _, troot = replica
    conf = tmp_path / "conv.conf"
    text = TINY_CONF.format(data_dir=troot, H=H, W=W, n_images=N_FRAMES, map_iters=4,
                            track_iters=4)
    old = "N_samples_extra = 8 }"
    assert old in text
    conf.write_text(text.replace(old, "N_samples_extra = 8  prepass_mode = cached  "
                                      "prepass_cache_res = 16 }"))
    r = SLAMRunner(conf=str(conf), root_dir=str(tmp_path), quiet=True, device="cpu")
    r.run()
    assert len(r.est_pose_all) == N_FRAMES
    cam = evaluate_run(r.rundir, make_plot=False)
    assert np.isfinite(cam["ate_rmse"])
    est_ply = save_mesh(r, N_FRAMES - 1, resolution=32)
    if est_ply is not None:      # a tiny budget may not cross zero yet
        rec = calc_3d_metric(est_ply, os.path.join(troot, "synthroom_mesh_01.ply"),
                             n_points=5000, do_icp=True)
        assert np.isfinite(rec["accuracy"]) and np.isfinite(rec["completion"])
