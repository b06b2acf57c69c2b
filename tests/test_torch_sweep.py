"""The port's scene-parallel sweep (parallel/sweep.py) on the CPU: two
tiny synthetic scenes, each exp_runner in a process of its own, and each
run's poses equal to a solo exp_runner run of the same conf bit for bit."""

import os

import numpy as np

from nicer_slam_tpu_torch.datasets.synthetic import generate
from nicer_slam_tpu_torch.parallel.sweep import sweep
from nicer_slam_tpu_torch.training import exp_runner

from test_slam_e2e import TINY_CONF
from _torch_threads import one_torch_thread  # noqa: F401


def _poses(run_dir):
    with np.load(os.path.join(run_dir, "checkpoints", "PoseParameters", "latest.npz"),
                 allow_pickle=True) as z:
        return z["est_poses"]


def test_sweep_two_scenes_two_processes_match_solo_runs(tmp_path, monkeypatch):
    # the scene processes on one torch thread each, as this process
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    confs = []
    for k in (1, 2):
        data_dir = str(tmp_path / f"Synthetic{k}")
        generate(data_dir, scan_id=k, n_frames=2, H=48, W=64, world_scale=3.0,
                 with_flow=False)
        conf = TINY_CONF.format(data_dir=data_dir, H=48, W=64, n_images=2, map_iters=2,
                                track_iters=2)
        conf = conf.replace("scan_id = 1", f"scan_id = {k}")
        conf = conf.replace('expname = "tiny"', f'expname = "sweep{k}"')
        path = str(tmp_path / f"scene{k}.conf")
        with open(path, "w") as f:
            f.write(conf)
        confs.append(path)

    results = sweep(confs, root_dir=str(tmp_path), exps_folder="exps_sweep", max_devices=2,
                    device="cpu")
    assert len(results) == 2
    for conf, r in zip(confs, results):
        assert r["ok"], r.get("error")
        assert r["device"] == "cpu" and r["wall_s"] > 0
        swept = _poses(r["run_dir"])
        assert swept.shape[0] == 2
        solo = exp_runner.main(["--conf", conf, "--root_dir", str(tmp_path),
                                "--exps_folder", "exps_solo", "--device", "cpu"])
        np.testing.assert_array_equal(swept, _poses(solo.rundir))
    assert results[0]["run_dir"] != results[1]["run_dir"]
