"""Run the JAX package and the port end to end on one tiny flagship-derived
conf and evaluate each run with its own battery, on the CPU.

  python tools/eval_both_packages.py --seeds 0 1 2 3 [--root DIR] [--out OUT.json]

The conf is confs/replica/runconf_replica_2.conf with the tiny model
widths of tests/_torch_tiny.py (colour top-6, geometric init on both SDF
networks), the camera free-space guard on (``loss.cam_freespace_w = 1.0``)
and ``global_window_start = 10``: 11 frames of the synthetic scan at 48x64,
30 tracking and 30 mapping iterations over 256 and 512 rays, mapping at
frames 0, 5 and 10. Per seed each package runs its CLI (``exp_runner``),
then its battery with the mesh at 48³ against the analytic scene mesh: the
JAX package's tools/eval_checkpoint.py (its runs one after the other in
one process, tests/_jax_eval_run_main.py) and the port's
``evaluation.eval_checkpoint`` (one process per seed on one torch thread,
all at once beside the JAX process). Prints each run's ATE RMSE,
interpolate PSNR and completion ratio, and the means over the seeds.
tests/test_torch_eval_e2e.py runs seeds 0 and 1 through ``run``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
H, W, N_FRAMES = 48, 64, 11
MESH_RES = "48"
# the numbers each package's battery is compared on: (section, key)
KEYS = {"ate": ("eval_cam", "ate_rmse"), "psnr": ("eval_rendering_interpolate", "psnr"),
        "completion_ratio": ("eval_rec", "completion_ratio_5cm")}


def write_conf(root: str, data_dir: str) -> str:
    import _torch_tiny

    text = open(os.path.join(REPO, "confs", "replica", "runconf_replica_2.conf")).read()
    model = (_torch_tiny.MODEL_CONF
             .replace("use_warp_loss = true", "use_warp_loss = true\n    color_topk = 6")
             .replace("geometric_init = false", "geometric_init = true"))
    text = text[:text.index("\nmodel {")] + model
    edits = [('"../Datasets/processed/Replica"', f'"{data_dir}"'),
             ("680\n        1200", f"{H}\n        {W}"),
             ("n_images = 2000", f"n_images = {N_FRAMES}"),
             ("        iters = 100\n    }\n    tracking", "        iters = 30\n    }\n    tracking"),
             ("        iters = 100\n        Hedge", "        iters = 30\n        Hedge"),
             ("mapping_num_pixels = 8192", "mapping_num_pixels = 512"),
             ("tracking_num_pixels = 1024", "tracking_num_pixels = 256"),
             ("split_n_pixels = 2580", "split_n_pixels = 1024"),
             ("resolution = 512", "resolution = 32"),
             ("mapping_every_frame = 5\n",
              "mapping_every_frame = 5\n        global_window_start = 10\n"),
             ("    flow_weight = 0.001\n", "    flow_weight = 0.001\n    cam_freespace_w = 1.0\n")]
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"conf edit failed ({old!r})")
        text = text.replace(old, new)
    path = os.path.join(root, "flagship_tiny.conf")
    with open(path, "w") as f:
        f.write(text)
    return path


def run(root: str, seeds) -> dict:
    """{"jax": [battery results per seed], "port": [...]} for the runs of
    ``seeds`` under ``root``."""
    from nicer_slam_tpu_torch.datasets.synthetic import generate

    data_dir = os.path.join(root, "Synthetic")
    generate(data_dir, scan_id=2, n_frames=N_FRAMES, H=H, W=W, keyframe_every=10,
             with_flow=True)
    conf = write_conf(root, data_dir)
    # one torch thread: a many-threaded torch process stalls beside others
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def start(cmd):
        return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)

    def wait(proc, what):
        _, err = proc.communicate(timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed ({proc.returncode}): {err[-3000:]}")

    seeds = [str(s) for s in seeds]
    jax_proc = start([sys.executable, os.path.join(REPO, "tests", "_jax_eval_run_main.py"),
                      conf, root, MESH_RES] + seeds)
    port_cli = [start([sys.executable, "-m", "nicer_slam_tpu_torch.training.exp_runner",
                       "--conf", conf, "--root_dir", os.path.join(root, f"port{s}"),
                       "--seed", s, "--device", "cpu"]) for s in seeds]
    port_battery = []
    for s, proc in zip(seeds, port_cli):
        wait(proc, f"port CLI, seed {s}")
        exps = os.path.join(root, f"port{s}", "exps")
        (exp,) = os.listdir(exps)
        (stamp,) = os.listdir(os.path.join(exps, exp))
        port_battery.append(start([
            sys.executable, "-m", "nicer_slam_tpu_torch.evaluation.eval_checkpoint",
            "--rundir", os.path.join(exps, exp, stamp),
            "--out", os.path.join(root, f"port{s}.json"), "--mesh_res", MESH_RES,
            "--synthetic_gt_mesh", "--device", "cpu"]))
    wait(jax_proc, "JAX CLI and battery")
    for s, proc in zip(seeds, port_battery):
        wait(proc, f"port battery, seed {s}")
    out = {}
    for pkg in ("jax", "port"):
        out[pkg] = []
        for s in seeds:
            with open(os.path.join(root, f"{pkg}{s}.json")) as f:
                out[pkg].append(json.load(f))
    return out


def summary(runs: dict) -> dict:
    """Per package: the compared numbers per run and their means."""
    out = {}
    for pkg, results in runs.items():
        per_run = [{m: r[sec][k] for m, (sec, k) in KEYS.items()} for r in results]
        out[pkg] = {"per_seed": per_run,
                    "mean": {m: sum(r[m] for r in per_run) / len(per_run) for m in KEYS}}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--root", default=None, help="work directory (default: a new one)")
    ap.add_argument("--out", default=None, help="write the summary here as JSON")
    a = ap.parse_args(argv)
    root = a.root or tempfile.mkdtemp(prefix="eval_both_")
    os.makedirs(root, exist_ok=True)
    s = summary(run(root, a.seeds))
    text = json.dumps({"seeds": a.seeds, **s}, indent=1)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
