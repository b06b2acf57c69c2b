#!/usr/bin/env python3
"""The SLAM main paths of two checkouts of the port, in turns, on one CUDA
card.

  git archive <commit> | tar -x -C build/other
  python3 tools/torch_path_ab.py --other build/other [--out build/path_ab.json]

Runs chip_smoke.py's demo and flagship configurations (the same synthetic
scans, confs and cuts, without the checkpoint writes) from the other
checkout and from this one, each run in a process of its own, in turns:
other, this, this, other. Both read the scans this checkout generates.
Reports per run the runner's phase times: ms per mapping and per tracking
iteration, ms per density-cache build, s/frame (the loop over the 11
frames, card synchronised at both ends), the peak device memory of the
set-up and the loop, and after the loop the vis hook
once (vis s: a full frame rendered with the exact prepass, the panels and
the mesh) and, before it, that render alone (render s). Last, untimed,
the device work of one more tracking call and one mapping iteration
(without BA) under torch.profiler: the device operations (kernels, and
memory copies and sets) per tracking iteration and per mapping iteration
(0 where the profiler records no device activity).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# one run of one path, in the checkout it is started in (argv: kind,
# data_dir, tag); prints one RESULT line
_RUN = r"""
import json, os, sys, time
import torch
import chip_smoke
from nicer_slam_tpu_torch.slam import runner as runner_mod
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kind, data_dir, tag = sys.argv[1:4]
os.makedirs(chip_smoke.SMOKE_DIR, exist_ok=True)
torch.cuda.reset_peak_memory_stats()
r = runner_mod.SLAMRunner(conf=chip_smoke.write_conf(kind, data_dir),
                          root_dir=chip_smoke.SMOKE_DIR, exps_folder_name="exps_ab_" + tag,
                          quiet=True, device="cuda")
r.timer = runner_mod.PhaseTimer(r.device)
torch.cuda.synchronize()
t = time.perf_counter()
for f in range(r.n_images):
    r._stage_frame(f)
    r.track(f)
    if f % r.mapping_every_frame == 0:
        r.map(f)
torch.cuda.synchronize()
loop = time.perf_counter() - t
peak = torch.cuda.max_memory_allocated() / 2 ** 30
s = r.timer.summary()
from nicer_slam_tpu_torch.utils.plots import vis_hook
t = time.perf_counter()
r.render_full_image(r.n_images - 1)
torch.cuda.synchronize()
render = time.perf_counter() - t
t = time.perf_counter()
vis_hook(r, r.n_images - 1)
torch.cuda.synchronize()
vis = time.perf_counter() - t
# device operations of one tracking call and one mapping iteration
ops = {}
def profiled(name, fn, per):
    def wrapped(*a, **k):
        if name in ops:
            return fn(*a, **k)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = fn(*a, **k)
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kern = [e for e in ev if not e.name.startswith(("Memcpy", "Memset"))]
        ops[name] = dict(device_ops=len(ev) / per, kernels=len(kern) / per)
        return out
    return wrapped
runner_mod.track_frame = profiled("track", runner_mod.track_frame, r.num_cam_iters)
runner_mod.map_step = profiled("map", runner_mod.map_step, 1)
try:  # after every timed phase: a profiler fault loses only these counts
    r.track(r.n_images - 1)
    r.num_mapping_iters = 1
    r.map(r.n_images - 1)
except Exception as exc:
    print(f"profiler counts failed: {exc!r}", file=sys.stderr)
nan = dict(kernels=float("nan"), device_ops=float("nan"))
ops = {k: ops.get(k, nan) for k in ("track", "map")}
print("RESULT " + json.dumps(dict(
    s_per_frame=loop / r.n_images, ms_per_map_iter=s["mapping"]["mean_ms"],
    ms_per_track_iter=1000 * s["tracking"]["total_s"] / (s["tracking"]["count"] * r.num_cam_iters),
    ms_per_cache_build=s.get("cache", {}).get("mean_ms", float("nan")),
    render_s=render, vis_s=vis, peak_mem_GiB=peak,
    kernels_per_track_iter=ops["track"]["kernels"],
    kernels_per_map_iter=ops["map"]["kernels"],
    device_ops_per_track_iter=ops["track"]["device_ops"],
    device_ops_per_map_iter=ops["map"]["device_ops"],
    phases_s={k: v["total_s"] for k, v in s.items()})))
"""

METRICS = ("ms_per_map_iter", "ms_per_track_iter", "ms_per_cache_build", "s_per_frame",
           "render_s", "vis_s", "peak_mem_GiB", "kernels_per_track_iter", "kernels_per_map_iter",
           "device_ops_per_track_iter", "device_ops_per_map_iter")


def one_run(tree: str, kind: str, data_dir: str, tag: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run([sys.executable, "-c", _RUN, kind, data_dir, tag], cwd=tree,
                         env=env, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{tag} failed ({out.returncode}):\n{out.stderr[-3000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "path_ab.json"))
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_path_ab: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    trees = {"other": os.path.abspath(opt.other), "this": ROOT}
    procs = chip_smoke.start_scenes()
    try:
        data = {kind: chip_smoke.wait_scene(procs, kind) for kind in chip_smoke.PATHS}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    runs = []
    for i, side in enumerate(("other", "this", "this", "other")):
        for kind in chip_smoke.PATHS:
            r = one_run(trees[side], kind, data[kind], f"{kind}_{side}_{i}")
            runs.append(dict(side=side, kind=kind, turn=i, **r))
            print(f"turn {i} {side:5s} {kind:8s} " + " ".join(
                f"{m}={r[m]:.4g}" for m in METRICS), flush=True)
    for kind in chip_smoke.PATHS:
        for m in METRICS:
            vals = {s: [r[m] for r in runs if r["kind"] == kind and r["side"] == s]
                    for s in trees}
            print(f"{kind:8s} {m:20s} other {vals['other']} this {vals['this']}")
    os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
    with open(opt.out, "w") as f:
        json.dump(dict(card=card, trees=trees, runs=runs), f, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
