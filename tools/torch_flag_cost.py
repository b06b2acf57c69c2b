#!/usr/bin/env python3
"""What torch's global deterministic mode costs the port, kernel by kernel,
on one CUDA card.

  python3 tools/torch_flag_cost.py [--tree DIR] [--out build/flag_cost.json]

Runs chip_smoke.py's flagship configuration (the same synthetic scan, conf
and cuts) from the checkout at ``--tree`` (this one by default) in four
processes, in turns: flag off, on, on, off. "On" is what the port's
runner once set for the whole process: ``CUBLAS_WORKSPACE_CONFIG=:4096:8``
before the first cuBLAS call, ``torch.use_deterministic_algorithms(True)``
and no filling of fresh memory; "off" sets none of it (a runner that sets
it itself is stopped from doing so). Each process runs frames 0-5 (mapping
at 0 and 5) under the runner's phase timers, then, under torch.profiler,
one more tracking call (per iteration), one mapping iteration (no BA) and
one density-cache build, and records every device operation's name, count
and device time.

Reports per piece the device ms and device operations of each mode, the
kernels whose time moved most between the modes, the kernels that only one
mode runs, and the GEMM kernels of each mode (a changed name is a changed
cuBLAS algorithm); and ms per tracking / mapping iteration and per cache
build from the phase timers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# one process of one mode in the checkout it is started in (argv: mode,
# data_dir, tag); prints one RESULT line
_RUN = r"""
import json, os, sys
mode, data_dir, tag = sys.argv[1:4]
if mode == "on":
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
else:
    os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
import torch
import chip_smoke
from nicer_slam_tpu_torch.slam import runner as runner_mod
if hasattr(runner_mod, "use_deterministic_cuda"):
    runner_mod.use_deterministic_cuda = lambda: None
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.use_deterministic_algorithms(mode == "on")
torch.utils.deterministic.fill_uninitialized_memory = False
os.makedirs(chip_smoke.SMOKE_DIR, exist_ok=True)
r = runner_mod.SLAMRunner(conf=chip_smoke.write_conf("flagship", data_dir),
                          root_dir=chip_smoke.SMOKE_DIR, exps_folder_name="exps_flag_" + tag,
                          quiet=True, device="cuda")
r.timer = runner_mod.PhaseTimer(r.device)
for f in range(6):
    r._stage_frame(f)
    r.track(f)
    if f % r.mapping_every_frame == 0:
        r.map(f)
s = r.timer.summary()
timed = dict(ms_per_track_iter=1000 * s["tracking"]["total_s"]
             / (s["tracking"]["count"] * r.num_cam_iters),
             ms_per_map_iter=s["mapping"]["mean_ms"],
             ms_per_cache_build=s["cache"]["mean_ms"])

def profiled(fn):
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        c = by.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += e.time_range.elapsed_us()
    return by

pieces = {}
def profiling(name, fn, per):
    def wrapped(*a, **k):
        out = []
        pieces[name] = dict(per=per, ops=profiled(lambda: out.append(fn(*a, **k))))
        return out[0]
    return wrapped
runner_mod.track_frame = profiling("track", runner_mod.track_frame, r.num_cam_iters)
r.track(5)
runner_mod.map_step = profiling("map", runner_mod.map_step, 1)
r.num_mapping_iters = 1
r.map(5)
pieces["cache"] = dict(per=1, ops=profiled(r._refresh_cache))
print("RESULT " + json.dumps(dict(
    timed=timed, pieces=pieces,
    deterministic=torch.are_deterministic_algorithms_enabled(),
    cublas_workspace=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))))
"""

TURNS = ("off", "on", "on", "off")
GEMM_MARKS = ("gemm", "xmma", "cutlass", "cublas", "gemv")


def one_run(tree: str, mode: str, data_dir: str, tag: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    env.pop("CUBLAS_WORKSPACE_CONFIG", None)
    out = subprocess.run([sys.executable, "-c", _RUN, mode, data_dir, tag], cwd=tree,
                         env=env, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{tag} failed ({out.returncode}):\n{out.stderr[-3000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def per_unit(runs, mode, piece):
    """{kernel name: (count, device us) per iteration}, mean over the
    mode's runs."""
    acc = defaultdict(lambda: [0.0, 0.0])
    sel = [r for r in runs if r["mode"] == mode]
    for r in sel:
        p = r["pieces"][piece]
        for name, (n, us) in p["ops"].items():
            acc[name][0] += n / p["per"] / len(sel)
            acc[name][1] += us / p["per"] / len(sel)
    return dict(acc)


def summarise(runs) -> dict:
    out = {}
    for piece in ("track", "map", "cache"):
        off, on = per_unit(runs, "off", piece), per_unit(runs, "on", piece)
        rows = []
        for name in set(off) | set(on):
            a, b = off.get(name, [0.0, 0.0]), on.get(name, [0.0, 0.0])
            rows.append(dict(name=name, n_off=a[0], n_on=b[0], us_off=a[1], us_on=b[1],
                             d_us=b[1] - a[1]))
        rows.sort(key=lambda x: -abs(x["d_us"]))
        gemms = {m: sorted(n for n in d if any(k in n.lower() for k in GEMM_MARKS))
                 for m, d in (("off", off), ("on", on))}
        out[piece] = dict(
            device_ms={m: sum(v[1] for v in d.values()) / 1e3 for m, d in
                       (("off", off), ("on", on))},
            device_ops={m: sum(v[0] for v in d.values()) for m, d in
                        (("off", off), ("on", on))},
            only_on=[x for x in rows if x["n_off"] == 0],
            only_off=[x for x in rows if x["n_on"] == 0],
            moved=rows[:25], gemm_names=gemms,
            gemm_changed=gemms["off"] != gemms["on"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to measure")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "flag_cost.json"))
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flag_cost: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    tree = os.path.abspath(opt.tree)
    procs = chip_smoke.start_scenes()
    try:
        data = chip_smoke.wait_scene(procs, "flagship")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    runs = []
    for i, mode in enumerate(TURNS):
        r = one_run(tree, mode, data, f"{mode}_{i}")
        runs.append(dict(mode=mode, turn=i, **r))
        print(f"turn {i} {mode:3s} deterministic={r['deterministic']} "
              f"workspace={r['cublas_workspace']} " + " ".join(
                  f"{k}={v:.4g}" for k, v in r["timed"].items()) + " " + " ".join(
                  f"{p}_device_ms={sum(v[1] for v in d['ops'].values()) / d['per'] / 1e3:.4g}"
                  for p, d in r["pieces"].items()), flush=True)
    summ = summarise(runs)
    for piece, s in summ.items():
        print(f"== {piece}: device ms off {s['device_ms']['off']:.4f} on "
              f"{s['device_ms']['on']:.4f}; device ops off {s['device_ops']['off']:.1f} on "
              f"{s['device_ops']['on']:.1f}; GEMM names changed: {s['gemm_changed']}")
        for x in s["moved"][:15]:
            print(f"   d {x['d_us']:+9.2f} us  off {x['us_off']:9.2f} ({x['n_off']:.2f}) "
                  f"on {x['us_on']:9.2f} ({x['n_on']:.2f})  {x['name'][:110]}")
        for tag in ("only_on", "only_off"):
            for x in s[tag]:
                print(f"   {tag}: {x['us_on'] + x['us_off']:9.2f} us "
                      f"({x['n_on'] + x['n_off']:.2f})  {x['name'][:110]}")
        if s["gemm_changed"]:
            print(f"   GEMMs off: {s['gemm_names']['off']}")
            print(f"   GEMMs on:  {s['gemm_names']['on']}")
    os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
    with open(opt.out, "w") as f:
        json.dump(dict(card=card, tree=tree, runs=[{k: v for k, v in r.items()
                                                    if k != "pieces"} for r in runs],
                       summary=summ), f, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
