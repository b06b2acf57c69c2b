#!/usr/bin/env python3
"""Run-to-run spread of the torch port's SLAM loop on one CUDA card.

  python3 tools/torch_run_to_run.py [--out build/run_to_run.json]

Runs chip_smoke.py's SLAM configurations (the same synthetic scans, confs
and cuts) twice each in this process, without the vis hook, and
records the loss of every mapping iteration, the best tracking loss of
every frame and the translation error of every frame. The runs share code,
inputs, weights and random draws, and every sum on the paths has a fixed
order (the K1/K2 backward sums its table gradient in fixed point, the
segment sums of the depth loss run over a one-hot mask), so every
iteration should be bit-identical; any
float sum in an order that changes from run to run would show as a gap that
starts at float32 rounding and grows as far as the optimisation amplifies
it, and a launch that read memory it does not own would show at once.

For each mapping call the report gives the number of leading iterations
whose losses are bit-identical across runs, the first iteration at which
they part by more than 1e-6, 1e-3 and 1e-1 of the loss, and the last
iteration's loss terms of each run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


RUNS = 2


def one_run(conf: str, tag: str) -> dict:
    import torch

    from nicer_slam_tpu_torch.slam import runner as runner_mod

    losses, calls = [], {}
    inner = runner_mod.map_step

    def recording_map_step(*args, **kwargs):
        out = inner(*args, **kwargs)
        losses.append(float(out[2]["loss"]))
        return out

    runner_mod.map_step = recording_map_step
    try:
        r = runner_mod.SLAMRunner(conf=conf, root_dir=chip_smoke.SMOKE_DIR,
                                  exps_folder_name=f"exps_r2r_{tag}", quiet=True,
                                  device="cuda")
        r.timer = runner_mod.PhaseTimer(r.device)
        for f in range(r.n_images):
            r._stage_frame(f)
            r.track(f)
            if f % r.mapping_every_frame == 0:
                r.map(f)
                calls[f] = dict(losses=list(losses), end={
                    k: float(v) for k, v in r.last_map_terms.items()})
                losses.clear()
        torch.cuda.synchronize()
    finally:
        runner_mod.map_step = inner
    gt = r.dataset.gt_pose_all
    return dict(
        map_calls=calls,
        track_best_loss={f: float(v) for f, v in r.track_residual.items()},
        trans_err={f: float(np.linalg.norm(r.est_pose_all[f][:3, 3] - gt[f][:3, 3]))
                   for f in range(r.n_images)})


def spread(runs: list) -> dict:
    """Per mapping call: bit-identical leading iterations and the first
    iteration past each relative gap, over all pairs with run 0."""
    out = {}
    for f in runs[0]["map_calls"]:
        a = np.array(runs[0]["map_calls"][f]["losses"], np.float64)
        gaps = np.max([np.abs(np.array(r["map_calls"][f]["losses"]) - a)
                       for r in runs[1:]], axis=0) / np.maximum(np.abs(a), 1e-30)
        same = int(np.argmax(gaps > 0)) if (gaps > 0).any() else len(a)
        out[f] = dict(bit_identical_iters=same, **{
            f"first_iter_gap>{t:g}": (int(np.argmax(gaps > t)) if (gaps > t).any() else None)
            for t in (1e-6, 1e-3, 1e-1)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "run_to_run.json"))
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_run_to_run: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    procs = chip_smoke.start_scenes()
    report = dict(card=card, runs=RUNS, paths={})
    try:
        for kind in chip_smoke.PATHS:
            conf = chip_smoke.write_conf(kind, chip_smoke.wait_scene(procs, kind))
            runs = []
            for i in range(RUNS):
                t = time.perf_counter()
                runs.append(one_run(conf, f"{kind}_{i}"))
                print(f"{kind} run {i}: {time.perf_counter() - t:.1f} s", flush=True)
            report["paths"][kind] = dict(spread=spread(runs), runs=runs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for kind, rep in report["paths"].items():
        print(f"== {kind}")
        for f, s in rep["spread"].items():
            print(f"  frame-{f} mapping call: {s}")
            for i, r in enumerate(rep["runs"]):
                end = r["map_calls"][f]["end"]
                print(f"    run {i}: " + " ".join(f"{k}={v:.6g}" for k, v in end.items()))
        for i, r in enumerate(rep["runs"]):
            print(f"  run {i} translation error: " + " ".join(
                f"{f}:{e:.4f}" for f, e in r["trans_err"].items()))
            print(f"  run {i} best tracking loss: " + " ".join(
                f"{f}:{e:.6g}" for f, e in r["track_best_loss"].items()))
    os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
    with open(opt.out, "w") as f:
        json.dump(report, f)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
