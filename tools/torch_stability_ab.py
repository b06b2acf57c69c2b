#!/usr/bin/env python3
"""How the flagship's frame-10 mapping call ends, in two checkouts of the
port, in turns, on one CUDA card.

  git archive <commit> | tar -x -C build/other
  python3 tools/torch_stability_ab.py --other build/other other,this,this,other \
      [--out build/stability_ab.json]

Writes chip_smoke.py's flagship scan once, then runs its flagship
configuration (the same conf edits and cuts) once per entry of the comma
list, each run in a process of its own started in that checkout, through
tools/torch_run_to_run.one_run: the SLAM loop over the 11 frames without
the vis hook and the checkpoint writes. The runs share code within a side,
inputs, weights and random draws; where a checkout's run is not
deterministic (float atomics before the K1/K2 table gradient was summed in
fixed point), its runs part where the card sums floats in another order,
which the optimisation amplifies.
Prints per run the last iteration's loss terms of the frame-10 mapping
call (the one with live flow edges, whose warp_loss chip_smoke.py holds
positive) and the translation error at frames 5 and 10; the JSON holds
every mapping call's losses and every frame's error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# one run in the checkout it is started in (argv: data_dir, tag); prints
# one RESULT line
_RUN = r"""
import json, os, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from tools import torch_run_to_run
os.makedirs(chip_smoke.SMOKE_DIR, exist_ok=True)
r = torch_run_to_run.one_run(chip_smoke.write_conf("flagship", sys.argv[1]), sys.argv[2])
print("RESULT " + json.dumps(r))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("turns", help="comma list of sides, 'other' or 'this', run in order")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "stability_ab.json"))
    opt = ap.parse_args()
    trees = {"other": os.path.abspath(opt.other), "this": ROOT}
    turns = opt.turns.split(",")
    if not set(turns) <= set(trees):
        ap.error(f"turns must be 'other' or 'this', got {opt.turns}")
    import torch
    if not torch.cuda.is_available():
        print("torch_stability_ab: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    t = time.perf_counter()
    chip_smoke.write_scene("flagship")
    data_dir = chip_smoke.scene_dir("flagship")
    print(f"scene {time.perf_counter() - t:.1f} s", flush=True)
    runs, failed = [], 0
    for i, side in enumerate(turns):
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", _RUN, data_dir, f"stab_{side}_{i}"],
                           cwd=trees[side], env=dict(os.environ, PYTHONPATH=trees[side]),
                           capture_output=True, text=True)
        if p.returncode != 0:
            print(f"{i} {side} failed ({p.returncode}):\n{p.stderr[-2000:]}", flush=True)
            failed += 1
            continue
        r = json.loads([ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")][-1][7:])
        end, err = r["map_calls"]["10"]["end"], r["trans_err"]
        print(f"{i} {side:5s} {time.perf_counter() - t:.0f}s "
              + " ".join(f"{k}={v:.4g}" for k, v in end.items())
              + f" trans_err5={err['5']:.4f} trans_err10={err['10']:.4f}", flush=True)
        runs.append(dict(side=side, turn=i, **r))
    os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
    with open(opt.out, "w") as f:
        json.dump(dict(card=card, trees=trees, runs=runs), f, indent=1)
    print(f"card: {card}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
