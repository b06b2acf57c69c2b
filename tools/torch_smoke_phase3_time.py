#!/usr/bin/env python3
"""The build and the phase-3 checks of a tree's chip_smoke.py, timed one
function at a time on one CUDA card: where a change moved the smoke's
time, without the phases that share the card and host with others.

  git archive <commit> | tar -x -C build/other
  rm -rf build/other/build/kernels      # so that the build is timed
  python3 tools/torch_smoke_phase3_time.py build/other

The checks, and their arguments, are this checkout's chip_smoke.PHASE3;
each is looked up by name in the tree's own chip_smoke.py, with the tree's
package (run it once per tree, in turns, in one call: hosts differ from
call to call), and a name the tree lacks stops the run. Prints the
build's seconds, each check's seconds (its own output swallowed) and the
phase's total, with the checks that failed.
"""
import contextlib
import importlib
import importlib.util
import io
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch  # noqa: E402

cs = importlib.import_module("chip_smoke")
from nicer_slam_tpu_torch.ops import _cuda  # noqa: E402

here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
spec = importlib.util.spec_from_file_location("chip_smoke_here", here)
own = importlib.util.module_from_spec(spec)
spec.loader.exec_module(own)
checks = [(getattr(cs, fn.__name__), args) for fn, args in own.PHASE3]

dev = torch.device("cuda", 0)
t = time.perf_counter()
_cuda.build()
_cuda.library()
print(f"{root}: build {time.perf_counter() - t:.1f} s", flush=True)
chk = cs.Checks()
total = 0.0
for f, args in checks:
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        f(dev, chk, *args)
    torch.cuda.empty_cache()
    dt = time.perf_counter() - t
    total += dt
    print(f"  {f.__name__}{list(args) if args else ''}: {dt:.1f} s", flush=True)
print(f"phase 3 total {total:.1f} s; failures {chk.failures}", flush=True)
