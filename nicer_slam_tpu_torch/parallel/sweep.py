"""Scene-parallel sweep: one SLAM scene per device (counterpart of
tools/sweep.py).

Scene runs are independent (no collectives), so each scene is the port's
``exp_runner`` in a process of its own on ``cuda:k`` (or the CPU). The
JAX sweep runs its scenes in threads; here the SLAM loop is host-bound,
and threads would run its Python one at a time behind the GIL, so each
scene gets a process (started with ``spawn``: no CUDA state crosses a
fork). More scenes than ``devices x scenes_per_device`` run in waves;
``scenes_per_device > 1`` time-shares a card between scenes, whose host
work then overlaps. The kernels are built once in the parent before any
scene starts, so the scenes do not race each other's first build.

Usage:
  python -m nicer_slam_tpu_torch.parallel.sweep --conf A.conf --conf B.conf \\
      [--scan_id N ...] [--exps_folder exps_sweep] [--root_dir .] \\
      [--max_devices N] [--scenes_per_device K] [--device cuda|cpu] [--verbose]

Library use: ``sweep([conf_a, conf_b], root_dir=...)`` returns one
``{ok, run_dir, wall_s, device, launches?, error?}`` per conf
(``launches``: the scene's kernel launches by kernel, when it ran).
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
import time
import traceback
from typing import List, Optional, Sequence


def _run_one(conf: str, device: str, root_dir: str, exps_folder: str,
             scan_id: Optional[int], conn) -> None:
    t0 = time.time()
    result = {"device": device}
    try:
        from ..ops import _cuda
        from ..training import exp_runner

        argv = ["--conf", conf, "--root_dir", root_dir, "--exps_folder", exps_folder,
                "--device", device]
        if scan_id is not None:
            argv += ["--scan_id", str(scan_id)]
        runner = exp_runner.main(argv)
        # the process starts at 0: the scene's own kernel launches
        result.update(ok=True, run_dir=runner.rundir, launches=_cuda.launch_counts())
    except Exception:
        result.update(ok=False, error=traceback.format_exc())
    result["wall_s"] = time.time() - t0
    conn.send(result)
    conn.close()


def devices_for(device: str, max_devices: Optional[int]) -> List[str]:
    """The devices the scenes go to: every visible card (``cuda``), or the
    CPU once per ``max_devices`` (``cpu``)."""
    if device == "cpu":
        return ["cpu"] * max(1, max_devices or 1)
    import torch

    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("sweep: no CUDA device (pass device='cpu' for the CPU)")
    return [f"cuda:{k}" for k in range(n)][:max_devices]


def sweep(confs: Sequence[str], root_dir: str = ".", exps_folder: str = "exps",
          scan_ids: Optional[Sequence[int]] = None, max_devices: Optional[int] = None,
          quiet: bool = True, scenes_per_device: int = 1,
          device: str = "cuda") -> List[dict]:
    """Run each conf through exp_runner in its own process, scene i on
    device i mod (number of devices), ``devices x scenes_per_device`` at a
    time (each process takes torch's threads from the environment, e.g.
    OMP_NUM_THREADS). Returns ``{ok, run_dir, wall_s, device, launches?,
    error?}`` per conf."""
    devices = devices_for(device, max_devices)
    if device != "cpu":
        from ..ops import _cuda
        _cuda.build()
    if scan_ids is None:
        scan_ids = [None] * len(confs)
    ctx = mp.get_context("spawn")
    results: List[dict] = [dict() for _ in confs]
    width = len(devices) * max(1, scenes_per_device)
    for start in range(0, len(confs), width):
        wave = []
        for k, i in enumerate(range(start, min(start + width, len(confs)))):
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_run_one, name=f"sweep-{i}",
                               args=(confs[i], devices[k % len(devices)], root_dir,
                                     exps_folder, scan_ids[i], send))
            proc.start()
            send.close()
            wave.append((i, proc, recv))
        for i, proc, recv in wave:
            try:
                results[i] = recv.recv()
            except EOFError:
                results[i] = {"ok": False, "device": devices[(i - start) % len(devices)],
                              "error": f"scene process exited with code {proc.exitcode}"}
            proc.join()
            if not quiet:
                print(f"[sweep] scene {i} done: ok={results[i].get('ok')}", flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--conf", action="append", required=True,
                   help="conf file (repeat for each scene)")
    p.add_argument("--scan_id", action="append", type=int, default=None,
                   help="optional scan_id override per conf (repeat)")
    p.add_argument("--exps_folder", default="exps_sweep")
    p.add_argument("--root_dir", default=".")
    p.add_argument("--max_devices", type=int, default=None)
    p.add_argument("--scenes_per_device", type=int, default=1,
                   help="time-share each device between N concurrent scenes")
    p.add_argument("--device", default="cuda", help="cuda (every visible card) or cpu")
    p.add_argument("--verbose", action="store_true")
    a = p.parse_args(argv)
    if a.scan_id is not None and len(a.scan_id) != len(a.conf):
        p.error("--scan_id must be given once per --conf (or not at all)")
    t0 = time.time()
    results = sweep(a.conf, root_dir=a.root_dir, exps_folder=a.exps_folder,
                    scan_ids=a.scan_id, max_devices=a.max_devices, quiet=not a.verbose,
                    scenes_per_device=a.scenes_per_device, device=a.device)
    ok = sum(1 for r in results if r.get("ok"))
    for conf, r in zip(a.conf, results):
        print(f"[sweep] {'ok' if r.get('ok') else 'FAILED':6s} {conf} on {r.get('device')} "
              f"({r.get('wall_s', 0):.1f}s) -> {r.get('run_dir')}")
        if not r.get("ok") and r.get("error"):
            print(r["error"], file=sys.stderr)
    print(f"[sweep] {ok}/{len(results)} scenes completed, wall {time.time() - t0:.1f}s")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
