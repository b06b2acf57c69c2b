#!/usr/bin/env python3
"""Where the K1/K2 backward with a table gradient spends its time: the
lane-merge design of a given tree (its ``csrc/hash_kernels.cuh``), this
checkout's vertex-merge design, and copies of each that leave one part
out, timed in turns on one CUDA card.

  git archive <commit> nicer_slam_tpu_torch | tar -x -C build/before
  python3 tools/hash_bwd_ablate.py --before build/before [--out FILE]

``--before`` is a tree with the three-pass backward (a maxima pass over the
cotangents, the fixed-point scatter with its lane merge, a sweep over every
row of the table), as ``nicer_slam_tpu_torch/csrc`` held it up to commit
a41986d. The sides, each built with nvcc into ``build/hash_ablate/<name>/``
from a copy of that tree's ``hash_encoder.cu`` and a patched
``hash_kernels.cuh`` (the segmented sources are built once, unpatched, and
linked into each):

  * ``before``: the design as it is; ``before-nogx`` the same launch with
    no grad_x asked for;
  * ``maxima``: the maxima pass alone;
  * ``sweep``: the sweep alone;
  * ``nosweep``: the maxima pass and the scatter, no sweep (the
    accumulator is left dirty: this side has one of its own);
  * ``noatomics``: every 64-bit atomic left out (each contribution is still
    computed and rounded, and the lane merge still runs);
  * ``nomerge``: no lane merge: each lane issues its own atomics;
  * ``l2``: the atomics aimed at the accumulator's first 2^18 words (2 MB,
    held in L2), which the sweep zeroes again;
  * ``this``: this checkout's backward (hash_bwd_merge_kernel and its last
    pass), and copies of it built the same way: ``this-maxima``,
    ``this-sweep``, ``this-nosweep`` (the accumulator and bitmap left
    dirty: a scratch of its own), ``this-noatomics`` (every sum still
    rounded, no atomic issued, no row marked), ``this-nomerge`` (every
    lane its own head: each lane's 8 corners take their own atomics,
    coalesced as the merged ones) and ``this-redmark`` (the colour grid's
    rows marked by an atomicOr from every row's channel-0 lane, the
    atomics returning nothing, instead of by the atomic that finds the row
    0); ``this-nogx`` is ``this`` with no grad_x asked for.

Operands: ``chip_smoke.HASH_CASES`` on ray-ordered and uniform points, as
``chip_smoke.check_hash_kernels`` makes them (random table and cotangents,
seeded). Each launch is timed alone (CUDA events behind chip_smoke's device
sleep, mean of 10 after 2), the sides forth and back over ``--rounds``
rounds. Only ``before`` and ``this`` are checked: their table gradients
and grad_x within ``chip_smoke.GRAD_REL_L2`` of each other, this
checkout's accumulator and bitmap zero after its launches. The card's name and power limit are
printed with the table and written to the JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# the three launches of the before tree's launch_bwd_rows, each behind a
# switch (the text found once)
SWITCHES = [
    ("    if (g_table != nullptr) {\n      cudaError_t e = cudaMemsetAsync(maxes",
     "    if (g_table != nullptr && ABL_MAXIMA) {\n      cudaError_t e = cudaMemsetAsync(maxes"),
    ("    const int rc = launch_blocks(kern, N, sl.nv, kPts, floats, s,",
     "    const int rc = !ABL_SCATTER && g_table != nullptr ? 0 : launch_blocks("
     "kern, N, sl.nv, kPts, floats, s,"),
    ("    fixed_sweep_kernel<<<dim3(264, sl.nv), 256, 0, s>>>(",
     "    if (!ABL_SWEEP) return 0;\n    fixed_sweep_kernel<<<dim3(264, sl.nv), 256, 0, s>>>("),
]
ATOMIC = "    atomicAdd(p + c, (unsigned long long)__float2ll_rn(ldexpf(v[c], k)));"

# name -> ({switch: 0/1}, [(text, replacement), ...])
ABLATIONS = {
    "before": ({}, []),
    "maxima": ({"ABL_SCATTER": 0, "ABL_SWEEP": 0}, []),
    "sweep": ({"ABL_MAXIMA": 0, "ABL_SCATTER": 0}, []),
    "nosweep": ({"ABL_SWEEP": 0}, []),
    "noatomics": ({}, [(ATOMIC, "    { const long long q = __float2ll_rn(ldexpf(v[c], k));\n"
                                "      if (q == 0x7fffffffffffffffLL) "
                                "atomicAdd(p + c, (unsigned long long)q); }")]),
    "nomerge": ({}, [("      if (__any_sync(0xffffffffu, row != kNoRow && __popc(peers) > 1)) {",
                      "      if (false) {")]),
    "l2": ({}, [("  unsigned long long* p = reinterpret_cast<unsigned long long*>(acc) + at;",
                 "  unsigned long long* p = reinterpret_cast<unsigned long long*>(acc) + "
                 "(at & 0x3ffffu);")]),
}
# this checkout's merge path, each launch behind a switch
THIS_SWITCHES = [
    ("        int rc = launch_level_max(g_feat, g_dfeat, N, sl, CS, maxes, s);",
     "        int rc = ABL_MAXIMA ? launch_level_max(g_feat, g_dfeat, N, sl, CS, maxes, s) : 0;"),
    ("        rc = launch_blocks(mkern,", "        rc = !ABL_SCATTER ? 0 : launch_blocks(mkern,"),
    ("        if (touched != nullptr)\n          touched_sweep_kernel<CS>",
     "        if (!ABL_SWEEP) return 0;\n        if (touched != nullptr)\n"
     "          touched_sweep_kernel<CS>"),
]
THIS_ATOMICS = """      if (touched != nullptr) {
        // the first add to a row finds it 0 (so may a later one: no harm)
        if (atomicAdd(p, q) == 0ull && c == 0) atomicOr(touched + (row >> 5), 1u << (row & 31));
      } else {
        atomicAdd(p, q);
      }"""
THIS_ABLATIONS = {
    "this": ({}, []),
    "this-maxima": ({"ABL_SCATTER": 0, "ABL_SWEEP": 0}, []),
    "this-sweep": ({"ABL_MAXIMA": 0, "ABL_SCATTER": 0}, []),
    "this-nosweep": ({"ABL_SWEEP": 0}, []),
    "this-noatomics": ({}, [(THIS_ATOMICS, "      if (q == 0x7fffffffffffffffull) "
                                           "atomicAdd(p, q);")]),
    "this-nomerge": ({}, [("    const bool same = lane > 0 &&",
                           "    const bool same = false && lane > 0 &&")]),
    "this-redmark": ({}, [(THIS_ATOMICS, """      atomicAdd(p, q);
      if (touched != nullptr && c == 0) atomicOr(touched + (row >> 5), 1u << (row & 31));""")]),
}
# sides whose accumulator is left dirty (one of their own)
DIRTY = ("nosweep", "this-nosweep")
SEGMENTS = ("hash_encoder_segments.cu", "hash_encoder_segments_bwd.cu")


def patched(header: str, name: str) -> str:
    this = name.startswith("this")
    switches, edits = (THIS_ABLATIONS if this else ABLATIONS)[name]
    text = header
    for old, new in (THIS_SWITCHES if this else SWITCHES) + edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in the header once")
        text = text.replace(old, new)
    defs = "".join(f"#define {k} {switches.get(k, 1)}\n"
                   for k in ("ABL_MAXIMA", "ABL_SCATTER", "ABL_SWEEP"))
    return text.replace("#pragma once\n", "#pragma once\n" + defs, 1)


def build_all(before: str) -> dict:
    """{name: CDLL} of every ablation of the before tree and of this
    checkout: one nvcc per source, all started together, then one link per
    side (each tree's segmented sources built once, unpatched)."""
    from nicer_slam_tpu_torch.ops import _cuda
    base = os.path.join(ROOT, "build", "hash_ablate")
    cc = [_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    jobs, objs = [], {}
    names = []
    for tree, table in ((os.path.abspath(before), ABLATIONS), (ROOT, THIS_ABLATIONS)):
        src = os.path.join(tree, "nicer_slam_tpu_torch", "csrc")
        header = open(os.path.join(src, "hash_kernels.cuh")).read()
        seg_dir = os.path.join(base, "segments-this" if table is THIS_ABLATIONS else "segments")
        os.makedirs(seg_dir, exist_ok=True)
        segs = []
        for f in SEGMENTS:
            if os.path.exists(os.path.join(src, f)):
                o = os.path.join(seg_dir, f + ".o")
                jobs.append(subprocess.Popen(cc + ["-c", "-o", o, os.path.join(src, f)]))
                segs.append(o)
        for name in table:
            d = os.path.join(base, name)
            os.makedirs(d, exist_ok=True)
            for f in ("hash_encoder.cu", "hash_grid.cuh"):
                shutil.copy(os.path.join(src, f), d)
            with open(os.path.join(d, "hash_kernels.cuh"), "w") as fh:
                fh.write(patched(header, name))
            o = os.path.join(d, "hash_encoder.o")
            jobs.append(subprocess.Popen(cc + ["-c", "-o", o,
                                               os.path.join(d, "hash_encoder.cu")]))
            objs[name] = [o] + segs
            names.append(name)
    if any(j.wait() != 0 for j in jobs):
        raise RuntimeError("hash_bwd_ablate: a build failed")
    libs = {}
    for name in names:
        lib = os.path.join(base, name, "libhash.so")
        subprocess.run([*cc, "-shared", "-o", lib, *objs[name]], check=True)
        dll = ctypes.CDLL(lib)
        dll.nsl_hash_encode_bwd.argtypes = _cuda._SIGNATURES["nsl_hash_encode_bwd"]
        dll.nsl_hash_encode_bwd.restype = ctypes.c_int
        libs[name] = dll
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", required=True,
                    help="a tree whose nicer_slam_tpu_torch/csrc holds the three-pass backward")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "hash_bwd_ablate.json"))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.ops import hash_encoder as he
    if not torch.cuda.is_available():
        print("hash_bwd_ablate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    libs = build_all(args.before)
    sides = list(libs) + ["before-nogx", "this-nogx"]
    specs = chip_smoke.hash_specs()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows_out, failures = [], []
    print(f"K1/K2 backward ablation on {card}", flush=True)
    for grid, jac, kind in chip_smoke.HASH_CASES:
        spec = specs[grid]
        L, C, T = spec.num_levels, spec.level_dim, spec.total_entries
        meta, scl = he._level_tables(spec, 1.0, str(dev))
        table = torch.rand((T, C), generator=g, device=dev) * 2 - 1
        clean = he.fixed_point_scratch(spec, dev)
        dirty = {n: torch.zeros_like(clean) for n in DIRTY}
        for order in ("ray", "uniform"):
            x = chip_smoke.hash_points(g, dev, kind, order)
            N = x.shape[0]
            gf = torch.randn((N, L * C), generator=g, device=dev)
            gd = torch.randn((N, L * C, 3), generator=g, device=dev) if jac else None
            outs = {s: (torch.empty_like(table), torch.empty((N, 3), device=dev))
                    for s in sides}

            def launch(side):
                lib = libs[side.replace("-nogx", "")]
                gt, gx = outs[side]
                scratch = dirty.get(side, clean)
                stream = torch.cuda.current_stream().cuda_stream

                def fn():
                    rc = lib.nsl_hash_encode_bwd(
                        x.data_ptr(), table.data_ptr(), meta.data_ptr(), scl.data_ptr(),
                        gf.data_ptr(), _cuda.ptr(gd), gt.data_ptr(),
                        None if side.endswith("-nogx") else gx.data_ptr(),
                        scratch.data_ptr(), N, L, C, 1.0, T, stream)
                    if rc != 0:
                        raise RuntimeError(f"{side}: CUDA error {rc}")
                return fn

            for side in ("before", "this"):
                launch(side)()
            torch.cuda.synchronize()
            rel = chip_smoke.rel_l2(outs["this"][0], outs["before"][0])
            relx = chip_smoke.rel_l2(outs["this"][1], outs["before"][1])
            times = {s: [] for s in sides}
            for r in range(args.rounds):
                for side in (sides if r % 2 == 0 else sides[::-1]):
                    times[side].append(chip_smoke.cuda_time(launch(side)))
            zero = he.fixed_point_state_is_zero(spec, clean)
            ok = rel <= chip_smoke.GRAD_REL_L2 and relx <= chip_smoke.GRAD_REL_L2 and zero
            case = f"{'K1' if jac else 'K2'} bwd {grid}/{kind}/{order}"
            if not ok:
                failures.append(case)
            ms = {s: sum(v) / len(v) for s, v in times.items()}
            print(f"{case} ({N} points): " + ", ".join(f"{s} {ms[s]:.4f}" for s in sides)
                  + f" ms; this vs before: table rel L2 {rel:.2e}, grad_x {relx:.2e}; "
                  f"accumulator zero {zero}", flush=True)
            rows_out.append(dict(case=case, points=N, ms=ms, rounds=times,
                                 table_rel_l2=rel, grad_x_rel_l2=relx, zero_after=zero,
                                 ok=ok))
            del x, gf, gd, outs
            torch.cuda.empty_cache()
        del table, dirty
        torch.cuda.empty_cache()
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "cases": rows_out}, f, indent=1)
    if failures:
        print(f"hash_bwd_ablate: disagreement on {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
