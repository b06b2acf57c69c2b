#!/usr/bin/env python3
"""Where the K1/K2 backward with a table gradient spends its time: the
design of a given tree, this checkout's, and copies of each that leave one
part out, timed in turns on one CUDA card.

  git archive <commit> nicer_slam_tpu_torch | tar -x -C build/before
  python3 tools/hash_bwd_ablate.py --before build/before [--sides all|before|this]
      [--cases channels,wide,bf16[,shipped]] [--rounds 2] [--out FILE]

``--before`` is a tree as of commit f83df7c: at C = 2, 4, 8 the merge
kernel, and at every other channel count the lane-merge kernel (a
``__match_any_sync`` chain at each corner, CS separate 64-bit atomics a
row, a sweep over every row), each as one (maxima, scatter, sweep) chain a
slice of at most 32 (level, segment) warps, with an exponent per slice's
virtual level. The sides, each built with nvcc into
``build/hash_ablate/<name>/`` from a copy of that tree's ``hash_encoder.cu``
and ``hash_encoder_segments_bwd.cu`` and a patched ``hash_kernels.cuh``
(the tree's forwards, ``hash_encoder_segments.cu``, built once, unpatched,
and linked into each):

  * ``before``: the design as it is; ``before-nogx`` the same launch with
    no grad_x asked for;
  * ``maxima``: the maxima passes alone; ``sweep``: the sweeps alone;
    ``nosweep``: the maxima and the scatter, no sweep (the accumulator is
    left dirty: this side has a scratch of its own);
  * ``noatomics``: every 64-bit atomic left out (each contribution is still
    computed and rounded, and the merges still run);
  * ``nomerge``: no merge (the lane merge: each lane issues its own row of
    atomics; the merge kernel: every lane its own head);
  * ``halfslices``: at most half as many warps a launch as the kernel
    allows, so a grid of more than one slice runs twice as many (what the
    slices' re-reads of the points, and the before tree's chain a slice,
    cost);
  * ``this``, ``this-maxima``, ``this-sweep``, ``this-nosweep``,
    ``this-noatomics``, ``this-nomerge``, ``this-halfslices``,
    ``this-nogx``: the same for this checkout's backward
    (hash_bwd_merge_kernel at every C, one maxima pass and one sweep a
    grid).

Cases (``--cases``; random table and cotangents, seeded, as chip_smoke's
checks make them): ``channels``, chip_smoke.HASH_CHANNEL_CASES; ``wide``,
chip_smoke.HASH_WIDE_CASES with K1 and K2; both at a tracking iteration's
1024 x 98 ray-ordered points and as many uniform ones; ``bf16``, K2's
backward on bf16 rows at L16 C16 and L8 C12 on the ray-ordered points;
``shipped``, chip_smoke.HASH_CASES on ray-ordered and uniform points. Each
launch is timed alone (CUDA events behind chip_smoke's device sleep, mean
of 10 after 2), the sides forth and back over ``--rounds`` rounds. Only
``before`` and ``this`` are checked: their table gradients and grad_x
within ``chip_smoke.GRAD_REL_L2`` of each other, this checkout's table
gradient bit for bit with ``hash_table_grad_fixed_plain`` and its
accumulator, maxima and bitmap zero after its launches (whether the before
tree's equals the plain version is reported). The card's name and power
limit are printed with the table and written to the JSON.
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

# the before tree's launches, each behind a switch (each text found once):
# the lane-merge chain, the merge-kernel chain, and the slicing
SWITCHES = [
    ("      const int rc = launch_level_max(g_feat, g_dfeat, N, sl, CS, maxes, s);",
     "      const int rc = ABL_MAXIMA ? launch_level_max(g_feat, g_dfeat, N, sl, CS, maxes, s)"
     " : 0;"),
    ("    const int rc = launch_blocks(kern, N, sl.nv, kPts, floats, s,",
     "    const int rc = !ABL_SCATTER && g_table != nullptr ? 0 : launch_blocks("
     "kern, N, sl.nv, kPts, floats, s,"),
    ("\n    fixed_sweep_kernel<<<dim3(264, sl.nv), 256, 0, s>>>(",
     "\n    if (!ABL_SWEEP) return 0;\n    fixed_sweep_kernel<<<dim3(264, sl.nv), 256, 0, s>>>("),
    ("        int rc = launch_level_max(g_feat, g_dfeat, N, sl, CS, maxes, s);",
     "        int rc = ABL_MAXIMA ? launch_level_max(g_feat, g_dfeat, N, sl, CS, maxes, s) : 0;"),
    ("        rc = launch_blocks(mkern,", "        rc = !ABL_SCATTER ? 0 : launch_blocks(mkern,"),
    ("        if (touched != nullptr)\n          touched_sweep_kernel<CS>",
     "        if (!ABL_SWEEP) return 0;\n        if (touched != nullptr)\n"
     "          touched_sweep_kernel<CS>"),
]
# both trees' for_slices: at most half the warps a launch
HALF = ("  if (maxw < 1) return (int)cudaErrorInvalidValue;\n",
        "  if (maxw < 1) return (int)cudaErrorInvalidValue;\n"
        "  if (ABL_HALF) maxw = (maxw + 1) / 2;\n")
LANE_ATOMIC = "    atomicAdd(p + c, (unsigned long long)__float2ll_rn(ldexpf(v[c], k)));"
BEFORE_ATOMICS = """      if (touched != nullptr) {
        // the first add to a row finds it 0 (so may a later one: no harm)
        if (atomicAdd(p, q) == 0ull && c == 0) atomicOr(touched + (row >> 5), 1u << (row & 31));
      } else {
        atomicAdd(p, q);
      }"""
NO_HEADS = ("    const bool same = lane > 0 &&", "    const bool same = false && lane > 0 &&")

# name -> ({switch: 0/1}, [(text, replacement), ...])
ABLATIONS = {
    "before": ({}, []),
    "maxima": ({"ABL_SCATTER": 0, "ABL_SWEEP": 0}, []),
    "sweep": ({"ABL_MAXIMA": 0, "ABL_SCATTER": 0}, []),
    "nosweep": ({"ABL_SWEEP": 0}, []),
    "noatomics": ({}, [(LANE_ATOMIC, "    { const long long q = __float2ll_rn(ldexpf(v[c], k));\n"
                                     "      if (q == 0x7fffffffffffffffLL) "
                                     "atomicAdd(p + c, (unsigned long long)q); }"),
                       (BEFORE_ATOMICS, "      if (q == 0x7fffffffffffffffull) "
                                        "atomicAdd(p, q);")]),
    "nomerge": ({}, [("      if (__any_sync(0xffffffffu, row != kNoRow && __popc(peers) > 1)) {",
                      "      if (false) {"), NO_HEADS]),
    "halfslices": ({"ABL_HALF": 1}, []),
}
# this checkout's backward: the maxima pass, the slices' merge launches and
# the last pass, each behind a switch (the maxima are zeroed either way)
THIS_SWITCHES = [
    ("  int rc = launch_level_max(g_feat, g_dfeat, N, L, C, maxes, s);",
     "  int rc = ABL_MAXIMA ? launch_level_max(g_feat, g_dfeat, N, L, C, maxes, s) : 0;"),
    ("  rc = for_slices(L, C, CS, mw, [&](const Slice& sl) {",
     "  rc = !ABL_SCATTER ? 0 : for_slices(L, C, CS, mw, [&](const Slice& sl) {"),
    ("  if (touched != nullptr)\n    touched_sweep_kernel<CS, SEG>",
     "  if (!ABL_SWEEP) return (int)cudaMemsetAsync(maxes, 0, 2 * (size_t)L * sizeof(unsigned), "
     "s);\n  if (touched != nullptr)\n    touched_sweep_kernel<CS, SEG>"),
]
THIS_ATOMICS = """      if (touched != nullptr) {
        // the first add to a row finds it 0 (so may a later one: no harm)
        if (atomicAdd(p, q) == 0ull && c == 0 && c0 == 0)
          atomicOr(touched + (row >> 5), 1u << (row & 31));
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
    "this-nomerge": ({}, [NO_HEADS]),
    "this-halfslices": ({"ABL_HALF": 1}, []),
}
# sides whose accumulator is left dirty (one of their own)
DIRTY = ("nosweep", "this-nosweep")
SWITCH_NAMES = ("ABL_MAXIMA", "ABL_SCATTER", "ABL_SWEEP", "ABL_HALF")
PATCHED = ("hash_encoder.cu", "hash_encoder_segments_bwd.cu")


def patched(header: str, name: str) -> str:
    this = name.startswith("this")
    switches, edits = (THIS_ABLATIONS if this else ABLATIONS)[name]
    text = header
    for old, new in (THIS_SWITCHES if this else SWITCHES) + [HALF] + edits:
        # the lane-merge atomics and merge: only a tree that has them
        if not this and name in ("noatomics", "nomerge") and text.count(old) == 0:
            continue
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in the header once")
        text = text.replace(old, new)
    defs = "".join(f"#define {k} {switches.get(k, 0 if k == 'ABL_HALF' else 1)}\n"
                   for k in SWITCH_NAMES)
    return text.replace("#pragma once\n", "#pragma once\n" + defs, 1)


def family(side: str) -> str:
    return "this" if side.startswith("this") else "before"


def build_all(before: str, which: str) -> dict:
    """{name: CDLL} of every ablation of the before tree and of this
    checkout (``which``: all, before or this): one nvcc per source, all
    started together, then one link per side (each tree's forwards built
    once, unpatched)."""
    from nicer_slam_tpu_torch.ops import _cuda
    base = os.path.join(ROOT, "build", "hash_ablate")
    cc = [_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    jobs, objs, names = [], {}, []
    trees = []
    if which in ("all", "before"):
        trees.append((os.path.abspath(before), ABLATIONS, "before-tree"))
    if which in ("all", "this"):
        trees.append((ROOT, THIS_ABLATIONS, "this-tree"))
    for tree, table, tag in trees:
        src = os.path.join(tree, "nicer_slam_tpu_torch", "csrc")
        header = open(os.path.join(src, "hash_kernels.cuh")).read()
        fwd_dir = os.path.join(base, tag)
        os.makedirs(fwd_dir, exist_ok=True)
        fwd = os.path.join(fwd_dir, "hash_encoder_segments.o")
        jobs.append(subprocess.Popen(cc + ["-c", "-o", fwd,
                                           os.path.join(src, "hash_encoder_segments.cu")]))
        for name in table:
            d = os.path.join(base, name)
            os.makedirs(d, exist_ok=True)
            for f in PATCHED + ("hash_grid.cuh",):
                shutil.copy(os.path.join(src, f), d)
            with open(os.path.join(d, "hash_kernels.cuh"), "w") as fh:
                fh.write(patched(header, name))
            objs[name] = [fwd]
            for f in PATCHED:
                o = os.path.join(d, f + ".o")
                jobs.append(subprocess.Popen(cc + ["-c", "-o", o, os.path.join(d, f)]))
                objs[name].append(o)
            names.append(name)
    if any(j.wait() != 0 for j in jobs):
        raise RuntimeError("hash_bwd_ablate: a build failed")
    libs = {}
    for name in names:
        lib = os.path.join(base, name, "libhash.so")
        subprocess.run([*cc, "-shared", "-o", lib, *objs[name]], check=True)
        dll = ctypes.CDLL(lib)
        for entry in ("nsl_hash_encode_bwd", "nsl_hash_encode_bf16_bwd"):
            fn = getattr(dll, entry)
            fn.argtypes = _cuda._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = dll
    return libs


def cases(which):
    """(case name, spec, K1?, bf16 rows?, point kind) of the --cases sets"""
    specs = chip_smoke.hash_specs()
    out = []
    if "shipped" in which:
        for grid, jac, kind in chip_smoke.HASH_CASES:
            for order in ("ray", "uniform"):
                out.append((f"{'K1' if jac else 'K2'} {grid}/{kind}/{order}", specs[grid], jac,
                            False, (kind, order)))
    if "channels" in which:
        for L, C, jac in chip_smoke.HASH_CHANNEL_CASES:
            for order in ("ray", "uniform"):
                out.append((f"{'K1' if jac else 'K2'} L{L} C{C}/{order}",
                            chip_smoke.channel_spec(L, C), jac, False, ("track", order)))
    if "wide" in which:
        for L, C in chip_smoke.HASH_WIDE_CASES:
            for jac in (True, False):
                for order in ("ray", "uniform"):
                    out.append((f"{'K1' if jac else 'K2'} L{L} C{C}/{order}",
                                chip_smoke.wide_spec(L, C), jac, False, ("track", order)))
    if "bf16" in which:
        for L, C in ((16, 16), (8, 12)):
            out.append((f"K2 bf16 L{L} C{C}/ray", chip_smoke.wide_spec(L, C), False, True,
                        ("track", "ray")))
    return out


def points(g, dev, kind, order):
    if kind == "track":
        return (chip_smoke.ray_points(g, dev, chip_smoke.TRACK_RAYS, 98) if order == "ray"
                else chip_smoke.uniform_points(g, dev, chip_smoke.TRACK_RAYS * 98))
    return chip_smoke.hash_points(g, dev, kind, order)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", required=True,
                    help="a tree whose nicer_slam_tpu_torch/csrc holds the earlier backward")
    ap.add_argument("--sides", default="all", choices=("all", "before", "this"))
    ap.add_argument("--cases", default="channels,wide,bf16")
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
    libs = build_all(args.before, args.sides)
    sides = list(libs) + [f"{f}-nogx" for f in ("before", "this") if f in libs]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows_out, failures = [], []
    print(f"K1/K2 backward ablation on {card}", flush=True)
    for case, spec, jac, bf16, (kind, order) in cases(args.cases.split(",")):
        L, C, T = spec.num_levels, spec.level_dim, spec.total_entries
        meta, scl = he._level_tables(spec, 1.0, str(dev))
        table = torch.rand((T, C), generator=g, device=dev) * 2 - 1
        rows_t = he.pack_table_bf16(table) if bf16 else table
        # one zero scratch a family (each leaves it zero; the before tree
        # zeroes its maxima itself, this checkout needs them zero on entry),
        # one a dirty side
        words = he.fixed_point_words(spec)
        scratch = {f: torch.zeros(words, dtype=torch.int64, device=dev) for f in ("before", "this")}
        scratch.update({n: torch.zeros(words, dtype=torch.int64, device=dev)
                        for n in DIRTY if n in libs})
        x = points(g, dev, kind, order)
        N = x.shape[0]
        gf = torch.randn((N, L * C), generator=g, device=dev)
        gd = torch.randn((N, L * C, 3), generator=g, device=dev) if jac else None
        outs = {s: (torch.empty((T, C), device=dev), torch.empty((N, 3), device=dev))
                for s in sides}

        def launch(side):
            lib = libs[side.replace("-nogx", "")]
            gt, gx = outs[side]
            sc = scratch.get(side, scratch[family(side)])
            stream = torch.cuda.current_stream().cuda_stream
            gx_p = None if side.endswith("-nogx") else gx.data_ptr()

            def fn():
                if bf16:
                    rc = lib.nsl_hash_encode_bf16_bwd(
                        x.data_ptr(), rows_t.data_ptr(), meta.data_ptr(), scl.data_ptr(),
                        gf.data_ptr(), gt.data_ptr(), gx_p, sc.data_ptr(), N, L, C, 1.0, T,
                        stream)
                else:
                    rc = lib.nsl_hash_encode_bwd(
                        x.data_ptr(), rows_t.data_ptr(), meta.data_ptr(), scl.data_ptr(),
                        gf.data_ptr(), _cuda.ptr(gd), gt.data_ptr(), gx_p, sc.data_ptr(),
                        N, L, C, 1.0, T, stream)
                if rc != 0:
                    raise RuntimeError(f"{side}: CUDA error {rc}")
            return fn

        checked = [s for s in ("before", "this") if s in libs]
        for side in checked:
            launch(side)()
        torch.cuda.synchronize()
        plain = he.hash_table_grad_fixed_plain(spec, x, gf, gd)
        exact = {s: bool(torch.equal(outs[s][0], plain)) for s in checked}
        del plain
        rel = relx = 0.0
        if len(checked) == 2:
            rel = chip_smoke.rel_l2(outs["this"][0], outs["before"][0])
            relx = chip_smoke.rel_l2(outs["this"][1], outs["before"][1])
        times = {s: [] for s in sides}
        for r in range(args.rounds):
            for side in (sides if r % 2 == 0 else sides[::-1]):
                times[side].append(chip_smoke.cuda_time(launch(side)))
        zero = he.fixed_point_state_is_zero(scratch["this"]) if "this" in libs else None
        ok = (rel <= chip_smoke.GRAD_REL_L2 and relx <= chip_smoke.GRAD_REL_L2
              and exact.get("this", True) and zero is not False)
        if not ok:
            failures.append(case)
        ms = {s: sum(v) / len(v) for s, v in times.items()}
        rows = chip_smoke.touched_rows(spec, x)
        nb, ops = chip_smoke.hash_cost(spec, N, rows, jac, True)
        if bf16:
            nb -= rows * C * 2
        bound_ms = chip_smoke.bound(nb, ops)[0]
        print(f"{case} ({N} points; bound {bound_ms:.4f} ms): "
              + ", ".join(f"{s} {ms[s]:.4f}" for s in sides)
              + f" ms; this vs before: table rel L2 {rel:.2e}, grad_x {relx:.2e}; bit for bit "
              f"with the plain version {exact}; this checkout's state zero {zero}", flush=True)
        rows_out.append(dict(case=case, points=N, ms=ms, rounds=times, bound_ms=bound_ms,
                             table_rel_l2=rel, grad_x_rel_l2=relx, bit_equal_plain=exact,
                             zero_after=zero, ok=ok))
        del x, gf, gd, outs, table, rows_t, scratch
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
