#!/usr/bin/env python3
"""Where K9 (``csrc/tsdf.cu``) spends its time: the first design (a thread a
voxel, every voxel projected) from another tree, copies of it that each
leave one part out, and this checkout's kernel, timed in turns on one CUDA
card.

  git archive <commit> nicer_slam_tpu_torch | tar -x -C build/before
  python3 tools/torch_tsdf_ablate.py --before build/before [--out FILE]

The sides, each built with nvcc into ``build/tsdf_ablate/<name>/`` from a
copy of the first design's ``csrc/tsdf.cu`` (the same C interface,
``nsl_tsdf_integrate``):

  * ``before``: the first design as it is;
  * ``nodiv``: its three IEEE divisions (u, v and the tsdf's sdf / trunc)
    taken as products;
  * ``nogather``: the depth frame's read a constant 1;
  * ``noproj``: no voxel in the frame (u, v, their roundings and the
    gather left out; c, the sdf's division and the weighted mean stay);
  * ``floor``: the weight read and, where a weight is held, the tsdf read
    and rewritten as (tsdf w) / w: the bytes the function must move and no
    more work;
  * ``this``: this checkout's kernel; and copies of it: ``this-floor``
    (every stretch taken as behind the camera: the weight read and the
    held voxels' rewrite in this design's layout), ``this-nocull`` (every
    stretch taken as one the frame may see), ``this-1chunk`` /
    ``this-4chunks`` (1 or 4 stretches a warp, not 2), ``this-nocap`` (no
    register cap: the compiler's count, fewer blocks an SM), ``this-cap12``
    (registers capped for twelve blocks of 128 threads, not ten: spills) and
    ``this-8warps`` (five blocks of 256 threads).

Operands: ``chip_smoke.check_tsdf_kernel``'s, a 680 x 1200 frame into a 256³
volume that already holds one frame; every side starts from the same
volume. ``before`` and ``this`` must equal the plain version bit for bit;
the others are wrong by design and only timed. Each launch is timed alone
(CUDA events behind chip_smoke's device sleep, mean of 10 after 2), the
sides forth and back over ``--rounds`` rounds; the card's name and power
limit are printed with the table and written to the JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# name -> [(text in the first design's csrc/tsdf.cu, its replacement), ...]
# (each text found once)
ABLATIONS = {
    "before": [],
    "nodiv": [("__fdiv_rn(__fmul_rn(__ldg(K), c[0]), c[2])",
               "__fmul_rn(__fmul_rn(__ldg(K), c[0]), c[2])"),
              ("__fdiv_rn(__fmul_rn(__ldg(K + 4), c[1]), c[2])",
               "__fmul_rn(__fmul_rn(__ldg(K + 4), c[1]), c[2])"),
              ("__fdiv_rn(sdf, trunc)", "__fmul_rn(sdf, trunc)")],
    "nogather": [("__ldg(depth + (int64_t)vi * W + (int64_t)ui)", "1.f")],
    "noproj": [("const bool inb = c[2] > 0.f && ui >= 0.f && ui < (float)W && vi >= 0.f && "
                "vi < (float)H;", "const bool inb = false;")],
    "floor": [("  const int64_t n = (int64_t)row * res + k;\n",
               "  const int64_t n = (int64_t)row * res + k;\n"
               "  if (res > 0) {\n"
               "    const float w = weight[n];\n"
               "    if (w > 0.f) tsdf[n] = __fdiv_rn(__fmul_rn(tsdf[n], w), w);\n"
               "    return;\n"
               "  }\n")],
}


# copies of this checkout's csrc/tsdf.cu
THIS_VIEW = "    view[c] = !(trunc > 0.f) ? 2 : (bc & 1u) ? 1 : (bc & 30u) ? 0 : 2;\n"
THIS_CHUNKS = "constexpr int kChunks = 2;"
THIS_BOUNDS = "__global__ void __launch_bounds__(32 * kWarps, 10)\n    tsdf_integrate_kernel("
THIS_WARPS = "constexpr int kWarps = 4;"


def _bounds(cap: str) -> tuple:
    return (THIS_BOUNDS, f"__global__ void __launch_bounds__(32 * kWarps{cap})\n"
                         "    tsdf_integrate_kernel(")


THIS_ABLATIONS = {
    "this-floor": [(THIS_VIEW, "    view[c] = 1;\n")],
    "this-nocull": [(THIS_VIEW, "    view[c] = 2;\n")],
    "this-1chunk": [(THIS_CHUNKS, "constexpr int kChunks = 1;")],
    "this-4chunks": [(THIS_CHUNKS, "constexpr int kChunks = 4;")],
    "this-nocap": [_bounds("")],
    "this-cap12": [_bounds(", 12")],
    "this-8warps": [(THIS_WARPS, "constexpr int kWarps = 8;"), _bounds(", 5")],
}


def build(name: str, src_text: str) -> ctypes.CDLL:
    from nicer_slam_tpu_torch.ops import _cuda
    d = os.path.join(ROOT, "build", "tsdf_ablate", name)
    os.makedirs(d, exist_ok=True)
    src, lib = os.path.join(d, "tsdf.cu"), os.path.join(d, "libtsdf.so")
    with open(src, "w") as f:
        f.write(src_text)
    subprocess.run([_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                    "-fPIC", "-shared", "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    dll.nsl_tsdf_integrate.argtypes = _cuda._SIGNATURES["nsl_tsdf_integrate"]
    dll.nsl_tsdf_integrate.restype = ctypes.c_int
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", required=True,
                    help="a tree whose nicer_slam_tpu_torch/csrc/tsdf.cu is the first design")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "tsdf_ablate.json"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.ops import tsdf as tsdf_ops
    if not torch.cuda.is_available():
        print("torch_tsdf_ablate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    first = open(os.path.join(args.before, "nicer_slam_tpu_torch", "csrc", "tsdf.cu")).read()
    libs = {}
    for name, edits in ABLATIONS.items():
        text = first
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the first design once")
            text = text.replace(old, new)
        libs[name] = build(name, text)
    libs["this"] = _cuda.library()
    this_src = open(os.path.join(ROOT, "nicer_slam_tpu_torch", "csrc", "tsdf.cu")).read()
    for name, edits in THIS_ABLATIONS.items():
        text = this_src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in this checkout's kernel once")
            text = text.replace(old, new)
        libs[name] = build(name, text)

    # chip_smoke.check_tsdf_kernel's operands: a volume holding one frame,
    # then the frame every side folds in
    p, res = chip_smoke.PATHS["preprocess"], chip_smoke.TSDF_RES
    coords = tsdf_ops.axis_coords(res, [-3.2] * 3, [3.2] * 3, dev)
    trunc = float(torch.tensor(4.0 * 6.4 / res, dtype=torch.float32))
    tsdf0 = torch.ones(res ** 3, device=dev)
    weight0 = torch.zeros(res ** 3, device=dev)
    tsdf_ops.integrate_plain(tsdf0, weight0, *chip_smoke.tsdf_frame(dev, p["H"], p["W"], 0.0),
                             coords, trunc, 5.0)
    depth, w2c, K = chip_smoke.tsdf_frame(dev, p["H"], p["W"], 0.3)
    pt, pw = tsdf0.clone(), weight0.clone()
    tsdf_ops.integrate_plain(pt, pw, depth, w2c, K, coords, trunc, 5.0)
    observed, held = int((pw != weight0).sum()), int((pw > 0).sum())
    small = chip_smoke.nbytes(depth, w2c, K, *coords)
    bytes_ = 4 * res ** 3 + 8 * held + 4 * observed + small
    bound_ms = chip_smoke.bound(bytes_, 32 * res ** 3)[0]

    state = {}

    def launch(name):
        t, w = state[name]
        stream = torch.cuda.current_stream().cuda_stream
        rc = libs[name].nsl_tsdf_integrate(
            t.data_ptr(), w.data_ptr(), depth.data_ptr(), w2c.data_ptr(), K.data_ptr(),
            *(c.data_ptr() for c in coords), res, p["H"], p["W"], trunc, 5.0, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    exact = {}
    for name in libs:
        state[name] = (tsdf0.clone(), weight0.clone())
        launch(name)
        torch.cuda.synchronize()
        t, w = state[name]
        exact[name] = bool(torch.equal(t, pt) and torch.equal(w, pw))
    if not (exact["before"] and exact["this"]):
        raise RuntimeError(f"before / this differ from the plain version: {exact}")

    names = list(libs)
    times = {n: [] for n in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(chip_smoke.cuda_time(lambda: launch(name)))
    ms = {n: sum(v) / len(v) for n, v in times.items()}
    print(f"K9 ablation on {card}: 256^3 volume, 680x1200 frame, {observed} voxels "
          f"observed, {held} with a weight; bound {bound_ms:.4f} ms ({bytes_ / 1e6:.1f} MB)")
    for name in names:
        print(f"  {name:9s} {ms[name]:.4f} ms  share of bound {bound_ms / ms[name]:.1%}  "
              f"(rounds {' '.join(f'{v:.4f}' for v in times[name])}; equal to the plain "
              f"version: {exact[name]})")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "bound_ms": bound_ms, "bytes": bytes_, "observed": observed,
                   "held": held, "ms": ms, "rounds": times, "exact": exact}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
