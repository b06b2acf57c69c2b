#!/usr/bin/env python3
"""K6 (``csrc/sdf_density.cu``) of other source trees against this
checkout's, on one CUDA card, in one process.

  python3 tools/sdf_density_ab.py --other DIR [--other DIR ...] [--out FILE]

Each DIR holds a ``nicer_slam_tpu_torch/csrc/`` with an ``sdf_density.cu``
whose entry point ``nsl_sdf_density`` has this checkout's C interface (a
checkout of another commit, or a variant of this kernel); each is built
with nvcc into ``build/sdf_ab/<n>/`` beside this checkout's library. All
run on chip_smoke.py's operands (the flagship configuration's SDF networks
and a voxel counter, ``chip_smoke.sdf_net``): the 128³ density cache and
the exact prepass of a 2580-ray render chunk (640 z a ray). Each side's
output is held against the plain version within
``chip_smoke.SDF_DENSITY_RTOL`` of its largest value, then each launch is
timed alone in turns, forth and back over the sides (10 launches each,
CUDA events, behind chip_smoke's device sleep).
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


def build_side(src_root: str, n: int) -> ctypes.CDLL:
    from nicer_slam_tpu_torch.ops import _cuda
    out_dir = os.path.join(ROOT, "build", "sdf_ab", str(n))
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libsdf_density.so")
    src = os.path.join(os.path.abspath(src_root), "nicer_slam_tpu_torch", "csrc",
                       "sdf_density.cu")
    subprocess.run([_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                    "-fPIC", "-shared", "-Xptxas", "-v", "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    dll.nsl_sdf_density.argtypes = _cuda._SIGNATURES["nsl_sdf_density"]
    dll.nsl_sdf_density.restype = ctypes.c_int
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", required=True,
                    help="root of a tree with nicer_slam_tpu_torch/csrc/sdf_density.cu")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sdf_density_ab.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sdf_density_ab: no CUDA device", file=sys.stderr)
        return 2
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.ops import density as dens_ops
    from nicer_slam_tpu_torch.ops import hash_encoder as he
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    from nicer_slam_tpu_torch.ops import sdf_density as sd

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    libs = {"this": _cuda.library()}
    for n, other in enumerate(args.other):
        libs[other] = build_side(other, n)
    net, vox = chip_smoke.sdf_net(dev)
    pack = sd.pack_sdf(net)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32)
    o, d = chip_smoke._sampler_rays(g, dev, chip_smoke.GIVEN_RAYS)
    z, _, _ = rs.uniform_z_vals(scfg, o, d, None)
    res = chip_smoke.SDF_RES
    cases = {
        f"grid {res}^3": dict(
            n=res ** 3, plain=sd.density_grid_plain(net, pack.tables, res, vox),
            bound=chip_smoke.bound(*chip_smoke.density_cache_cost(res))[0],
            mode=dict(xs=torch.linspace(-1.0, 1.0, res, device=dev), res=res)),
        f"rays {chip_smoke.GIVEN_RAYS}x640": dict(
            n=z.numel(), plain=sd.density_rays_plain(net, pack.tables, o, d, z, vox),
            bound=chip_smoke.bound(*chip_smoke.sdf_density_cost(
                z.numel(), chip_smoke.nbytes(o, d, z, z)))[0],
            mode=dict(o=o, d=d, z=z, S=z.shape[1])),
    }
    tabs = [(pack.tables[k], *he._level_tables(getattr(net, k).spec, 1.0, str(dev)))
            for k in ("coarse", "fine")]
    (tc, mc, sc), (tf, mf, sf) = tabs
    rows = []
    for name, c in cases.items():
        m = c["mode"]
        outs = {side: torch.empty(c["n"], device=dev) for side in libs}

        def run(side, m=m, c=c):
            def fn():
                rc = libs[side].nsl_sdf_density(
                    pack.weights.data_ptr(), tc.data_ptr(), mc.data_ptr(), sc.data_ptr(),
                    tf.data_ptr(), mf.data_ptr(), sf.data_ptr(), _cuda.ptr(m.get("xs")),
                    m.get("res", 0), _cuda.ptr(m.get("o")), _cuda.ptr(m.get("d")),
                    _cuda.ptr(m.get("z")), m.get("S", 0), vox.data_ptr(), 64,
                    dens_ops.NEG_B_1E4, dens_ops.BETA_D, dens_ops.BETA_A,
                    dens_ops.BETA_C, None, None, outs[side].data_ptr(), c["n"],
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{side}: CUDA error {rc}")
            return fn

        for side in libs:
            run(side)()
        torch.cuda.synchronize()
        plain = c["plain"].reshape(-1)
        scale = float(plain.abs().max())
        err = {side: float((outs[side] - plain).abs().max()) / scale for side in libs}
        times = {side: [] for side in libs}
        order = list(libs)
        for side in order + order[::-1]:
            times[side].append(chip_smoke.cuda_time(run(side)))
        ms = {side: sum(v) / len(v) for side, v in times.items()}
        ok = all(e <= chip_smoke.SDF_DENSITY_RTOL for e in err.values())
        rows.append(dict(case=name, points=c["n"], ok=ok, rel_err_vs_plain=err,
                         times_ms=times, bound_ms=c["bound"]))
        print(f"{name:18s} " + " ".join(f"{side}: {ms[side]:.4f} ms (share "
                                         f"{c['bound'] / ms[side]:.1%}, err {err[side]:.2e})"
                                         for side in libs) + f" agree {ok}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "cases": rows}, f, indent=1)
    print(card)
    if not all(r["ok"] for r in rows):
        print("sdf_density_ab: a side disagrees with the plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
