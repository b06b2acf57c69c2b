#!/usr/bin/env python3
"""The hand-written K1/K2, K3 and K5 kernels of an earlier checkout against
this checkout's, on one CUDA card, in one process.

  git archive <commit> | tar -x -C build/other
  python3 tools/hash_kernel_ab.py --other build/other [--out build/hash_kernel_ab.json]

The earlier checkout's csrc/hash_encoder.cu and csrc/sampler.cu are built
with nvcc into build/parent/ beside this checkout's library
(build/kernels/); both must have this checkout's C interface for the
entry points timed here ([T, C] tables, grad_x as [N, 3]). Both libraries
run on the same operands, at chip_smoke.py's shapes:

  * K1/K2 forward and backward: chip_smoke.HASH_CASES, ray-ordered and
    uniform points;
  * K3 on both SDF grids: chip_smoke.BF16_ORDERS (a density-cache build
    chunk, a render chunk's ray-ordered prepass, uniform points);
  * K5 at chip_smoke.SAMPLER_RAYS rays and K5 given densities at
    chip_smoke.GIVEN_RAYS.

Each case first holds the two kernels' outputs against each other (values
within 1e-5 of the largest, gradients within 1e-5 relative L2); the
samplers are compared by chip_smoke.sampler_agreement, each against the
other and against this checkout's plain version, and only this checkout's
kernel must agree with it (an earlier kernel may sum in another order, and
the inverse CDF is discontinuous). Then each launch is timed alone in turns:
earlier, this, this, earlier (10 launches each, CUDA events, a gradient
table zeroed outside the timed window).
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

ENTRIES = ("nsl_hash_encode_fwd", "nsl_hash_encode_bwd", "nsl_hash_encode_bf16_fwd",
           "nsl_importance_sample", "nsl_importance_sample_given")


def build_other(other: str) -> ctypes.CDLL:
    from nicer_slam_tpu_torch.ops import _cuda
    out_dir = os.path.join(ROOT, "build", "parent")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libparent_kernels.so")
    src = os.path.join(os.path.abspath(other), "nicer_slam_tpu_torch", "csrc")
    cmd = [_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
           "-fPIC", "-shared", "-o", lib, os.path.join(src, "hash_encoder.cu"),
           os.path.join(src, "sampler.cu")]
    subprocess.run(cmd, check=True)
    dll = ctypes.CDLL(lib)
    for name in ENTRIES:
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = _cuda._SIGNATURES[name], ctypes.c_int
    return dll


def caller(lib):
    """entry(name, *args): the entry point on the current stream; raises
    on a CUDA error."""
    import torch

    def call(name, *args):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    return call


def turns(fns, before=None) -> dict:
    """{side: [ms, ms]} of each launch timed alone, in turns earlier, this,
    this, earlier."""
    t = {"earlier": [], "this": []}
    for side in ("earlier", "this", "this", "earlier"):
        t[side].append(chip_smoke.cuda_time(fns[side], before=before))
    return t


def mean(v):
    return sum(v) / len(v)


def hash_cases(dev, calls, rows_out):
    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    specs = chip_smoke.hash_specs()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for grid, jac, kind in chip_smoke.HASH_CASES:
        spec = specs[grid]
        L, C, T = spec.num_levels, spec.level_dim, spec.total_entries
        table = torch.rand((T, C), generator=g, device=dev) * 2 - 1
        meta, scl = he._level_tables(spec, 1.0, str(dev))
        for order in ("ray", "uniform"):
            x = chip_smoke.hash_points(g, dev, kind, order)
            N = x.shape[0]
            rows = chip_smoke.touched_rows(spec, x)
            gf = torch.randn((N, L * C), generator=g, device=dev)
            gd = torch.randn((N, L * C, 3), generator=g, device=dev) if jac else None
            out = {s: dict(feats=torch.empty((N, L * C), device=dev),
                           dfeat=torch.empty((N, L * C, 3), device=dev) if jac else None,
                           g_table=torch.zeros_like(table),
                           g_x=torch.empty((N, 3), device=dev)) for s in calls}

            def fwd(side):
                o = out[side]
                return lambda: calls[side](
                    "nsl_hash_encode_fwd", x.data_ptr(), table.data_ptr(), meta.data_ptr(),
                    scl.data_ptr(), o["feats"].data_ptr(), _cuda.ptr(o["dfeat"]),
                    N, L, C, 1.0)

            def bwd(side):
                o = out[side]
                return lambda: calls[side](
                    "nsl_hash_encode_bwd", x.data_ptr(), table.data_ptr(), meta.data_ptr(),
                    scl.data_ptr(), gf.data_ptr(), _cuda.ptr(gd),
                    o["g_table"].data_ptr(), o["g_x"].data_ptr(), N, L, C, 1.0)

            for side in calls:
                fwd(side)(), bwd(side)()
            torch.cuda.synchronize()
            a, b = out["this"], out["earlier"]
            errs = [chip_smoke.max_abs(a["feats"], b["feats"]) / float(b["feats"].abs().max())]
            if jac:
                errs.append(chip_smoke.max_abs(a["dfeat"], b["dfeat"])
                            / float(b["dfeat"].abs().max()))
            rel = [chip_smoke.rel_l2(a["g_table"], b["g_table"]),
                   chip_smoke.rel_l2(a["g_x"], b["g_x"])]
            ok = max(errs) <= chip_smoke.VAL_RTOL and max(rel) <= chip_smoke.GRAD_REL_L2
            zero = lambda: [o["g_table"].zero_() for o in out.values()]  # noqa: E731
            tf = turns({s: fwd(s) for s in calls})
            tb = turns({s: bwd(s) for s in calls}, before=zero)
            b_fwd = chip_smoke.bound(*chip_smoke.hash_cost(spec, N, rows, jac, False))[0]
            b_bwd = chip_smoke.bound(*chip_smoke.hash_cost(spec, N, rows, jac, True))[0]
            for kdir, t, bnd in (("fwd", tf, b_fwd), ("bwd", tb, b_bwd)):
                rows_out.append(dict(
                    case=f"{'K1' if jac else 'K2'} {kdir} {grid}/{kind}/{order}", points=N,
                    ok=ok, agreement=dict(value_err=max(errs), grad_rel_l2=max(rel)),
                    times_ms=t, bound_ms=bnd))
            del x, gf, gd, out
            torch.cuda.empty_cache()
        del table
        torch.cuda.empty_cache()


def bf16_cases(dev, calls, rows_out):
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    specs = chip_smoke.hash_specs()
    for grid in chip_smoke.SDF_GRIDS:
        spec = specs[grid]
        L, C = spec.num_levels, spec.level_dim
        table = torch.rand((spec.total_entries, C), generator=g, device=dev) * 2 - 1
        packed = he.pack_table_bf16(table)
        meta, scl = he._level_tables(spec, 1.0, str(dev))
        for order in chip_smoke.BF16_ORDERS:
            x = chip_smoke.bf16_points(g, dev, order)
            N = x.shape[0]
            feats = {s: torch.empty((N, L * C), device=dev) for s in calls}

            def fwd(side):
                return lambda: calls[side](
                    "nsl_hash_encode_bf16_fwd", x.data_ptr(), packed.data_ptr(),
                    meta.data_ptr(), scl.data_ptr(), feats[side].data_ptr(), N, L, C, 1.0)

            for side in calls:
                fwd(side)()
            torch.cuda.synchronize()
            err = (chip_smoke.max_abs(feats["this"], feats["earlier"])
                   / float(feats["earlier"].abs().max()))
            rows_out.append(dict(
                case=f"K3 {grid}/{order}", points=N, ok=err <= chip_smoke.VAL_RTOL,
                agreement=dict(value_err=err,
                               bit_equal=bool(torch.equal(feats["this"], feats["earlier"]))),
                times_ms=turns({s: fwd(s) for s in calls}),
                bound_ms=chip_smoke.bound(
                    chip_smoke.nbytes(x, feats["this"])
                    + chip_smoke.touched_rows(spec, x) * C * 2, 2 * C * 8 * L * N)[0]))
            del x, feats
        del table, packed
        torch.cuda.empty_cache()


def sampler_cases(dev, calls, rows_out):
    import torch
    from nicer_slam_tpu_torch.ops import ray_sampling as rs

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cache = chip_smoke.shell_cache(dev)
    cases = [("cached", R) for R in chip_smoke.SAMPLER_RAYS] + [("given", chip_smoke.GIVEN_RAYS)]
    for mode, R in cases:
        if mode == "cached":
            scfg, o, d, t_rand, perm, eik = chip_smoke.sampler_inputs(g, dev, R)
            z_pre = rs.uniform_z_vals(scfg, o, d, t_rand)[0]
            pz, pe = rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm, eik)
            vox = chip_smoke.touched_voxels(
                scfg.prepass_cache_res,
                (o[:, None, :] + z_pre[..., None] * d[:, None, :]).reshape(-1, 3))
            io = chip_smoke.nbytes(o, d, t_rand, perm, eik, pz, pe) + 4 * vox
        else:
            scfg, z_pre, dens, perm, eik = chip_smoke.given_inputs(g, dev, R)
            pz, pe = rs.importance_sample_given_plain(scfg, z_pre, dens, perm, eik)
            io = chip_smoke.nbytes(z_pre, dens, perm, eik, pz, pe)
        Ne, Ns, Nx = scfg.N_samples_eval, scfg.N_samples, scfg.N_samples_extra
        outs = {s: (torch.empty_like(pz), torch.empty_like(pe)) for s in calls}

        def run(side):
            z_out, z_eik = outs[side]
            if mode == "cached":
                return lambda: calls[side](
                    "nsl_importance_sample", o.data_ptr(), d.data_ptr(), cache.data_ptr(),
                    t_rand.data_ptr(), perm.data_ptr(), eik.data_ptr(), z_out.data_ptr(),
                    z_eik.data_ptr(), R, scfg.prepass_cache_res, Ne, Ns, Nx,
                    float(scfg.scene_bounding_sphere), float(scfg.near),
                    float(scfg.uniform_far), rs._step(Ne), rs._step(Ns))
            return lambda: calls[side](
                "nsl_importance_sample_given", z_pre.data_ptr(), dens.data_ptr(),
                perm.data_ptr(), eik.data_ptr(), z_out.data_ptr(), z_eik.data_ptr(), R, Ne,
                Ns, Nx, rs._step(Ns))

        for side in calls:
            run(side)()
        torch.cuda.synchronize()
        agree = {"this_vs_earlier": chip_smoke.sampler_agreement(
            *outs["this"], *outs["earlier"], z_pre)}
        for side in calls:
            agree[f"{side}_vs_plain"] = chip_smoke.sampler_agreement(*outs[side], pz, pe, z_pre)
        ops = R * Ne * (40 if mode == "cached" else 20) + R * pz.shape[1] * 40
        # the earlier kernel may sum in another order than this checkout's
        # plain version, so only this kernel is held to it
        rows_out.append(dict(
            case=f"K5 {mode} {R} rays", points=R * Ne,
            ok=agree["this_vs_plain"]["ok"], agreement=agree,
            times_ms=turns({s: run(s) for s in calls}),
            bound_ms=chip_smoke.bound(io, ops)[0]))
        del outs, pz, pe, z_pre


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the earlier checkout")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "hash_kernel_ab.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("hash_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from nicer_slam_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    calls = {"earlier": caller(build_other(args.other)), "this": caller(_cuda.library())}
    rows_out = []
    for cases in (bf16_cases, sampler_cases, hash_cases):
        done = len(rows_out)
        cases(dev, calls, rows_out)
        for row in rows_out[done:]:
            ms = {s: mean(v) for s, v in row["times_ms"].items()}
            b = row["bound_ms"]
            print(f"{row['case']:36s} earlier {ms['earlier']:.4f} this {ms['this']:.4f} ms "
                  f"(x{ms['earlier'] / ms['this']:.2f}; bound {b:.4f}, share "
                  f"{b / ms['earlier']:.1%} -> {b / ms['this']:.1%}) agree {row['ok']} "
                  f"{json.dumps(row['agreement'])}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "cases": rows_out}, f, indent=1)
    print(card)
    failures = [r["case"] for r in rows_out if not r["ok"]]
    if failures:
        print(f"hash_kernel_ab: disagreement on {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
