#!/usr/bin/env python3
"""The hand-written K1/K2, K3, K4, K5 and K7 kernels of an earlier checkout
against this checkout's, on one CUDA card, in one process.

  git archive <commit> | tar -x -C build/other
  python3 tools/hash_kernel_ab.py --other build/other [--out build/hash_kernel_ab.json]

The earlier checkout's csrc/hash_encoder.cu, csrc/sampler.cu,
csrc/composite.cu and csrc/voxels.cu are built with nvcc into build/parent/
beside this checkout's library (build/kernels/); every entry point must
have this checkout's C interface (the hash backward writing its table
gradient through an int64 scratch of at least T C + max(L, 32) words, the weights pass writing its
top-k values and picks, K5's given mode taking near, far and per-chunk
extras). Both
libraries run on the same operands, at chip_smoke.py's shapes:

  * K1/K2 at the tracking shape (chip_smoke.TRACK_GRIDS): the forward and
    the grad_x-only backward; K2's backward on bf16 rows at
    chip_smoke.BF16_BWD_CASES;
  * K1/K2 forward and backward: chip_smoke.HASH_CASES, ray-ordered and
    uniform points. This checkout's backward gets the accumulator and
    bitmap that its wrapper keeps (zero on entry, and checked zero after
    every launch), the earlier one a scratch of its own;
  * K3 on both SDF grids: chip_smoke.BF16_ORDERS (a density-cache build
    chunk, a render chunk's ray-ordered prepass, uniform points);
  * K5 at chip_smoke.SAMPLER_RAYS rays and K5 given densities at
    chip_smoke.GIVEN_RAYS;
  * K4 with colour top-16 at chip_smoke.TOPK_RAYS rays x 98 samples: the
    weights pass forward (with torch.topk of the weights as the library's
    pick alone in the same turns; also on chip_smoke's surface-like
    densities at 8192 rays), its backward, the top-k colour composite
    forward and backward; the plain composite's backward with colour at
    the demo's 4096 x 98, and its forward at chip_smoke.COMPOSITE_SHAPES
    (the demo's mapping rays, a render chunk, 64 x 200);
  * K7 at chip_smoke.VOXEL_CASES: the scatter (the 1 MB counter copied,
    as update_voxels does, then the launch) and the beta read.

Each case first holds the two kernels' outputs against each other (values
within 1e-5 of the largest, gradients within 1e-5 relative L2; the K7
counters must be equal bit for bit; this checkout's K1/K2 table gradient
must equal its plain version, hash_table_grad_fixed_plain, bit for bit,
and whether it equals the earlier kernel's bit for bit is reported: a
kernel that merges in another order rounds elsewhere); the
samplers are compared by chip_smoke.sampler_agreement, each against the
other and against this checkout's plain version, and only this checkout's
kernel must agree with it (an earlier kernel may sum in another order, and
the inverse CDF is discontinuous). The top-k picks of the two checkouts
are counted by the rays where they differ, and each must equal this
checkout's plain version's through the plain weights. Then each launch is
timed alone in turns: earlier, this, this, earlier (more sides: forth and
back; 10 launches each, CUDA events).
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
           "nsl_hash_encode_bf16_bwd",
           "nsl_importance_sample", "nsl_importance_sample_given", "nsl_weights_topk_fwd",
           "nsl_composite_fwd", "nsl_composite_bwd", "nsl_topk_rgb_fwd", "nsl_topk_rgb_bwd", "nsl_voxel_scatter",
           "nsl_voxel_beta")
# (hash_encoder_channels.cu, which older trees hold for the K1/K2 channel
# counts below 8 other than 2, 4, 8, and hash_encoder_segments*.cu, the
# segmented kernels, where the tree has them)
SOURCES = ("hash_encoder.cu", "hash_encoder_channels.cu", "hash_encoder_segments.cu",
           "hash_encoder_segments_bwd.cu", "sampler.cu", "composite.cu", "voxels.cu")


def build_other(other: str) -> ctypes.CDLL:
    from nicer_slam_tpu_torch.ops import _cuda
    out_dir = os.path.join(ROOT, "build", "parent")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libparent_kernels.so")
    src = os.path.join(os.path.abspath(other), "nicer_slam_tpu_torch", "csrc")
    cmd = [_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
           "-fPIC", "-shared", "-o", lib,
           *(os.path.join(src, f) for f in SOURCES if os.path.exists(os.path.join(src, f)))]
    subprocess.run(cmd, check=True)
    dll = ctypes.CDLL(lib)
    for name in ENTRIES:
        fn = getattr(dll, name)
        fn.argtypes = _cuda._SIGNATURES[name]
        fn.restype = ctypes.c_int
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


def turns(fns) -> dict:
    """{side: [ms, ms]} of each launch timed alone, in turns forth and back
    over the sides (earlier, this, this, earlier)."""
    sides = list(fns)
    t = {side: [] for side in sides}
    for side in sides + sides[::-1]:
        t[side].append(chip_smoke.cuda_time(fns[side]))
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
        # this side: the accumulator its wrapper keeps; the earlier side a
        # zeroed one of its own (since 84c8c39 the entry point needs its
        # scratch zero on entry and leaves it zero; an earlier one zeroes
        # it itself)
        scratch = {"this": he.fixed_point_scratch(spec, dev),
                   "earlier": torch.zeros(T * C + max(L, 32), dtype=torch.int64,
                                           device=dev)}
        for order in ("ray", "uniform"):
            x = chip_smoke.hash_points(g, dev, kind, order)
            N = x.shape[0]
            rows = chip_smoke.touched_rows(spec, x)
            gf = torch.randn((N, L * C), generator=g, device=dev)
            gd = torch.randn((N, L * C, 3), generator=g, device=dev) if jac else None
            out = {s: dict(feats=torch.empty((N, L * C), device=dev),
                           dfeat=torch.empty((N, L * C, 3), device=dev) if jac else None,
                           g_table=torch.empty_like(table),
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
                    scl.data_ptr(), gf.data_ptr(), _cuda.ptr(gd), o["g_table"].data_ptr(),
                    o["g_x"].data_ptr(), scratch[side].data_ptr(), N, L, C, 1.0, T)

            for side in calls:
                fwd(side)(), bwd(side)()
            torch.cuda.synchronize()
            zero_after = [he.fixed_point_state_is_zero(spec, scratch["this"])]
            a, b = out["this"], out["earlier"]
            errs = [chip_smoke.max_abs(a["feats"], b["feats"]) / float(b["feats"].abs().max())]
            if jac:
                errs.append(chip_smoke.max_abs(a["dfeat"], b["dfeat"])
                            / float(b["dfeat"].abs().max()))
            rel = [chip_smoke.rel_l2(a["g_table"], b["g_table"]),
                   chip_smoke.rel_l2(a["g_x"], b["g_x"])]
            exact = bool(torch.equal(a["g_table"], he.hash_table_grad_fixed_plain(
                spec, x, gf, gd)))
            same = bool(torch.equal(a["g_table"], b["g_table"]))
            tf = turns({s: fwd(s) for s in calls})
            tb = turns({s: bwd(s) for s in calls})
            zero_after.append(he.fixed_point_state_is_zero(spec, scratch["this"]))
            same &= bool(torch.equal(a["g_table"], b["g_table"]))
            ok = (max(errs) <= chip_smoke.VAL_RTOL and max(rel) <= chip_smoke.GRAD_REL_L2
                  and exact and all(zero_after))
            b_fwd = chip_smoke.bound(*chip_smoke.hash_cost(spec, N, rows, jac, False))[0]
            b_bwd = chip_smoke.bound(*chip_smoke.hash_cost(spec, N, rows, jac, True))[0]
            for kdir, t, bnd in (("fwd", tf, b_fwd), ("bwd", tb, b_bwd)):
                rows_out.append(dict(
                    case=f"{'K1' if jac else 'K2'} {kdir} {grid}/{kind}/{order}", points=N,
                    ok=ok, agreement=dict(value_err=max(errs), grad_rel_l2=max(rel),
                                          table_grad_bit_equal_plain=exact,
                                          table_grad_bit_equal_earlier=same,
                                          accumulator_zero_after=zero_after),
                    times_ms=t, bound_ms=bnd,
                    **({"floor_ms": chip_smoke.hash_floor_ms(spec, N, rows, jac)}
                       if kdir == "bwd" else {})))
            del x, gf, gd, out
            torch.cuda.empty_cache()
        del table, scratch
        torch.cuda.empty_cache()


def tracking_cases(dev, calls, rows_out):
    """K1/K2 at the tracking shape (chip_smoke.TRACK_GRIDS, 1024 x 98
    ray-ordered points): the forward, and the backward as tracking runs it
    (grad_x only, no table gradient)."""
    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    specs = chip_smoke.hash_specs()
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    for grid, jac in chip_smoke.TRACK_GRIDS:
        spec = specs[grid]
        L, C, T = spec.num_levels, spec.level_dim, spec.total_entries
        table = torch.rand((T, C), generator=g, device=dev) * 2 - 1
        meta, scl = he._level_tables(spec, 1.0, str(dev))
        x = chip_smoke.ray_points(g, dev, chip_smoke.TRACK_RAYS, 98)
        N, rows = x.shape[0], chip_smoke.touched_rows(spec, x)
        gf = torch.randn((N, L * C), generator=g, device=dev)
        gd = torch.randn((N, L * C, 3), generator=g, device=dev) if jac else None
        out = {s: dict(feats=torch.empty((N, L * C), device=dev),
                       dfeat=torch.empty((N, L * C, 3), device=dev) if jac else None,
                       g_x=torch.empty((N, 3), device=dev)) for s in calls}

        def fwd(side):
            o = out[side]
            return lambda: calls[side](
                "nsl_hash_encode_fwd", x.data_ptr(), table.data_ptr(), meta.data_ptr(),
                scl.data_ptr(), o["feats"].data_ptr(), _cuda.ptr(o["dfeat"]), N, L, C, 1.0)

        def bwd(side):
            return lambda: calls[side](
                "nsl_hash_encode_bwd", x.data_ptr(), table.data_ptr(), meta.data_ptr(),
                scl.data_ptr(), gf.data_ptr(), _cuda.ptr(gd), None, out[side]["g_x"].data_ptr(),
                None, N, L, C, 1.0, T)

        for side in calls:
            fwd(side)(), bwd(side)()
        torch.cuda.synchronize()
        a, b = out["this"], out["earlier"]
        err = chip_smoke.max_abs(a["feats"], b["feats"]) / float(b["feats"].abs().max())
        rel = chip_smoke.rel_l2(a["g_x"], b["g_x"])
        for kdir, fn, ok, bnd in (
                ("fwd", fwd, err <= chip_smoke.VAL_RTOL,
                 chip_smoke.hash_cost(spec, N, rows, jac, False)),
                ("bwd", bwd, rel <= chip_smoke.GRAD_REL_L2,
                 chip_smoke.hash_cost(spec, N, rows, jac, True, table_grad=False))):
            rows_out.append(dict(
                case=f"{'K1' if jac else 'K2'} {kdir} {grid}/track/ray", points=N, ok=ok,
                agreement=dict(value_err=err, grad_x_rel_l2=rel),
                times_ms=turns({s: fn(s) for s in calls}),
                bound_ms=chip_smoke.bound(*bnd)[0]))
        del table, x, gf, gd, out
        torch.cuda.empty_cache()


def bf16_bwd_cases(dev, calls, rows_out):
    """K2's backward on bf16 rows (the sharded colour encode's) at
    chip_smoke.BF16_BWD_CASES, ray-ordered, with the table gradient and
    grad_x; this checkout's table gradient bit for bit with
    hash_table_grad_fixed_plain."""
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    spec = chip_smoke.hash_specs()["color"]
    L, C, T = spec.num_levels, spec.level_dim, spec.total_entries
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    packed = he.pack_table_bf16(torch.rand((T, C), generator=g, device=dev) * 2 - 1)
    meta, scl = he._level_tables(spec, 1.0, str(dev))
    scratch = {"this": he.fixed_point_scratch(spec, dev),
               "earlier": torch.zeros(T * C + 32, dtype=torch.int64, device=dev)}
    for kind in chip_smoke.BF16_BWD_CASES:
        x = chip_smoke.hash_points(g, dev, kind, "ray")
        N, rows = x.shape[0], chip_smoke.touched_rows(spec, x)
        gf = torch.randn((N, L * C), generator=g, device=dev)
        out = {s: (torch.empty((T, C), device=dev), torch.empty((N, 3), device=dev))
               for s in calls}

        def bwd(side):
            return lambda: calls[side](
                "nsl_hash_encode_bf16_bwd", x.data_ptr(), packed.data_ptr(), meta.data_ptr(),
                scl.data_ptr(), gf.data_ptr(), out[side][0].data_ptr(),
                out[side][1].data_ptr(), scratch[side].data_ptr(), N, L, C, 1.0, T)

        for side in calls:
            bwd(side)()
        torch.cuda.synchronize()
        (ta, xa), (tb, xb) = out["this"], out["earlier"]
        rel = [chip_smoke.rel_l2(ta, tb), chip_smoke.rel_l2(xa, xb)]
        exact = bool(torch.equal(ta, he.hash_table_grad_fixed_plain(spec, x, gf)))
        zero = he.fixed_point_state_is_zero(spec, scratch["this"])
        nb, ops = chip_smoke.hash_cost(spec, N, rows, False, True)
        rows_out.append(dict(
            case=f"K2 bf16 bwd color/{kind}/ray", points=N,
            ok=max(rel) <= chip_smoke.GRAD_REL_L2 and exact and zero,
            agreement=dict(grad_rel_l2=max(rel), table_grad_bit_equal_plain=exact,
                           accumulator_zero_after=zero),
            times_ms=turns({s: bwd(s) for s in calls}),
            bound_ms=chip_smoke.bound(nb - rows * C * 2, ops)[0],
            floor_ms=chip_smoke.hash_floor_ms(spec, N, rows, False) - rows * C * 2
            / chip_smoke.HBM_BYTES_PER_S * 1e3))
        del x, gf, out
        torch.cuda.empty_cache()
    del packed, scratch
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
            scfg, z_pre, near, far, dens, perm, eik = chip_smoke.given_inputs(g, dev, R)
            pz, pe = rs.importance_sample_given_plain(scfg, z_pre, near, far, dens, perm, eik)
            io = chip_smoke.nbytes(z_pre, near, far, dens, perm, eik, pz, pe)
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
                "nsl_importance_sample_given", z_pre.data_ptr(), near.data_ptr(),
                far.data_ptr(), dens.data_ptr(), perm.data_ptr(), eik.data_ptr(),
                z_out.data_ptr(), z_eik.data_ptr(), R, R, Ne, Ns, Nx, rs._step(Ns))

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


def composite_cases(dev, calls, rows_out, S: int = 98, Kc: int = 16):
    import torch
    from nicer_slam_tpu_torch.ops import volume_rendering as vr

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    f32 = dict(dtype=torch.float32, device=dev)
    cases = [(R, "random") for R in chip_smoke.TOPK_RAYS] + [(chip_smoke.TOPK_RAYS[-1],
                                                                "surface")]
    for R, kind in cases:
        tag = f"{R} rays" + ("" if kind == "random" else " surface")
        z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 3.0, dim=1)[0]
        dens = (torch.rand((R, S), generator=g, device=dev) * 20.0 if kind == "random"
                else chip_smoke.surface_densities(g, dev, z))
        nrm = torch.randn((R, S, 3), generator=g, device=dev)
        plain = vr.weights_topk_plain(z, dens, nrm, Kc)
        # ---- the weights pass
        outs = {s_: [torch.empty_like(t) for t in plain] for s_ in calls}

        def wfwd(side):
            return lambda: calls[side]("nsl_weights_topk_fwd", z.data_ptr(), dens.data_ptr(),
                                       nrm.data_ptr(), *(t.data_ptr() for t in outs[side]),
                                       R, S, Kc)

        fns = {**{s_: wfwd(s_) for s_ in calls},
               "torch.topk": lambda: torch.topk(plain[0], Kc, dim=1)}
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        new, old = outs["this"], outs["earlier"]
        errs = [chip_smoke.max_abs(a, b) / float(b.abs().max())
                for a, b in zip(new[:5], old[:5])]
        through_plain = [chip_smoke.max_abs(plain[0].reshape(-1)[p.reshape(-1)],
                                            plain[3].reshape(-1)) / float(plain[3].abs().max())
                         for p in (new[5], old[5])]
        agree = dict(value_err_vs_earlier=max(errs),
                     picks_through_plain_err=dict(zip(("this", "earlier"), through_plain)),
                     rays_other_picks_than_earlier=int((new[5] != old[5]).any(1).sum()),
                     rays_other_picks_than_plain=int((new[5] != plain[5]).any(1).sum()))
        rows_out.append(dict(
            case=f"K4 weights_topk.fwd {tag}", points=R * S,
            ok=max(errs) <= chip_smoke.VAL_RTOL and max(through_plain) <= chip_smoke.VAL_RTOL,
            agreement=agree, times_ms=turns(fns),
            bound_ms=chip_smoke.bound(chip_smoke.nbytes(z, dens, nrm, *new),
                                      R * S * (30 + Kc))[0]))
        # ---- its backward, with the top-k cotangents and the picks
        picks = new[5]
        gdep, gn = (torch.randn((R, 1), generator=g, device=dev),
                    torch.randn((R, 3), generator=g, device=dev))
        gtw, gws = (torch.randn((R, Kc), generator=g, device=dev),
                    torch.randn((R, 1), generator=g, device=dev))
        bouts = {s_: (torch.empty((R, S), **f32), torch.empty((R, S, 3), **f32)) for s_ in calls}

        def wbwd(side):
            return lambda: calls[side](
                "nsl_composite_bwd", z.data_ptr(), dens.data_ptr(), None, nrm.data_ptr(),
                picks.data_ptr(), None, None, gdep.data_ptr(), gn.data_ptr(), gtw.data_ptr(),
                gws.data_ptr(), bouts[side][0].data_ptr(), None, bouts[side][1].data_ptr(),
                R, S, Kc)

        for side in calls:
            wbwd(side)()
        torch.cuda.synchronize()
        ref = vr.weights_topk_bwd_plain(z, dens, nrm, picks, None, gdep, gn, gtw, gws)
        rel = {s_: max(chip_smoke.rel_l2(a, b) for a, b in zip(bouts[s_], ref)) for s_ in calls}
        rows_out.append(dict(
            case=f"K4 weights_topk.bwd {tag}", points=R * S,
            ok=rel["this"] <= chip_smoke.GRAD_REL_L2,
            agreement=dict(grad_rel_l2_vs_plain=rel), times_ms=turns({s_: wbwd(s_)
                                                                     for s_ in calls}),
            bound_ms=chip_smoke.bound(chip_smoke.nbytes(z, dens, nrm, gdep, gn, picks, gtw, gws,
                                                        *bouts["this"]), R * S * 50)[0]))
        if kind == "surface":
            continue
        # ---- the top-k colour composite
        topk_w, wsum = plain[3].contiguous(), plain[4].contiguous()
        rgb = torch.rand((R, Kc, 3), generator=g, device=dev)
        go = torch.randn((R, 3), generator=g, device=dev)
        fo = {s_: torch.empty((R, 3), **f32) for s_ in calls}
        bo = {s_: (torch.empty((R, Kc), **f32), torch.empty((R, 1), **f32),
                   torch.empty((R, Kc, 3), **f32)) for s_ in calls}

        def rgb_fwd(side):
            return lambda: calls[side]("nsl_topk_rgb_fwd", topk_w.data_ptr(), wsum.data_ptr(),
                                       rgb.data_ptr(), fo[side].data_ptr(), R, Kc)

        def rgb_bwd(side):
            return lambda: calls[side]("nsl_topk_rgb_bwd", topk_w.data_ptr(), wsum.data_ptr(),
                                       rgb.data_ptr(), go.data_ptr(),
                                       *(t.data_ptr() for t in bo[side]), R, Kc)

        for side in calls:
            rgb_fwd(side)(), rgb_bwd(side)()
        torch.cuda.synchronize()
        ins = [t.clone().requires_grad_(True) for t in (topk_w, wsum, rgb)]
        pf = vr.topk_rgb_plain(*ins)
        pb = torch.autograd.grad((pf * go).sum(), ins)
        for kdir, got, want, fn, nb, ops in (
                ("fwd", {s_: [fo[s_]] for s_ in calls}, [pf.detach()], rgb_fwd,
                 chip_smoke.nbytes(topk_w, wsum, rgb, fo["this"]), R * Kc * 8),
                ("bwd", bo, list(pb), rgb_bwd,
                 chip_smoke.nbytes(topk_w, wsum, rgb, go, *bo["this"]), R * Kc * 12)):
            err = {s_: max(chip_smoke.max_abs(a, b) / float(b.abs().max())
                           for a, b in zip(got[s_], want)) for s_ in calls}
            rows_out.append(dict(
                case=f"K4 topk_rgb.{kdir} {R} rays", points=R * Kc,
                ok=err["this"] <= chip_smoke.VAL_RTOL, agreement=dict(value_err_vs_plain=err),
                times_ms=turns({s_: fn(s_) for s_ in calls}),
                bound_ms=chip_smoke.bound(nb, ops)[0]))
        del z, dens, nrm, plain, outs, bouts, ref, fo, bo, ins, pf, pb
        torch.cuda.empty_cache()
    # ---- the launch floor: one fill of a single float, timed the same way
    one = torch.zeros(1, device=dev)
    rows_out.append(dict(case="launch floor (fill of 1 float)", points=1, ok=True,
                         agreement={}, times_ms=turns({"earlier": one.zero_, "this": one.zero_}),
                         bound_ms=0.0))
    # ---- the plain composite's backward with colour, at the demo's shape
    R = 4096
    z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 3.0, dim=1)[0]
    dens = torch.rand((R, S), generator=g, device=dev) * 20.0
    rgb = torch.rand((R, S, 3), generator=g, device=dev)
    nrm = torch.randn((R, S, 3), generator=g, device=dev)
    gouts = [torch.randn(s_, generator=g, device=dev) for s_ in ((R, S), (R, 3), (R, 1), (R, 3))]
    outs = {s_: [torch.empty((R, S), **f32), torch.empty((R, S, 3), **f32),
                 torch.empty((R, S, 3), **f32)] for s_ in calls}
    gw, grgb, gdep, gn = (t.data_ptr() for t in gouts)

    def cbwd(side):
        return lambda: calls[side](
            "nsl_composite_bwd", z.data_ptr(), dens.data_ptr(), rgb.data_ptr(), nrm.data_ptr(),
            None, gw, grgb, gdep, gn, None, None, *(t.data_ptr() for t in outs[side]), R, S, 0)

    for side in calls:
        cbwd(side)()
    torch.cuda.synchronize()
    ins = [t.clone().requires_grad_(True) for t in (dens, rgb, nrm)]
    ref = torch.autograd.grad(vr.composite_plain(z, *ins), ins, gouts)
    rel = {s_: max(chip_smoke.rel_l2(a, b) for a, b in zip(outs[s_], ref)) for s_ in calls}
    rows_out.append(dict(
        case=f"K4 composite.bwd {R} rays", points=R * S, ok=rel["this"] <= chip_smoke.GRAD_REL_L2,
        agreement=dict(grad_rel_l2_vs_plain=rel), times_ms=turns({s_: cbwd(s_) for s_ in calls}),
        bound_ms=chip_smoke.bound(chip_smoke.nbytes(z, dens, rgb, nrm, *gouts, *outs["this"]),
                                  R * S * 60)[0]))
    # ---- the plain composite's forward
    for R, S_ in chip_smoke.COMPOSITE_SHAPES:
        z = torch.sort(torch.rand((R, S_), generator=g, device=dev) * 3.0, dim=1)[0]
        dens = torch.rand((R, S_), generator=g, device=dev) * 20.0
        rgb = torch.rand((R, S_, 3), generator=g, device=dev)
        nrm = torch.randn((R, S_, 3), generator=g, device=dev)
        outs = {s_: [torch.empty(sh, **f32) for sh in ((R, S_), (R, 3), (R, 1), (R, 3))]
                for s_ in calls}

        def cfwd(side, z=z, dens=dens, rgb=rgb, nrm=nrm, R=R, S_=S_):
            return lambda: calls[side](
                "nsl_composite_fwd", z.data_ptr(), dens.data_ptr(), rgb.data_ptr(),
                nrm.data_ptr(), *(t.data_ptr() for t in outs[side]), R, S_)

        for side in calls:
            cfwd(side)()
        torch.cuda.synchronize()
        ref = vr.composite_plain(z, dens, rgb, nrm)
        err = {s_: max(chip_smoke.max_abs(a, b) / float(b.abs().max())
                       for a, b in zip(outs[s_], ref)) for s_ in calls}
        rows_out.append(dict(
            case=f"K4 composite.fwd {R}x{S_}", points=R * S_,
            ok=err["this"] <= chip_smoke.VAL_RTOL, agreement=dict(rel_err_vs_plain=err),
            times_ms=turns({s_: cfwd(s_) for s_ in calls}),
            bound_ms=chip_smoke.bound(chip_smoke.nbytes(z, dens, rgb, nrm, *outs["this"]),
                                      R * S_ * 30)[0]))


def voxel_cases(dev, calls, rows_out):
    import torch
    from nicer_slam_tpu_torch.ops import density as dens_ops

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    neg_b = float(torch.tensor(-dens_ops.BETA_B * 1e-4, dtype=torch.float32))
    for kind, n in chip_smoke.VOXEL_CASES:
        x = chip_smoke.voxel_points(g, dev, kind, n)
        N = x.shape[0]
        vox0 = torch.randint(0, 200, (64, 64, 64), generator=g, device=dev).to(torch.float32)
        counters = {s_: vox0.clone() for s_ in calls}
        betas = {s_: torch.empty((N, 1), device=dev) for s_ in calls}

        def scatter(side):
            # update_voxels' work: the counter copied, then the launch
            def fn():
                counters[side] = vox0.clone()
                calls[side]("nsl_voxel_scatter", x.data_ptr(), counters[side].data_ptr(), N, 64)
            return fn

        def beta(side):
            return lambda: calls[side](
                "nsl_voxel_beta", x.data_ptr(), counters["this"].data_ptr(),
                betas[side].data_ptr(), N, 64, neg_b, dens_ops.BETA_D, dens_ops.BETA_A,
                dens_ops.BETA_C)

        for side in calls:
            scatter(side)()
        for side in calls:
            beta(side)()
        torch.cuda.synchronize()
        same = bool(torch.equal(counters["this"], counters["earlier"]))
        plain = dens_ops.update_voxels_plain(vox0, x)
        exact = bool(torch.equal(counters["this"], plain))
        err = (chip_smoke.max_abs(betas["this"], betas["earlier"])
               / float(betas["earlier"].abs().max()))
        vidx, boundary = dens_ops._voxel_index(x, 64)
        touched = int(torch.unique(((vidx[:, 0] * 64 + vidx[:, 1]) * 64
                                    + vidx[:, 2])[~boundary]).numel())
        rows_out.append(dict(
            case=f"K7 scatter {kind} {N}", points=N, ok=same and exact,
            agreement=dict(counter_bit_equal_earlier=same, counter_bit_equal_plain=exact),
            times_ms=turns({s_: scatter(s_) for s_ in calls}),
            bound_ms=chip_smoke.bound(chip_smoke.nbytes(x, vox0, plain), N * 12)[0]))
        rows_out.append(dict(
            case=f"K7 beta {kind} {N}", points=N, ok=err <= chip_smoke.VAL_RTOL,
            agreement=dict(value_err=err,
                           bit_equal=bool(torch.equal(betas["this"], betas["earlier"]))),
            times_ms=turns({s_: beta(s_) for s_ in calls}),
            bound_ms=chip_smoke.bound(chip_smoke.nbytes(x, betas["this"]) + 4 * touched,
                                      N * 20)[0]))
        del x, vox0, counters, betas, plain, vidx, boundary


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
    for cases in (composite_cases, bf16_cases, sampler_cases, voxel_cases, tracking_cases,
                  bf16_bwd_cases, hash_cases):
        done = len(rows_out)
        cases(dev, calls, rows_out)
        for row in rows_out[done:]:
            ms = {s: mean(v) for s, v in row["times_ms"].items()}
            b = row["bound_ms"]
            more = "".join(f" {s} {v:.4f}" for s, v in ms.items() if s not in calls)
            if "floor_ms" in row:
                f = row["floor_ms"]
                more += (f" floor {f:.4f} (share {f / ms['earlier']:.1%} -> "
                         f"{f / ms['this']:.1%})")
            print(f"{row['case']:36s} earlier {ms['earlier']:.4f} this {ms['this']:.4f} ms "
                  f"(x{ms['earlier'] / ms['this']:.2f}; bound {b:.4f}, share "
                  f"{b / ms['earlier']:.1%} -> {b / ms['this']:.1%}){more} agree {row['ok']} "
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
