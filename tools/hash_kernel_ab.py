#!/usr/bin/env python3
"""K1/K2 hash-grid kernels of an earlier commit against this checkout's, on
one CUDA card, in one process.

  git show <commit>:nicer_slam_tpu_torch/csrc/hash_encoder.cu > build/parent/hash_encoder.cu
  python3 tools/hash_kernel_ab.py --parent-source build/parent/hash_encoder.cu \\
      [--out build/hash_kernel_ab.json]

The earlier source must have the C interface of the channel-major kernels:
tables [C, T], the backward writing grad_x per level as [N, L, 3] (which
its wrapper summed over the levels in a second launch). It is built with
nvcc beside this checkout's library (build/kernels/) into build/parent/.
Both run on the same points and on the same table values (the earlier
kernel on the [C, T] transpose): chip_smoke.py's K1/K2 cases at the
flagship path's shapes, ray-ordered and uniform. Each case first holds the
two kernels' outputs against each other (values within 1e-5 of the largest,
gradients within 1e-5 relative L2), then times each launch alone in turns:
earlier, this, this, earlier (10 launches each, CUDA events, the gradient
table zeroed outside the timed window). The earlier backward is timed
alone and with its grad_x sum.
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

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float


def build_parent(source: str) -> ctypes.CDLL:
    from nicer_slam_tpu_torch.ops import _cuda
    out_dir = os.path.join(ROOT, "build", "parent")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libparent_hash.so")
    cmd = [_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
           "-fPIC", "-shared", "-o", lib, source]
    subprocess.run(cmd, check=True)
    dll = ctypes.CDLL(lib)
    # x, table [C, T], meta, scale, feats, dfeat, N, L, C, T, size, stream
    dll.nsl_hash_encode_fwd.argtypes = [_P] * 6 + [_I64, _I, _I, _I64, _F, _P]
    # x, table, meta, scale, g_feat, g_dfeat, g_table, g_x [N, L, 3], N, L, C, T, size, stream
    dll.nsl_hash_encode_bwd.argtypes = [_P] * 8 + [_I64, _I, _I, _I64, _F, _P]
    dll.nsl_hash_encode_fwd.restype = dll.nsl_hash_encode_bwd.restype = _I
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-source", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "hash_kernel_ab.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("hash_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from nicer_slam_tpu_torch.config import parse_file
    from nicer_slam_tpu_torch.models import fields
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    _cuda.library()
    parent = build_parent(args.parent_source)
    conf = parse_file(chip_smoke.PATHS["flagship"]["conf"]).get_config("model")
    fvs = conf.get_int("feature_vector_size")
    comb = fields.combine_config_from_conf(conf.get_config("implicit_network"), fvs)
    rend = fields.rendering_config_from_conf(conf.get_config("rendering_network"), fvs)
    specs = {"fine": comb.fine.hash_spec(), "coarse": comb.coarse.hash_spec(),
             "color": rend.hash_spec()}
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows_out, failures = [], []
    for grid, jac, kind in chip_smoke.HASH_CASES:
        spec = specs[grid]
        L, C, T = spec.num_levels, spec.level_dim, spec.total_entries
        table = torch.rand((T, C), generator=g, device=dev) * 2 - 1
        table_ct = table.t().contiguous()
        meta, scl = he._level_tables(spec, 1.0, str(dev))
        for order in ("ray", "uniform"):
            x = chip_smoke.hash_points(g, dev, kind, order)
            N = x.shape[0]
            rows = chip_smoke.touched_rows(spec, x)
            gf = torch.randn((N, L * C), generator=g, device=dev)
            gd = torch.randn((N, L * C, 3), generator=g, device=dev) if jac else None
            feats = [torch.empty((N, L * C), device=dev) for _ in range(2)]
            dfeat = [torch.empty((N, L * C, 3), device=dev) if jac else None for _ in range(2)]
            g_table = [torch.zeros_like(table), torch.zeros_like(table_ct)]
            g_x = torch.empty((N, 3), device=dev)
            g_xl = torch.empty((N, L, 3), device=dev)

            def new_fwd():
                he.hash_encode_fwd_launch(spec, table, x, 1.0, feats[0], dfeat[0])

            def old_fwd():
                rc = parent.nsl_hash_encode_fwd(
                    x.data_ptr(), table_ct.data_ptr(), meta.data_ptr(), scl.data_ptr(),
                    feats[1].data_ptr(), _cuda.ptr(dfeat[1]), N, L, C, T, 1.0, stream())
                assert rc == 0, rc

            def new_bwd():
                he.hash_encode_bwd_launch(spec, table, x, 1.0, jac, gf, gd, g_table[0], g_x)

            def old_bwd():
                rc = parent.nsl_hash_encode_bwd(
                    x.data_ptr(), table_ct.data_ptr(), meta.data_ptr(), scl.data_ptr(),
                    gf.data_ptr(), _cuda.ptr(gd), g_table[1].data_ptr(), g_xl.data_ptr(),
                    N, L, C, T, 1.0, stream())
                assert rc == 0, rc

            def old_bwd_sum():
                old_bwd()
                torch.sum(g_xl, dim=1, out=g_x)

            new_fwd(), old_fwd(), new_bwd(), old_bwd()
            torch.cuda.synchronize()
            errs = [chip_smoke.max_abs(feats[0], feats[1]) / float(feats[1].abs().max())]
            if jac:
                errs.append(chip_smoke.max_abs(dfeat[0], dfeat[1]) / float(dfeat[1].abs().max()))
            rel = [chip_smoke.rel_l2(g_table[0].t(), g_table[1]),
                   chip_smoke.rel_l2(g_x, g_xl.sum(1))]
            ok = max(errs) <= chip_smoke.VAL_RTOL and max(rel) <= chip_smoke.GRAD_REL_L2
            zero = lambda: [t.zero_() for t in g_table]  # noqa: E731
            t = {k: [] for k in ("old_fwd", "new_fwd", "old_bwd", "new_bwd", "old_bwd_sum")}
            for turn in ("old", "new", "new", "old"):
                t[f"{turn}_fwd"].append(chip_smoke.cuda_time(old_fwd if turn == "old" else new_fwd))
                t[f"{turn}_bwd"].append(chip_smoke.cuda_time(
                    old_bwd if turn == "old" else new_bwd, before=zero))
                if turn == "old":
                    t["old_bwd_sum"].append(chip_smoke.cuda_time(old_bwd_sum, before=zero))
            ms = {k: sum(v) / len(v) for k, v in t.items()}
            b_fwd = chip_smoke.bound(*chip_smoke.hash_cost(spec, N, rows, jac, False))[0]
            b_bwd = chip_smoke.bound(*chip_smoke.hash_cost(spec, N, rows, jac, True))[0]
            row = dict(case=f"{grid}/{kind}/{order}", kernel="K1" if jac else "K2", points=N,
                       rows=rows, ok=ok, value_err=max(errs), grad_rel_l2=max(rel),
                       times_ms=t, mean_ms=ms, bound_fwd_ms=b_fwd, bound_bwd_ms=b_bwd)
            rows_out.append(row)
            print(f"{row['case']:22s} {row['kernel']} N {N} rows {rows}: fwd earlier "
                  f"{ms['old_fwd']:.4f} this {ms['new_fwd']:.4f} ms (bound {b_fwd:.4f}, share "
                  f"{b_fwd / ms['old_fwd']:.1%} -> {b_fwd / ms['new_fwd']:.1%}); bwd earlier "
                  f"{ms['old_bwd']:.4f} (+sum {ms['old_bwd_sum']:.4f}) this {ms['new_bwd']:.4f} "
                  f"ms (bound {b_bwd:.4f}, share {b_bwd / ms['old_bwd_sum']:.1%} -> "
                  f"{b_bwd / ms['new_bwd']:.1%}); agree {ok} (values {max(errs):.1e}, "
                  f"grads {max(rel):.1e})", flush=True)
            if not ok:
                failures.append(row["case"])
            del x, gf, gd, feats, dfeat, g_table, g_x, g_xl
            torch.cuda.empty_cache()
        del table, table_ct
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "cases": rows_out}, f, indent=1)
    print(card)
    if failures:
        print(f"hash_kernel_ab: the two kernels disagree on {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
