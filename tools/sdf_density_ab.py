#!/usr/bin/env python3
"""K6 (``csrc/sdf_density.cu``) of other source trees against this
checkout's, on one CUDA card, in one process.

  python3 tools/sdf_density_ab.py --other DIR [--other DIR ...] [--out FILE]
                                  [--only SUBSTRING]

Each DIR holds a ``nicer_slam_tpu_torch/`` whose ``csrc/sdf_density.cu``
has this checkout's C interface (``nsl_sdf_density``,
``nsl_sdf_density_general`` and ``nsl_sdf_density_general_plan``: a
checkout of another commit, or a variant of this kernel); each is built
with nvcc into ``build/sdf_ab/<n>/`` beside this checkout's library, and
each side packs the general kernel's weights with its own
``ops/sdf_density.pack_general`` (its layout may differ), loaded as a
module of this checkout's package. All run on chip_smoke.py's operands:
the shipped kernel on the flagship configuration's SDF networks
(``chip_smoke.sdf_net``) at the 128³ density cache and a 2580-ray render
chunk (640 z a ray), then every case of ``chip_smoke.GENERAL_CASES`` (the
general and concat variants, the same rays in the same order as
``check_sdf_general``). Each side's output is held against the plain
version within ``chip_smoke.SDF_DENSITY_RTOL`` of its largest value, then
each launch is timed alone in turns, forth and back over the sides (10
launches each, CUDA events, behind chip_smoke's device sleep). ``--only``
keeps the cases whose name holds the substring.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

ENTRIES = ("nsl_sdf_density", "nsl_sdf_density_general", "nsl_sdf_density_general_plan")


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
    for name in ENTRIES:
        getattr(dll, name).argtypes = _cuda._SIGNATURES[name]
        getattr(dll, name).restype = ctypes.c_int
    return dll


def packer(src_root: str, n: int):
    """The tree's ops/sdf_density.py as a module of this checkout's package
    (its relative imports resolve here): its pack_general."""
    path = os.path.join(os.path.abspath(src_root), "nicer_slam_tpu_torch", "ops",
                        "sdf_density.py")
    name = f"nicer_slam_tpu_torch.ops._sdf_density_ab{n}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _plan(lib, desc, w_floats: int):
    tile, nbytes, ring = ctypes.c_int(), ctypes.c_int64(), ctypes.c_int()
    rc = lib.nsl_sdf_density_general_plan(desc.ctypes.data, w_floats, ctypes.byref(tile),
                                          ctypes.byref(nbytes), ctypes.byref(ring))
    if rc != 0:
        raise RuntimeError(f"nsl_sdf_density_general_plan: CUDA error {rc}")
    return dict(tile=tile.value, smem_bytes=nbytes.value, w_smem_floats=ring.value)


def compare(name, n_points, plain, bound_ms, sides, outs, extra=None):
    """Hold each side's output against the plain version, then time the
    sides in turns; one row of the report."""
    import torch
    for fn in sides.values():
        fn()
    torch.cuda.synchronize()
    plain = plain.reshape(-1)
    scale = float(plain.abs().max())
    err = {side: float((outs[side].reshape(-1) - plain).abs().max()) / scale
           for side in sides}
    times = {side: [] for side in sides}
    order = list(sides)
    for side in order + order[::-1]:
        times[side].append(chip_smoke.cuda_time(sides[side]))
    ms = {side: sum(v) / len(v) for side, v in times.items()}
    ok = all(e <= chip_smoke.SDF_DENSITY_RTOL for e in err.values())
    print(f"{name:28s} " + " ".join(f"{side}: {ms[side]:.4f} ms (share "
                                     f"{bound_ms / ms[side]:.1%}, err {err[side]:.2e})"
                                     for side in sides)
          + f" agree {ok}", flush=True)
    return dict(case=name, points=n_points, ok=ok, rel_err_vs_plain=err, times_ms=times,
                mean_ms=ms, bound_ms=bound_ms, **(extra or {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", required=True,
                    help="root of a tree with nicer_slam_tpu_torch/csrc/sdf_density.cu")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sdf_density_ab.json"))
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)
    import numpy as np
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
    libs, packs = {"this": _cuda.library()}, {"this": sd}
    for n, other in enumerate(args.other):
        libs[other] = build_side(other, n)
        packs[other] = packer(other, n)

    def want(name):
        return args.only is None or args.only in name

    def tail_of(m, vox, out, n):
        """The entry points' arguments after the grids: the mode's
        operands, the voxel counter, the output and the stream."""
        return (_cuda.ptr(m.get("xs")), m.get("res", 0), _cuda.ptr(m.get("o")),
                _cuda.ptr(m.get("d")), _cuda.ptr(m.get("z")), m.get("S", 0), vox.data_ptr(),
                64, dens_ops.NEG_B_1E4, dens_ops.BETA_D, dens_ops.BETA_A, dens_ops.BETA_C, None,
                None, out.data_ptr(), n, torch.cuda.current_stream().cuda_stream)

    def grids(net, tables):
        tabs = [(tables[k], *he._level_tables(getattr(net, k).spec, 1.0, str(dev)))
                for k in ("coarse", "fine")]
        return tuple(t.data_ptr() for tab in tabs for t in tab)

    rows = []
    # the shipped kernel (nsl_sdf_density)
    net, vox = chip_smoke.sdf_net(dev)
    pack = sd.pack_sdf(net)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32)
    o, d = chip_smoke._sampler_rays(g, dev, chip_smoke.GIVEN_RAYS)
    z, _, _ = rs.uniform_z_vals(scfg, o, d, None)
    res = chip_smoke.SDF_RES
    shipped = {
        f"shipped grid {res}^3": (dict(xs=torch.linspace(-1.0, 1.0, res, device=dev), res=res),
                                  res ** 3, lambda: sd.density_grid_plain(net, pack.tables,
                                                                          res, vox),
                                  chip_smoke.bound(*chip_smoke.density_cache_cost(res))[0]),
        f"shipped rays {chip_smoke.GIVEN_RAYS}x640": (
            dict(o=o, d=d, z=z, S=z.shape[1]), z.numel(),
            lambda: sd.density_rays_plain(net, pack.tables, o, d, z, vox),
            chip_smoke.bound(*chip_smoke.sdf_density_cost(
                z.numel(), chip_smoke.nbytes(o, d, z, z)))[0]),
    }
    gp = grids(net, pack.tables)
    for name, (m, n, plain, bnd) in shipped.items():
        if not want(name):
            continue
        outs = {side: torch.empty(n, device=dev) for side in libs}

        def run(side, m=m, n=n, outs=outs):
            def fn():
                rc = libs[side].nsl_sdf_density(pack.weights.data_ptr(), *gp,
                                                *tail_of(m, vox, outs[side], n))
                if rc != 0:
                    raise RuntimeError(f"{side}: CUDA error {rc}")
            return fn

        rows.append(compare(name, n, plain(), bnd, {s: run(s) for s in libs}, outs))
    del net, vox, pack
    torch.cuda.empty_cache()

    # the general and concat variants, on check_sdf_general's operands
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    for case in chip_smoke.GENERAL_CASES:
        c = chip_smoke.general_case(dev, g, case)
        name = f"{c.pack.variant} {c.tag}"
        if not want(name):
            continue
        concat = int(c.pack.variant == "concat")
        gp = grids(c.net, c.pack.tables)
        n = c.x.shape[0]
        sided = {}
        for side in libs:
            flat, desc = packs[side].pack_general(c.net)
            sided[side] = (flat.contiguous(), np.ascontiguousarray(desc, np.int32))
        plans = {side: _plan(libs[side], sided[side][1], sided[side][0].numel())
                 for side in libs}
        outs = {side: torch.empty(n, device=dev) for side in libs}

        def run(side, c=c, gp=gp, n=n, outs=outs, sided=sided, concat=concat):
            flat, desc = sided[side]

            def fn():
                rc = libs[side].nsl_sdf_density_general(
                    desc.ctypes.data, flat.data_ptr(), flat.numel(), *gp, concat,
                    *tail_of(c.kw, c.vox, outs[side], n))
                if rc != 0:
                    raise RuntimeError(f"{side}: CUDA error {rc}")
            return fn

        rows.append(compare(name, n, c.plain(), chip_smoke.bound(*c.cost)[0],
                            {s: run(s) for s in libs}, outs, dict(plans=plans)))
        del c, outs, sided
        torch.cuda.empty_cache()
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
