#!/usr/bin/env python3
"""Smoke run of nicer_slam_tpu_torch on one CUDA card.

  python3 chip_smoke.py

Phases, in order (any failure exits non-zero without the final line):
  1. card: require CUDA; print the card's name and power limit. Two
     synthetic scans start generating in the background (processes this
     script waits for): the demo scan (11 frames, 720x1280, flow) and the
     flagship scan (11 frames, 680x1200, flow and GT depth).
  2. build: compile csrc/*.cu for sm_90a (one nvcc per source, in
     parallel; plain C interface).
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, with errors, tolerances, CUDA-event times of each launch
     alone (on preallocated operands; the K1/K2 backward's time includes
     its maxima pass and the sweep that converts and re-zeroes its
     fixed-point accumulator) and of the plain version, and the kernel's bound
     (the bytes it must move over the card's memory rate, or its
     operations over the float32 rate, whichever is larger): K1 and K2 at
     the flagship path's shapes on ray-ordered and on uniform points
     (802,816 SDF points through the fine and coarse grids; the full
     133M-entry colour grid at the 131,072 top-16 points and at the demo's
     4096 x 98), K4 at the demo slice's shapes, K7 at a flagship mapping
     iteration's 8192 x 98 samples (unordered, as earlier kernels were
     timed, and ray-ordered), a tracking iteration's 1024 x 98 and a
     density-cache chunk (the counter bit for bit), K4 with colour
     top-16 at its tracking and mapping rays (1024 and 8192 x 98; the
     weights pass also on surface-like densities, where ties at exact
     zeros decide the last picks; torch.topk timed beside it as the
     library's pick alone), K4 at small shapes that the paths do not give
     it (64 rays x 200 samples, top-40 and top-12), K3 on both SDF grids at a density-cache build
     chunk (131,072 grid points), the ray-ordered exact prepass of a
     2580-ray render chunk (1,651,200 points) and as many uniform points,
     K5 at 1024 (tracking), 4096 and 8192 (mapping) rays and K5 given
     densities at a render chunk. The plain versions of K1/K2 run once;
     the K1/K2 backward runs twice more and its table gradient must come
     out the same bit for bit, with its kept fixed-point accumulator zero
     after every launch.
  4. demo: the demo configuration (confs/runconf_demo_1.conf, every network
     at full width) through the port's exp_runner: tracking on every frame,
     mapping + BA at frames 0, 5 and 10, global_window_start = 10 (200 by
     default, which would need 200 frames) so the frame-10 mapping call has
     live flow edges (keyframes 0 <-> 10), and the vis hook at the end
     with plot.resolution 256 for the mesh (the conf's 512³ would hold a
     1.6 GB grid on the host for no more of a check).
  5. flagship: confs/replica/runconf_replica_2.conf (8192 mapping rays,
     100/100 iterations, colour top-16, warp loss, GT depth) the same way,
     with the JAX package's camera free-space guard on (see PATHS).
     Launch counters are reset just before and read just after each run.
  6. repeat: the demo configuration twice more in this process, 6 frames
     each (mapping at frames 0 and 5), same seed and scan, through the
     runner's loop; every per-frame pose, every mapping call's loss terms
     and every final model and voxel tensor must be the same bit for bit.
  7. report: per run, translation error against GT per frame, the loss
     terms of each mapping call's last iteration, launch counts, s/frame,
     ms per track and map iteration, the runner's phase times, peak memory;
     the final model checkpoint is read back and held against the model;
     vis/ must hold rendering_*.png and surface_*.ply. Then one JSON line
     with every kernel, the nvidia-smi line, and the result line.

Float32 matmuls run without TF32 (set explicitly below). Runs repeat bit
for bit without any process-wide torch setting: every sum on the paths
has a fixed order (phase 6 checks it). Scratch data goes to build/smoke/
inside the checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE_DIR = os.path.join(ROOT, "build", "smoke")
N_FRAMES = 11
# the frame from which the mapping window is global and carries flow edges
GLOBAL_WINDOW_START = 10
# the two runs: conf, the scan's image size and scan id, the conf's dataset
# line, and the run's own conf edits (beside those of write_conf)
PATHS = {
    "demo": dict(conf=os.path.join(ROOT, "confs", "runconf_demo_1.conf"), H=720, W=1280,
                 scan_id=1, data_dir='"../Datasets/processed/Demo"', n_images=200,
                 edits=[]),
    # On the synthetic scan the flagship conf's frame-0 mapping call (100
    # iterations, the metric depth anchor at weight 10) drives the SDF
    # negative everywhere ("fog": the camera ends up inside the surface) in
    # the JAX package as in the port, and no mesh has a zero crossing
    # (tests/test_torch_frame0_fog.py). The JAX package's camera free-space
    # guard (loss.cam_freespace_w, off in the shipped confs) keeps the
    # camera outside the surface.
    "flagship": dict(conf=os.path.join(ROOT, "confs", "replica", "runconf_replica_2.conf"),
                     H=680, W=1200, scan_id=2, data_dir='"../Datasets/processed/Replica"',
                     n_images=2000,
                     edits=[("    flow_weight = 0.001\n",
                             "    flow_weight = 0.001\n    cam_freespace_w = 1.0\n")]),
}
# plot.resolution of the vis hook's mesh in both runs (the confs' 512³
# holds a 1.6 GB grid on the host for no more of a check)
MESH_RESOLUTION = 256
# kernels whose launches are checked on each run (every launch counter is
# reported for both)
PATH_KERNELS = {
    "demo": ("hash_encode_with_grad.fwd", "hash_encode_with_grad.bwd", "hash_encode.fwd",
             "hash_encode.bwd", "hash_encode_bf16", "composite.fwd", "composite.bwd",
             "importance_sample", "importance_sample_given", "voxels.scatter", "voxels.beta"),
    "flagship": ("hash_encode_with_grad.fwd", "hash_encode_with_grad.bwd", "hash_encode.fwd",
                 "hash_encode.bwd", "hash_encode_bf16", "weights_topk.fwd", "weights_topk.bwd",
                 "topk_rgb.fwd", "topk_rgb.bwd", "importance_sample",
                 "importance_sample_given", "voxels.scatter", "voxels.beta"),
}
# (tolerance) values: max|kernel - plain| <= VAL_RTOL * max|plain|, per
# output; gradients written with float atomics (order changes from run to
# run): ||kernel - plain||_2 <= GRAD_REL_L2 * ||plain||_2
VAL_RTOL = 1e-5
GRAD_REL_L2 = 1e-5
# importance sampler: every ray's z_vals and z_eik within Z_ATOL (float32
# scans in another order move a sample by a few ulps of z <= 3.5)
Z_ATOL = 1e-4
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM3
# rate and float32 outside the tensor cores, for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# ~1 ms of device clock cycles: longer than any wrapper's host time
SLEEP_CYCLES = 2_000_000


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_time(fn, iters=10, warmup=2, before=None):
    """Mean CUDA-event time of ``fn`` in ms, each launch timed alone on the
    device: a sleep kernel queued ahead of the start event keeps the card
    busy while the host runs the wrapper and enqueues the launch, so the
    host's time does not count; ``before`` (e.g. zeroing a gradient table)
    runs outside the timed window."""
    import torch
    for _ in range(warmup):
        if before is not None:
            before()
        fn()
    marks = []
    for _ in range(iters):
        if before is not None:
            before()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def timed_once(fn):
    """(fn(), its CUDA-event time in ms): the plain versions at the path's
    shapes run once."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def rel_l2(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the float32 rate."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Checks:
    """Kernel results by name, and the names that failed."""

    def __init__(self):
        self.results, self.failures = {}, []

    def record(self, name, source, replaces, err, ok, ms, plain_ms, bytes_, ops,
               extra="", library_ms=None):
        bound_ms, bound_by = bound(bytes_, ops)
        self.results[name] = {"name": name, "route": "cuda", "source": source,
                              "replaces": replaces, "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": library_ms,
                              "share_of_bound": bound_ms / ms, "bytes": bytes_, "ops": ops}
        lib = "" if library_ms is None else f" library {library_ms:.3f} ms"
        log(f"  {name:38s} max_abs_err {err:.3e} {extra} kernel {ms:.3f} ms plain "
            f"{plain_ms:.3f} ms{lib} bound {bound_ms:.4f} ms ({bound_by}, "
            f"{bytes_ / 1e6:.1f} MB, {ops / 1e9:.2f} Gop) share {bound_ms / ms:.1%} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)

    def values(self, name, source, replaces, kern_outs, plain_outs, ms, pms, labels,
               bytes_, ops, library_ms=None):
        """Per output: max|kernel - plain| <= VAL_RTOL * max|plain|."""
        errs = [max_abs(a, b) for a, b in zip(kern_outs, plain_outs)]
        scales = [float(b.abs().max()) for b in plain_outs]
        self.record(name, source, replaces, max(errs),
                    all(e <= VAL_RTOL * s for e, s in zip(errs, scales)), ms, pms,
                    bytes_, ops,
                    "(" + ", ".join(f"{n} {e:.2e} of {s:.2e}" for n, e, s
                                    in zip(labels, errs, scales)) + ")", library_ms)


def _sampler_rays(g, dev, R):
    """R rays from (0, 0, -0.9) into a cone along +z, unit directions."""
    import torch
    ang = torch.rand((R, 2), generator=g, device=dev)
    o = torch.stack([torch.zeros(R, device=dev), torch.zeros(R, device=dev),
                     torch.full((R,), -0.9, device=dev)], -1)
    d = torch.stack([ang[:, 0] - 0.5, ang[:, 1] - 0.5, torch.ones(R, device=dev)], -1)
    return o, d / d.norm(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def ray_points(g, dev, R, S, surface_spread=None):
    """R rays x S points, ray-major and sorted along each ray, as the path
    hands them to the hash grids: z uniform in [0.05, 1.85] (the mapping
    samples), or within about ±3·surface_spread of a surface depth per ray
    (the colour top-k samples, which crowd at the surface)."""
    import torch
    o, d = _sampler_rays(g, dev, R)
    if surface_spread is None:
        z = torch.rand((R, S), generator=g, device=dev) * 1.8 + 0.05
    else:
        z = (0.9 + 0.3 * torch.rand((R, 1), generator=g, device=dev)
             + surface_spread * torch.randn((R, S), generator=g, device=dev))
    z = torch.sort(z, dim=1)[0]
    return (o[:, None, :] + z[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()


def uniform_points(g, dev, n):
    """n points uniform in [-1.05, 1.05]^3 (some outside: zero features)."""
    import torch
    return (torch.rand((n, 3), generator=g, device=dev) * 2.1 - 1.05).contiguous()


def touched_rows(spec, x) -> int:
    """Distinct table rows that the in-range points of x read, all levels:
    the table bytes a hash kernel must move for these inputs."""
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he
    u = (x + 1.0) / 2.0
    u = u[((u >= 0) & (u <= 1)).all(-1)]
    bits = torch.tensor(he._CORNER_BITS, dtype=torch.int64, device=x.device)
    mark = torch.zeros(spec.total_entries, dtype=torch.bool, device=x.device)
    for lvl in range(spec.num_levels):
        left = torch.floor(u * spec.scales[lvl]).to(torch.int64)
        mark[he._level_rows(spec, lvl, left[None] + bits[:, None, :]).reshape(-1)] = True
    return int(mark.sum())


def hash_cost(spec, n, rows, jac, bwd):
    """(bytes, operations) of one K1/K2 launch over n points that touch
    ``rows`` table rows: each input read once, each output written once
    (the table rows read, and in the backward their gradient written);
    operations are 2 per multiply-add of the corner sums."""
    L, C = spec.num_levels, spec.level_dim
    per_pt = 3 + L * C * (1 + 3 * jac)           # x and feats (+ dfeat)
    table = rows * C
    if bwd:                                       # + g_x; table read, g_table written
        words, madds = n * (per_pt + 3) + 2 * table, C * (1 + 3 * jac) * 4
    else:
        words, madds = n * per_pt + table, C * (1 + 3 * jac)
    return 4 * words, 2 * madds * 8 * L * n


# (grid, kernel, points): the SDF grids through K1 at the flagship's 8192
# mapping rays x 98 samples, the colour grid through K2 at its top-16
# samples and at the demo's 4096 x 98; each on ray-ordered and on uniform
# points
HASH_CASES = (("fine", True, "sdf"), ("coarse", True, "sdf"),
              ("color", False, "top16"), ("color", False, "demo"))


def hash_points(g, dev, kind, order):
    R, S, spread = {"sdf": (8192, 98, None), "top16": (8192, 16, 0.02),
                    "demo": (4096, 98, None)}[kind]
    return (ray_points(g, dev, R, S, spread) if order == "ray"
            else uniform_points(g, dev, R * S))


def check_hash_kernels(dev, chk: Checks):
    """K1 (fine, coarse) and K2 (color) forward and backward at the path's
    shapes, on ray-ordered and on uniform points, each launch timed alone
    on preallocated operands; the plain versions run once."""
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    specs = hash_specs()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    src = "nicer_slam_tpu_torch/csrc/hash_encoder.cu"
    for grid, jac, kind in HASH_CASES:
        spec = specs[grid]
        L, C = spec.num_levels, spec.level_dim
        table = torch.rand((spec.total_entries, C), generator=g, device=dev) * 2 - 1
        for order in ("ray", "uniform"):
            x = hash_points(g, dev, kind, order)
            N = x.shape[0]
            rows = touched_rows(spec, x)
            tag = f"[{grid}/{kind}/{order}]"
            kname = "hash_encode_with_grad" if jac else "hash_encode"
            replaces = "nicer_slam_tpu/ops/hash_encoder.py:" + ("266" if jac else "177")
            feats = torch.empty((N, L * C), device=dev)
            dfeat = torch.empty((N, L * C, 3), device=dev) if jac else None

            def fwd():
                he.hash_encode_fwd_launch(spec, table, x, 1.0, feats, dfeat)

            fwd()
            po, pms = timed_once(lambda: he.hash_encode_plain(spec, table, x, 1.0, jac))
            po = list(po) if jac else [po]
            chk.values(f"{kname}.fwd{tag}", src, replaces,
                       [feats, dfeat] if jac else [feats], po, cuda_time(fwd), pms,
                       ("feats", "dfeat"), *hash_cost(spec, N, rows, jac, False))
            del po
            # backward: the table gradient (mapping) and the input gradient
            gf = torch.randn((N, L * C), generator=g, device=dev)
            gd = torch.randn((N, L * C, 3), generator=g, device=dev) if jac else None
            g_table = torch.empty_like(table)
            g_x = torch.empty((N, 3), device=dev)

            def bwd():
                he.hash_encode_bwd_launch(spec, table, x, 1.0, jac, gf, gd, g_table, g_x)

            # the fixed-point accumulator that the wrapper keeps: its first
            # T·C words must be zero after every launch
            acc = he.fixed_point_scratch(spec, dev)[:spec.total_entries * C]
            zero_after = []
            bwd()
            zero_after.append(not bool(acc.any()))
            xx, tt = x.clone().requires_grad_(True), table.clone().requires_grad_(True)

            def plain_bwd():
                out = he.hash_encode_plain(spec, tt, xx, 1.0, jac)
                loss = (out[0] * gf).sum() + (out[1] * gd).sum() if jac else (out * gf).sum()
                return torch.autograd.grad(loss, [xx, tt])

            (pgx, pgt), pms = timed_once(plain_bwd)
            ex, et = rel_l2(g_x, pgx), rel_l2(g_table, pgt)
            err = max(max_abs(g_x, pgx), max_abs(g_table, pgt))
            # the table gradient is summed in fixed point: run to run the same
            first = g_table.clone()
            same = True
            for _ in range(2):
                bwd()
                zero_after.append(not bool(acc.any()))
                same &= torch.equal(first, g_table)
            del first
            ms = cuda_time(bwd)
            zero_after.append(not bool(acc.any()))
            chk.record(f"{kname}.bwd{tag}", src,
                       replaces if jac else "nicer_slam_tpu/ops/hash_encoder.py:613",
                       err, ex <= GRAD_REL_L2 and et <= GRAD_REL_L2 and same
                       and all(zero_after), ms, pms,
                       *hash_cost(spec, N, rows, jac, True),
                       f"(rel L2: grad_x {ex:.2e}, grad_table {et:.2e}; {N} points, "
                       f"{rows} rows; the same over 3 launches: {same}; accumulator "
                       f"zero after each of 3 launches and after the timed ones: "
                       f"{zero_after})")
            del xx, tt, pgx, pgt, g_table, g_x, gf, gd, feats, dfeat, x, acc
            torch.cuda.empty_cache()
        del table
        torch.cuda.empty_cache()


def check_demo_kernels(dev, chk: Checks, R: int = 4096, S: int = 98, tag: str = ""):
    """K4 at the demo slice's shapes, or at the R x S that `tag` names."""
    import torch
    from nicer_slam_tpu_torch.ops import volume_rendering as vr

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cu = "nicer_slam_tpu_torch/csrc/"

    # ---- K4 composite at R x S
    z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 3.0, dim=1)[0]
    dens = torch.rand((R, S), generator=g, device=dev) * 20.0
    rgb = torch.rand((R, S, 3), generator=g, device=dev)
    nrm = torch.randn((R, S, 3), generator=g, device=dev)
    gouts = [torch.randn(s, generator=g, device=dev) for s in ((R, S), (R, 3), (R, 1), (R, 3))]
    with torch.no_grad():
        ko, po = vr.composite(z, dens, rgb, nrm), vr.composite_plain(z, dens, rgb, nrm)
        ms = cuda_time(lambda: vr.composite(z, dens, rgb, nrm))
        pms = cuda_time(lambda: vr.composite_plain(z, dens, rgb, nrm))
    chk.values(f"composite.fwd{tag}", cu + "composite.cu",
               "nicer_slam_tpu/ops/volume_rendering.py:15", ko, po, ms, pms,
               ("weights", "rgb", "depth", "normal"), nbytes(z, dens, rgb, nrm, *ko),
               R * S * 30)
    ins_k = [t.clone().requires_grad_(True) for t in (dens, rgb, nrm)]
    ins_p = [t.clone().requires_grad_(True) for t in (dens, rgb, nrm)]
    kl = sum((o * go).sum() for o, go in zip(vr.composite(z, *ins_k), gouts))
    pl = sum((o * go).sum() for o, go in zip(vr.composite_plain(z, *ins_p), gouts))
    kg = torch.autograd.grad(kl, ins_k, retain_graph=True)
    pg = torch.autograd.grad(pl, ins_p, retain_graph=True)
    errs = [rel_l2(a, b) for a, b in zip(kg, pg)]
    # the backward kernel's launch alone, on the same cotangents
    ms = cuda_time(lambda: vr._composite_bwd("composite.bwd", z, dens, rgb, nrm, *gouts))
    pms = cuda_time(lambda: torch.autograd.grad(pl, ins_p, retain_graph=True))
    chk.record(f"composite.bwd{tag}", cu + "composite.cu",
               "nicer_slam_tpu/ops/volume_rendering.py:15",
               max(max_abs(a, b) for a, b in zip(kg, pg)), max(errs) <= GRAD_REL_L2,
               ms, pms, nbytes(z, dens, rgb, nrm, *gouts, *kg), R * S * 60,
               "(rel L2 density/rgb/normals " + "/".join(f"{e:.1e}" for e in errs) + ")")


def sampler_agreement(kz, ke, pz, pe, z_pre) -> dict:
    """Two importance samplers' outputs on the same rays: a ray agrees when
    every z_vals entry and z_eik are within Z_ATOL. A ray may differ at the
    u = 1 inverse-CDF sample alone (ROADMAP queue 3: it follows the last bit
    of the cdf's total, summed in another order): every other sample
    matches within Z_ATOL (a multiset match of the rows) and the odd sample
    lies, in both, within one prepass bin below far (between the ray's
    prepass z[Ne-2] and far); such rays are counted, may be at most 1 % of
    the rays, and their z_eik is not compared. Any other difference fails."""
    err = (kz - pz).abs().amax(1)
    full = (err <= Z_ATOL) & ((ke - pe).abs()[:, 0] <= Z_ATOL)
    off = (~full).nonzero()[:, 0].tolist()
    R = kz.shape[0]
    n_u1 = 0
    if len(off) <= 0.01 * R:
        for r in off:
            if err[r] <= Z_ATOL:
                continue                        # z_vals agree, z_eik does not
            a, b = kz[r].tolist(), pz[r].tolist()
            lo, hi = float(z_pre[r, -2]) - Z_ATOL, float(z_pre[r, -1]) + Z_ATOL
            left, odd = list(b), []
            for v in a:
                k = min(range(len(left)), key=lambda i: abs(left[i] - v))
                if abs(left[k] - v) <= Z_ATOL:
                    left.pop(k)
                else:
                    odd.append(v)
            if len(odd) == 1 and len(left) == 1 and all(lo <= v <= hi for v in odd + left):
                n_u1 += 1
    n_bad = len(off) - n_u1
    return dict(ok=n_bad == 0 and n_u1 <= 0.01 * R, n_off=n_bad, n_u1=n_u1,
                max_err=float(err.max()), median_err=float(err.median()))


def _sampler_record(chk, name, kz, ke, pz, pe, z_pre, ms, pms, R, bytes_, ops, extra):
    a = sampler_agreement(kz, ke, pz, pe, z_pre)
    chk.record(name, "nicer_slam_tpu_torch/csrc/sampler.cu",
               "nicer_slam_tpu/ops/ray_sampling.py:112", a["max_err"], a["ok"], ms, pms,
               bytes_, ops,
               f"(rays off by more than {Z_ATOL:g}: {a['n_off']} of {R}, and {a['n_u1']} "
               f"at the u = 1 sample alone; median ray err {a['median_err']:.1e}; {extra})")


def shell_cache(dev, res: int = 128):
    """A [res³] density volume like a Laplace density of an SDF: a shell
    around a sphere of radius 0.6."""
    import torch
    ii = torch.linspace(-1, 1, res, device=dev)
    gx, gy, gz = torch.meshgrid(ii, ii, ii, indexing="ij")
    sdf = torch.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6
    return (80.0 * torch.sigmoid(-sdf / 0.0125)).reshape(-1).contiguous()


def sampler_inputs(g, dev, R: int):
    """K5's operands at R training rays besides the cache (jittered, 640
    prepass samples, a random perm and eikonal anchors): (cfg, o, d,
    t_rand, perm, eik)."""
    import torch
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32,
                            prepass_mode="cached", prepass_cache_res=128)
    o, d = _sampler_rays(g, dev, R)
    t_rand = torch.rand((R, 640), generator=g, device=dev)
    perm = torch.randperm(640, generator=g, device=dev)[:32]
    eik = torch.randint(0, scfg.total_samples, (R,), generator=g, device=dev)
    return scfg, o, d, t_rand, perm, eik


def given_inputs(g, dev, R: int = 2580):
    """K5 given densities at one render chunk of an eval render: the
    unjittered prepass z of R rays and the Laplace densities of a sphere's
    SDF there; (cfg, z, density, perm, eik)."""
    import torch
    from nicer_slam_tpu_torch.ops import density as dens_ops
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32)
    o, d = _sampler_rays(g, dev, R)
    zs, _, _ = rs.uniform_z_vals(scfg, o, d, None)
    sdf = (o[:, None, :] + zs[..., None] * d[:, None, :]).norm(dim=-1) - 0.6
    dens = dens_ops.laplace_density(sdf, torch.tensor(0.0125, device=dev))
    perm = torch.linspace(0, 639, 32, device=dev).to(torch.int64)
    eik = torch.zeros((R,), dtype=torch.int64, device=dev)
    return scfg, zs, dens, perm, eik


def touched_voxels(res: int, pts) -> int:
    """Distinct cache entries that the trilinear reads of the in-range
    points read: the cache bytes K5 must move for these rays."""
    import torch
    pts = pts[(pts.abs() <= 1.0).all(-1)]
    g0 = torch.floor((pts + 1.0) * (0.5 * (res - 1))).to(torch.int64).clamp(0, res - 2)
    base = (g0[:, 0] * res + g0[:, 1]) * res + g0[:, 2]
    mark = torch.zeros(res ** 3, dtype=torch.bool, device=pts.device)
    for c in range(8):
        mark[base + (c & 1) * res * res + ((c >> 1) & 1) * res + ((c >> 2) & 1)] = True
    return int(mark.sum())


# rays of the importance sampler's launches on the paths: tracking, the
# demo's mapping, the flagship's mapping; given densities: a render chunk
SAMPLER_RAYS = (1024, 4096, 8192)
GIVEN_RAYS = 2580


def check_sampler_kernels(dev, chk: Checks):
    """K5 (cached prepass) at the tracking and mapping ray counts, and K5
    given densities at one render chunk, each launch timed alone; the bound
    counts the cache by the entries these rays read."""
    import torch
    from nicer_slam_tpu_torch.ops import ray_sampling as rs

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cache = shell_cache(dev)
    whole = nbytes(cache)
    for R in SAMPLER_RAYS:
        scfg, o, d, t_rand, perm, eik = sampler_inputs(g, dev, R)
        kz, ke = rs.importance_sample(scfg, o, d, cache, t_rand, perm, eik)
        pz, pe = rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm, eik)
        ms = cuda_time(lambda: rs.importance_sample(scfg, o, d, cache, t_rand, perm, eik))
        pms = cuda_time(lambda: rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm, eik))
        z_pre = rs.uniform_z_vals(scfg, o, d, t_rand)[0]
        vox = touched_voxels(scfg.prepass_cache_res,
                             (o[:, None, :] + z_pre[..., None] * d[:, None, :]).reshape(-1, 3))
        io = nbytes(o, d, t_rand, perm, eik, kz, ke)
        # per prepass sample a trilinear read and a CDF step (~40
        # operations), per output sample a binary search
        ops = R * 640 * 40 + R * kz.shape[1] * 40
        _sampler_record(chk, f"importance_sample[{R}]", kz, ke, pz, pe, z_pre, ms, pms, R,
                        io + 4 * vox, ops,
                        f"cache by touched voxels: {vox} of {cache.numel()}; bound with the "
                        f"cache whole {bound(io + whole, ops)[0]:.4f} ms")
    del cache, t_rand
    scfg, zs, dens, perm, eik = given_inputs(g, dev, GIVEN_RAYS)
    kz, ke = rs.importance_sample_given(scfg, zs, dens, perm, eik)
    pz, pe = rs.importance_sample_given_plain(scfg, zs, dens, perm, eik)
    ms = cuda_time(lambda: rs.importance_sample_given(scfg, zs, dens, perm, eik))
    pms = cuda_time(lambda: rs.importance_sample_given_plain(scfg, zs, dens, perm, eik))
    _sampler_record(chk, f"importance_sample_given[{GIVEN_RAYS}]", kz, ke, pz, pe, zs, ms,
                    pms, GIVEN_RAYS, nbytes(zs, dens, perm, eik, kz, ke),
                    GIVEN_RAYS * 640 * 20 + GIVEN_RAYS * kz.shape[1] * 40, "no cache")


# K3's points: a density-cache build chunk (build_density_cache's
# linspace(-1, 1, 128)³ grid in its order, chunk 8 of 16), the ray-ordered
# prepass of a render chunk (2580 rays x 640 unjittered z), and as many
# uniform points
BF16_ORDERS = ("cache", "ray", "uniform")


def bf16_points(g, dev, order):
    import torch
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    if order == "cache":
        xs = torch.linspace(-1.0, 1.0, 128, device=dev)
        grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
        return grid.chunk(16)[8].contiguous()
    n_rays = GIVEN_RAYS
    if order == "uniform":
        return uniform_points(g, dev, n_rays * 640)
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32)
    o, d = _sampler_rays(g, dev, n_rays)
    zs, _, _ = rs.uniform_z_vals(scfg, o, d, None)
    return (o[:, None, :] + zs[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()


def hash_specs():
    """The flagship configuration's hash grids: the SDF grids (coarse, fine)
    and the colour grid."""
    from nicer_slam_tpu_torch.config import parse_file
    from nicer_slam_tpu_torch.models import fields
    conf = parse_file(PATHS["flagship"]["conf"]).get_config("model")
    fvs = conf.get_int("feature_vector_size")
    comb = fields.combine_config_from_conf(conf.get_config("implicit_network"), fvs)
    rend = fields.rendering_config_from_conf(conf.get_config("rendering_network"), fvs)
    return {"coarse": comb.coarse.hash_spec(), "fine": comb.fine.hash_spec(),
            "color": rend.hash_spec()}


SDF_GRIDS = ("coarse", "fine")


def density_cache_cost(res: int = 128, voxel_res: int = 64):
    """(bytes, operations) of one density-cache build (K6) of the flagship
    configuration, the least the card must do: read both SDF grids' fp32
    tables, the MLP weights and the voxel counter once, write the [res³]
    cache once; per grid point the corner sums of both grids (2 operations
    per multiply-add), both MLPs (2 per weight) and ~30 for the positional
    encoding and the density."""
    from nicer_slam_tpu_torch.config import parse_file
    from nicer_slam_tpu_torch.models import fields
    conf = parse_file(PATHS["flagship"]["conf"]).get_config("model")
    comb = fields.combine_config_from_conf(conf.get_config("implicit_network"),
                                           conf.get_int("feature_vector_size"))
    n = res ** 3
    words, per_pt = voxel_res ** 3 + n, 30
    for cfg in (comb.coarse, comb.fine):
        spec, dims = cfg.hash_spec(), cfg.layer_dims
        weights = sum(dims[i] * (dims[i + 1] - (dims[0] if i + 1 in cfg.skip_in else 0))
                      for i in range(len(dims) - 1))
        words += spec.total_entries * spec.level_dim + weights
        per_pt += 2 * spec.level_dim * 8 * spec.num_levels + 2 * weights
    return 4 * words, per_pt * n


def check_bf16_kernels(dev, chk: Checks):
    """K3 on both SDF grids, from tables rounded to bf16, at the three
    point orders of its launches; the plain version 3 times after 1."""
    import torch
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    specs = hash_specs()
    for grid in SDF_GRIDS:
        spec = specs[grid]
        table = torch.rand((spec.total_entries, spec.level_dim), generator=g, device=dev) * 2 - 1
        packed = he.pack_table_bf16(table)
        L, C = spec.num_levels, spec.level_dim
        for order in BF16_ORDERS:
            xp = bf16_points(g, dev, order)
            Np = xp.shape[0]
            ko = he.hash_encode_bf16(spec, packed, xp)
            po = he.hash_encode_bf16_plain(spec, packed, xp)
            ms = cuda_time(lambda: he.hash_encode_bf16(spec, packed, xp))
            pms = cuda_time(lambda: he.hash_encode_bf16_plain(spec, packed, xp), iters=3,
                            warmup=1)
            chk.values(f"hash_encode_bf16[{grid}/{order}]", "nicer_slam_tpu_torch/csrc/"
                       "hash_encoder.cu", "nicer_slam_tpu/ops/hash_encoder.py:858", [ko], [po],
                       ms, pms, (f"feats, bit-equal {bool(torch.equal(ko, po))}, {Np} points",),
                       nbytes(xp, ko) + touched_rows(spec, xp) * C * 2, 2 * C * 8 * L * Np)
            del ko, po, xp
        del table, packed
        torch.cuda.empty_cache()


# K7's points: a flagship mapping iteration's 8192 x 98 samples, as the
# earlier kernel was timed (70 % on a thin shell around the surface they
# crowd to, the rest anywhere, a few outside; in no order) and ray-ordered
# as the path hands them over; a tracking iteration's 1024 x 98
# ray-ordered samples; a density-cache build chunk (131,072 grid points in
# the build's order)
VOXEL_CASES = (("shell", 8192 * 98), ("ray", 8192 * 98), ("ray", 1024 * 98),
               ("cache", 131072))


def voxel_points(g, dev, kind: str, n: int):
    import torch
    if kind == "ray":
        return ray_points(g, dev, n // 98, 98)
    if kind == "cache":
        return bf16_points(g, dev, "cache")
    u = torch.randn((n, 3), generator=g, device=dev)
    shell = u / u.norm(dim=-1, keepdim=True) * (
        0.6 + 0.02 * torch.randn((n, 1), generator=g, device=dev))
    anywhere = torch.rand((n, 3), generator=g, device=dev) * 2.1 - 1.05
    pick = torch.rand((n, 1), generator=g, device=dev) < 0.7
    return torch.where(pick, shell, anywhere).contiguous()


def check_voxel_kernels(dev, chk: Checks):
    """K7's scatter and β read at VOXEL_CASES: the counter bit for bit
    (and the input counter left as it was), β within VAL_RTOL."""
    import torch
    from nicer_slam_tpu_torch.ops import density as dens_ops

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    cu = "nicer_slam_tpu_torch/csrc/"
    for kind, n in VOXEL_CASES:
        x = voxel_points(g, dev, kind, n)
        N = x.shape[0]
        tag = f"[{kind} {N}]"
        vox0 = torch.randint(0, 200, (64, 64, 64), generator=g, device=dev).to(torch.float32)
        before = vox0.clone()
        kv = dens_ops.update_voxels(vox0, x)
        pv = dens_ops.update_voxels_plain(vox0, x)
        exact, kept = bool(torch.equal(kv, pv)), bool(torch.equal(vox0, before))
        ms = cuda_time(lambda: dens_ops.update_voxels(vox0, x))
        pms = cuda_time(lambda: dens_ops.update_voxels_plain(vox0, x))
        # the library call: one accumulating index_put_ of ones at the points'
        # voxels (indices computed outside the timed call)
        vidx, boundary = dens_ops._voxel_index(x, 64)
        flat = ((vidx[:, 0] * 64 + vidx[:, 1]) * 64 + vidx[:, 2])[~boundary]
        ones, counter = torch.ones_like(flat, dtype=torch.float32), vox0.clone().view(-1)
        lib_ms = cuda_time(lambda: counter.index_put_((flat,), ones, accumulate=True))
        touched = int(torch.unique(flat).numel())
        # x read, the counter copied and scattered into (read and written once)
        chk.record(f"voxels.scatter{tag}", cu + "voxels.cu",
                   "nicer_slam_tpu/ops/density.py:61", max_abs(kv, pv), exact and kept, ms,
                   pms, nbytes(x, vox0, kv), N * 12,
                   f"(counter bit for bit: {exact}; input unchanged: {kept}; {N} points, "
                   f"{flat.numel()} inside, {touched} voxels, largest count "
                   f"{float(pv.max()):g})", library_ms=lib_ms)
        kb = dens_ops.grid_predefined_beta(kv, x)
        pb = dens_ops.grid_predefined_beta_plain(kv, x)
        ms = cuda_time(lambda: dens_ops.grid_predefined_beta(kv, x))
        pms = cuda_time(lambda: dens_ops.grid_predefined_beta_plain(kv, x))
        # x read, the counter by the voxels these points read, beta written
        chk.values(f"voxels.beta{tag}", cu + "voxels.cu", "nicer_slam_tpu/ops/density.py:46",
                   [kb], [pb], ms, pms, (f"beta, {touched} voxels read",),
                   nbytes(x, kb) + 4 * touched, N * 20)
        del x, vox0, before, kv, pv, vidx, boundary, flat, ones, counter, kb, pb


# rays of the colour top-k launches on the flagship path: tracking (1000
# launches per run) and mapping (300)
TOPK_RAYS = (1024, 8192)


def surface_densities(g, dev, z, beta: float = 3e-3):
    """The Laplace density of an SDF that crosses zero at a random depth per
    ray (beta 3e-3): most weights are exact zeros or subnormals, and many
    rays have fewer than 16 non-zero weights, so the tie rule decides their
    last picks."""
    import torch
    from nicer_slam_tpu_torch.ops import density as dens_ops
    surf = 0.3 + 2.4 * torch.rand((z.shape[0], 1), generator=g, device=dev)
    return dens_ops.laplace_density(surf - z, torch.tensor(beta, device=dev)).contiguous()


# shapes the path does not give the top-k kernels, each holding other code
# of them: 200 samples (the weights pass and its backward at 32 rounds),
# Kc 40 (the backward's picks past the first 32, the colour composite's
# loop over chunks of 32) and Kc 12 (colour groups of 16 lanes, 4 idle)
TOPK_GENERAL = ((64, 200, 40), (64, 98, 12))


def check_topk_kernels(dev, chk: Checks, S: int = 98, Kc: int = 16):
    """K4 with colour top-k at the flagship configuration's shapes: the
    weights pass forward and backward and the top-k colour composite at the
    tracking and mapping ray counts (random densities), and the weights
    pass on surface-like densities at 8192 rays; then all of them at the
    TOPK_GENERAL shapes."""
    import torch
    from nicer_slam_tpu_torch.ops import volume_rendering as vr

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    src = "nicer_slam_tpu_torch/csrc/composite.cu"
    cases = ([(R, S, Kc, "random", f"[{R}]") for R in TOPK_RAYS]
             + [(TOPK_RAYS[-1], S, Kc, "surface", f"[surface {TOPK_RAYS[-1]}]")]
             + [(R, S_, K_, "random", f"[general {R}x{S_} Kc{K_}]")
                for R, S_, K_ in TOPK_GENERAL])
    for R, S, Kc, kind, tag in cases:
        z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 3.0, dim=1)[0]
        dens = (torch.rand((R, S), generator=g, device=dev) * 20.0 if kind == "random"
                else surface_densities(g, dev, z))
        nrm = torch.randn((R, S, 3), generator=g, device=dev)
        with torch.no_grad():
            ko = vr.weights_topk(z, dens, nrm, Kc)
            po = vr.weights_topk_plain(z, dens, nrm, Kc)
            ms = cuda_time(lambda: vr.weights_topk(z, dens, nrm, Kc))
            pms = cuda_time(lambda: vr.weights_topk_plain(z, dens, nrm, Kc))
            lib_ms = cuda_time(lambda: torch.topk(po[0], Kc, dim=1))
        # the picks through the plain weights: equal values whatever order
        # ties take
        picked_k = po[0].reshape(-1)[ko[5].reshape(-1)].reshape(R, Kc)
        n_diff = int((ko[5] != po[5]).any(1).sum())
        sparse = int(((po[0] > 0).sum(1) < Kc).sum())
        chk.values(f"weights_topk.fwd{tag}", src, "nicer_slam_tpu/models/scene_model.py:321",
                   list(ko[:5]) + [picked_k], list(po[:5]) + [po[3]], ms, pms,
                   ("weights", "depth", "normal", "topk_w", "wsum",
                    f"picked plain weights ({n_diff} rays pick other indices; {sparse} "
                    f"rays with fewer than {Kc} non-zero weights; library = torch.topk, "
                    f"pick only)"),
                   nbytes(z, dens, nrm, *ko), R * S * (30 + Kc), library_ms=lib_ms)
        # the backward: autograd through the kernel's weights pass, cotangents
        # on all five outputs, against the closed form at the kernel's picks
        picks = ko[5]
        cots = [torch.randn(t.shape, generator=g, device=dev) for t in ko[:5]]
        gw, gdep, gn, gtw, gws = cots
        ins = [t.clone().requires_grad_(True) for t in (dens, nrm)]
        kg = torch.autograd.grad(vr.weights_topk(z, *ins, Kc)[:5], ins, cots)
        pg = vr.weights_topk_bwd_plain(z, dens, nrm, picks, *cots)
        errs = [rel_l2(a, b) for a, b in zip(kg, pg)]
        # the launch alone with the path's cotangents (nothing reads the
        # weights with a gradient: g_weights is None)
        ms = cuda_time(lambda: vr._composite_bwd("weights_topk.bwd", z, dens, None, nrm, None,
                                                 None, gdep, gn, picks, gtw, gws))
        pms = cuda_time(lambda: vr.weights_topk_bwd_plain(z, dens, nrm, picks, None, gdep, gn,
                                                          gtw, gws))
        chk.record(f"weights_topk.bwd{tag}", src, "nicer_slam_tpu/models/scene_model.py:321",
                   max(max_abs(a, b) for a, b in zip(kg, pg)), max(errs) <= GRAD_REL_L2,
                   ms, pms, nbytes(z, dens, nrm, gdep, gn, picks, gtw, gws, *kg), R * S * 50,
                   "(rel L2 density/normals " + "/".join(f"{e:.1e}" for e in errs)
                   + "; timed with the path's cotangents, g_weights None)")
        del kg, pg, ins, cots, gw
        if kind == "surface":
            continue
        topk_w, wsum = po[3].contiguous(), po[4].contiguous()
        rgb = torch.rand((R, Kc, 3), generator=g, device=dev)
        with torch.no_grad():
            ko = vr.topk_rgb(topk_w, wsum, rgb)
            po = vr.topk_rgb_plain(topk_w, wsum, rgb)
            ms = cuda_time(lambda: vr.topk_rgb(topk_w, wsum, rgb))
            pms = cuda_time(lambda: vr.topk_rgb_plain(topk_w, wsum, rgb))
        chk.values(f"topk_rgb.fwd{tag}", src, "nicer_slam_tpu/models/scene_model.py:338",
                   [ko], [po], ms, pms, ("rgb",), nbytes(topk_w, wsum, rgb, ko), R * Kc * 8)
        go = torch.randn((R, 3), generator=g, device=dev)
        ins_k = [t.clone().requires_grad_(True) for t in (topk_w, wsum, rgb)]
        ins_p = [t.clone().requires_grad_(True) for t in (topk_w, wsum, rgb)]
        kl = (vr.topk_rgb(*ins_k) * go).sum()
        pl = (vr.topk_rgb_plain(*ins_p) * go).sum()
        kg = torch.autograd.grad(kl, ins_k, retain_graph=True)
        pg = torch.autograd.grad(pl, ins_p, retain_graph=True)
        ms = cuda_time(lambda: vr._topk_rgb_bwd(topk_w, wsum, rgb, go))
        pms = cuda_time(lambda: torch.autograd.grad(pl, ins_p, retain_graph=True))
        chk.values(f"topk_rgb.bwd{tag}", src, "nicer_slam_tpu/models/scene_model.py:338",
                   kg, pg, ms, pms, ("g_topk_w", "g_wsum", "g_rgb"),
                   nbytes(topk_w, wsum, rgb, go, *kg), R * Kc * 12)


# ---------------------------------------------------------------------------
# phases 4-5: the SLAM main paths
# ---------------------------------------------------------------------------

def scene_dir(kind: str) -> str:
    p = PATHS[kind]
    return os.path.join(SMOKE_DIR, f"Synthetic_{kind}_{p['H']}x{p['W']}")


def write_scene(kind: str) -> None:
    """Generate one run's synthetic scan (run in a child process)."""
    from nicer_slam_tpu_torch.datasets.synthetic import generate
    p, data_dir = PATHS[kind], scene_dir(kind)
    shutil.rmtree(data_dir, ignore_errors=True)
    generate(data_dir, scan_id=p["scan_id"], n_frames=N_FRAMES, H=p["H"], W=p["W"],
             keyframe_every=10, with_flow=True)
    open(os.path.join(data_dir, "complete"), "w").close()


def start_scenes():
    """One child process per missing scan; returns {kind: Popen}."""
    procs = {}
    for kind in PATHS:
        if not os.path.exists(os.path.join(scene_dir(kind), "complete")):
            os.makedirs(SMOKE_DIR, exist_ok=True)
            procs[kind] = subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.write_scene({kind!r})"],
                cwd=ROOT)
    return procs


def wait_scene(procs, kind: str) -> str:
    if kind in procs:
        rc = procs[kind].wait()
        if rc != 0:
            raise RuntimeError(f"generating the {kind} scan failed ({rc})")
    return scene_dir(kind)


def write_conf(kind: str, data_dir: str, n_frames: int = N_FRAMES) -> str:
    p = PATHS[kind]
    text = open(p["conf"]).read()
    edits = [(f"data_dir = {p['data_dir']}", f'data_dir = "{data_dir}"'),
             (f"n_images = {p['n_images']}", f"n_images = {n_frames}"),
             ("mapping_every_frame = 5\n", "mapping_every_frame = 5\n"
              f"        global_window_start = {GLOBAL_WINDOW_START}\n"),
             ("resolution = 512", f"resolution = {MESH_RESOLUTION}")] + p["edits"]
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{kind} conf edit failed ({old!r})")
        text = text.replace(old, new)
    if f"img_res = [\n        {p['H']}\n        {p['W']}\n    ]" not in text:
        raise RuntimeError(f"{kind} conf: unexpected img_res")
    path = os.path.join(SMOKE_DIR, f"{kind}_{n_frames}_smoke.conf")
    with open(path, "w") as f:
        f.write(text)
    return path


def run_slam(dev, kind: str, data_dir: str):
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.training import exp_runner

    conf = write_conf(kind, data_dir)
    exps = os.path.join(SMOKE_DIR, f"exps_{kind}")
    shutil.rmtree(exps, ignore_errors=True)
    map_terms, flow_edges = {}, {}

    def hook(runner, frame_idx):
        if frame_idx % runner.mapping_every_frame == 0:
            map_terms[frame_idx] = runner.last_map_terms
            edges = runner._edge_refs
            flow_edges[frame_idx] = 0 if edges is None else int(edges[0].numel())

    # the CLI entry point, as a user runs it; counts and peak memory cover
    # set-up (model init, first density cache), the 11 frames and the vis hook
    argv = ["--conf", conf, "--root_dir", SMOKE_DIR, "--exps_folder", f"exps_{kind}",
            "--device", str(dev)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launch_counts()
    t_run = time.perf_counter()
    runner = exp_runner.main(argv, frame_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    errs = {i: float(np.linalg.norm(runner.est_pose_all[i][:3, 3]
                                    - runner.dataset.gt_pose_all[i][:3, 3]))
            for i in range(N_FRAMES)}
    summ = runner.timer.summary()
    # the runner's phases are disjoint: tracking = track_frame, mapping =
    # map_step, cache = density-cache builds, frames = loading + staging a
    # frame, checkpoint = the npz writes, vis = the vis hook; "other" is the
    # rest of the loop. s/frame leaves out the one vis call after the loop.
    phase_s = {k: v["total_s"] for k, v in summ.items()}
    stats = {
        "setup_s": wall - runner.run_s,
        "s_per_frame": (runner.run_s - phase_s.get("vis", 0.0)) / N_FRAMES,
        "ms_per_track_iter": 1000 * phase_s["tracking"]
        / (summ["tracking"]["count"] * runner.num_cam_iters),
        "ms_per_map_iter": summ["mapping"]["mean_ms"],
        "cache_builds": summ["cache"]["count"],
        "ms_per_cache_build": summ["cache"]["mean_ms"],
        **{f"{k}_s": v for k, v in phase_s.items()},
        "other_s": runner.run_s - sum(phase_s.values()),
        "peak_mem_GiB": peak / 2 ** 30,
    }
    # the run's own outputs: the final model checkpoint holds the model, and
    # vis/ holds the panels and the mesh
    from nicer_slam_tpu_torch.slam.checkpoint import params_to_numpy
    ck = runner.checkpoints_path
    for sub in ("ModelParameters", "OptimizerParameters", "PoseParameters"):
        if not os.path.exists(os.path.join(ck, sub, "latest.npz")):
            raise RuntimeError(f"missing checkpoint {sub}")
    with np.load(os.path.join(ck, "ModelParameters", "latest.npz")) as saved:
        for k, v in params_to_numpy(runner.model).items():
            if not np.array_equal(saved["model_state_dict/" + k], v):
                raise RuntimeError(f"checkpoint differs from the model at {k}")
    vis = sorted(os.listdir(runner.plots_dir))
    return dict(runner=runner, map_terms=map_terms, flow_edges=flow_edges, errs=errs,
                counts=counts, stats=stats, vis=vis)


# the repeat phase: the demo path's first frames (mapping at 0 and 5), twice
REPEAT_FRAMES = 6


def repeat_once(dev, data_dir: str, tag: str) -> dict:
    """The demo configuration for REPEAT_FRAMES frames through the
    runner's own loop (no checkpoint writes, no vis hook): the per-frame
    poses, the last loss terms of each mapping call, and the final model
    and voxel tensors (on the card)."""
    import numpy as np
    from nicer_slam_tpu_torch.slam import runner as runner_mod

    r = runner_mod.SLAMRunner(conf=write_conf("demo", data_dir, REPEAT_FRAMES),
                              root_dir=SMOKE_DIR, exps_folder_name=f"exps_repeat_{tag}",
                              quiet=True, device=str(dev))
    terms = {}
    for f in range(r.n_images):
        r._stage_frame(f)
        r.track(f)
        if f % r.mapping_every_frame == 0:
            terms[f] = {k: v.detach().clone() for k, v in r.map(f).items()}
    state = {k: v.detach().clone() for k, v in r.model.state_dict().items()}
    state["voxels"] = r.voxels.detach().clone()
    return dict(poses={f: np.array(r.est_pose_all[f]) for f in range(r.n_images)},
                terms=terms, state=state)


def same_bits(a, b) -> bool:
    """Two tensors or arrays equal bit for bit (NaNs included)."""
    import numpy as np
    import torch
    if isinstance(a, torch.Tensor):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def check_repeat(dev, data_dir: str, failures) -> None:
    """Runs repeat_once twice in this process; every pose, loss term,
    model tensor and the voxel counter must come out the same bit for
    bit."""
    import torch
    runs = []
    for i in range(2):
        t = time.perf_counter()
        runs.append(repeat_once(dev, data_dir, str(i)))
        log(f"  run {i}: {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
    a, b = runs
    diff = [f"pose {f}" for f in a["poses"] if not same_bits(a["poses"][f], b["poses"][f])]
    diff += [f"frame-{f} {k}" for f in a["terms"] for k in a["terms"][f]
             if not same_bits(a["terms"][f][k], b["terms"][f][k])]
    diff += [k for k in a["state"] if not same_bits(a["state"][k], b["state"][k])]
    n = len(a["poses"]) + sum(map(len, a["terms"].values())) + len(a["state"])
    for f, terms in a["terms"].items():
        log(f"  frame-{f} mapping call, run 0: "
            + " ".join(f"{k}={float(v):.9g}" for k, v in terms.items()))
    log(f"  {n - len(diff)} of {n} compared values the same bit for bit "
        f"({len(a['poses'])} poses, {sum(map(len, a['terms'].values()))} loss terms, "
        f"{len(a['state'])} model and voxel tensors)" + (f"; differ: {diff}" if diff else ""))
    if diff:
        failures.append(f"repeat: two runs of the demo path differ at {diff}")


def report(kind: str, r, failures) -> None:
    import torch
    from nicer_slam_tpu_torch.utils.ply import read_ply

    log("  translation error vs GT per frame: "
        + " ".join(f"{i}:{e:.4f}" for i, e in r["errs"].items()))
    for f, terms in r["map_terms"].items():
        log(f"  loss terms, last iteration of the frame-{f} mapping call "
            f"({r['flow_edges'][f]} flow edges): "
            + " ".join(f"{k}={float(v):.5g}" for k, v in terms.items()))
    log("  launches: " + " ".join(f"{k}={v}" for k, v in r["counts"].items()))
    log("  " + " ".join(f"{k}={v:.4g}" for k, v in r["stats"].items()))
    log(f"  vis/: {' '.join(r['vis'])}")
    bad = [(f, k) for f, terms in r["map_terms"].items() for k, v in terms.items()
           if not torch.isfinite(v).all()]
    if bad:
        failures.append(f"{kind}: non-finite loss terms {bad}")
    if not all(map(lambda e: e == e and e < 1e3, r["errs"].values())):
        failures.append(f"{kind}: non-finite poses")
    last = max(r["map_terms"])
    terms = r["map_terms"][last]
    if r["flow_edges"][last] == 0 or not float(terms["flow_loss"]) > 0:
        failures.append(f"{kind}: the frame-{last} mapping call ran without live flow edges")
    if kind == "flagship" and not (torch.isfinite(terms["warp_loss"])
                                   and float(terms["warp_loss"]) > 0):
        failures.append(f"{kind}: warp_loss of the frame-{last} mapping call is "
                        f"{float(terms['warp_loss'])}, not finite and positive")
    never = [k for k in PATH_KERNELS[kind] if r["counts"][k] == 0]
    if never:
        failures.append(f"{kind}: kernels never launched on the main path: {never}")
    pngs = [v for v in r["vis"] if v.startswith("rendering_") and v.endswith(".png")]
    plys = [v for v in r["vis"] if v.startswith("surface_") and v.endswith(".ply")]
    if not pngs or not plys:
        failures.append(f"{kind}: vis/ holds no rendering_*.png or no surface_*.ply")
    else:
        mesh = read_ply(os.path.join(r["runner"].plots_dir, plys[-1]))
        log(f"  mesh {plys[-1]}: {len(mesh['verts'])} vertices, {len(mesh['faces'])} faces")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    from nicer_slam_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[1/7] card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    procs = start_scenes()
    try:
        t = time.perf_counter()
        path = _cuda.build()
        _cuda.library()
        log(f"[2/7] build: {os.path.relpath(path, ROOT)} in {time.perf_counter() - t:.1f} s")

        log(f"[3/7] kernels vs plain versions (tolerance: values {VAL_RTOL:g}·max|ref| "
            f"per output, atomic gradients rel L2 {GRAD_REL_L2:g}, sampler {Z_ATOL:g} "
            f"on every ray, the voxel counter bit for bit); each kernel's launch "
            f"alone, mean of 10 after 2; the plain versions of K1/K2 once; bounds at "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s and {FP32_OPS_PER_S / 1e12:g} "
            f"TFLOP/s float32; card {card}")
        chk = Checks()
        check_hash_kernels(dev, chk)
        check_demo_kernels(dev, chk)
        # the backward at 32 rounds (S > 128), with colour
        check_demo_kernels(dev, chk, 64, 200, "[general 64x200]")
        check_voxel_kernels(dev, chk)
        check_topk_kernels(dev, chk)
        check_bf16_kernels(dev, chk)
        check_sampler_kernels(dev, chk)
        b_bytes, b_ops = density_cache_cost()
        log(f"  K6 density-cache build (128³, not one kernel): bound "
            f"{bound(b_bytes, b_ops)[0]:.4f} ms ({bound(b_bytes, b_ops)[1]}, "
            f"{b_bytes / 1e6:.1f} MB, {b_ops / 1e9:.2f} Gop)")
        torch.cuda.empty_cache()

        runs = {}
        for step, kind in ((4, "demo"), (5, "flagship")):
            t = time.perf_counter()
            data_dir = wait_scene(procs, kind)
            p = PATHS[kind]
            log(f"[{step}/7] SLAM main path: {kind} configuration, {N_FRAMES} frames, "
                f"{p['H']}x{p['W']}, global_window_start {GLOBAL_WINDOW_START} "
                f"(waited {time.perf_counter() - t:.1f} s for the scan)")
            runs[kind] = run_slam(dev, kind, data_dir)
            torch.cuda.empty_cache()
        log(f"[6/7] repeat: the demo configuration twice in this process, "
            f"{REPEAT_FRAMES} frames each (mapping at frames 0 and 5), same seed and scan")
        repeat_failures = []
        check_repeat(dev, wait_scene(procs, "demo"), repeat_failures)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    log("[7/7] report (card: " + card + ")")
    failures = list(chk.failures) + repeat_failures
    for kind, r in runs.items():
        log(f" {kind}:")
        report(kind, r, failures)

    kernels = []
    for name, r in chk.results.items():
        base = name.split("[")[0]
        by_path = {kind: r_["counts"][base] for kind, r_ in runs.items()}
        kernels.append(dict(r, launches=sum(by_path.values()), launches_by_path=by_path))
    log(json.dumps({"kernels": kernels}))
    log(card)
    if failures:
        print(f"chip_smoke FAILED: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
