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
     alone (on preallocated operands; a gradient table is zeroed outside
     the timed window) and of the plain version, and the kernel's bound
     (the bytes it must move over the card's memory rate, or its
     operations over the float32 rate, whichever is larger): K1 and K2 at
     the flagship path's shapes on ray-ordered and on uniform points
     (802,816 SDF points through the fine and coarse grids; the full
     133M-entry colour grid at the 131,072 top-16 points and at the demo's
     4096 x 98), K4 and K5 at the demo slice's shapes, the flagship
     kernels at the flagship configuration's (8192 mapping rays x 98
     samples, colour top-16, the exact prepass of a 2580-ray render chunk
     = 1,651,200 points). The plain versions of K1/K2 run once.
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
  6. report: per run, translation error against GT per frame, the loss
     terms of each mapping call's last iteration, launch counts, s/frame,
     ms per track and map iteration, the runner's phase times, peak memory;
     the final model checkpoint is read back and held against the model;
     vis/ must hold rendering_*.png and surface_*.ply. Then one JSON line
     with every kernel, the nvidia-smi line, and the result line.

Float32 matmuls run without TF32 (set explicitly below). Scratch data goes
to build/smoke/ inside the checkout.
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
             "hash_encode.bwd", "composite.fwd", "composite.bwd", "importance_sample"),
    "flagship": ("hash_encode_with_grad.fwd", "hash_encode_with_grad.bwd", "hash_encode.fwd",
                 "hash_encode.bwd", "hash_encode_bf16", "weights_topk.fwd", "weights_topk.bwd",
                 "topk_rgb.fwd", "topk_rgb.bwd", "importance_sample_given", "voxels.scatter",
                 "voxels.beta"),
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
    from nicer_slam_tpu_torch.models import fields
    from nicer_slam_tpu_torch.ops import hash_encoder as he
    from nicer_slam_tpu_torch.config import parse_file

    conf = parse_file(PATHS["flagship"]["conf"]).get_config("model")
    fvs = conf.get_int("feature_vector_size")
    comb = fields.combine_config_from_conf(conf.get_config("implicit_network"), fvs)
    rend = fields.rendering_config_from_conf(conf.get_config("rendering_network"), fvs)
    specs = {"fine": comb.fine.hash_spec(), "coarse": comb.coarse.hash_spec(),
             "color": rend.hash_spec()}
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
            g_table = torch.zeros_like(table)
            g_x = torch.empty((N, 3), device=dev)

            def bwd():
                he.hash_encode_bwd_launch(spec, table, x, 1.0, jac, gf, gd, g_table, g_x)

            bwd()
            xx, tt = x.clone().requires_grad_(True), table.clone().requires_grad_(True)

            def plain_bwd():
                out = he.hash_encode_plain(spec, tt, xx, 1.0, jac)
                loss = (out[0] * gf).sum() + (out[1] * gd).sum() if jac else (out * gf).sum()
                return torch.autograd.grad(loss, [xx, tt])

            (pgx, pgt), pms = timed_once(plain_bwd)
            ex, et = rel_l2(g_x, pgx), rel_l2(g_table, pgt)
            err = max(max_abs(g_x, pgx), max_abs(g_table, pgt))
            ms = cuda_time(bwd, before=g_table.zero_)
            chk.record(f"{kname}.bwd{tag}", src,
                       replaces if jac else "nicer_slam_tpu/ops/hash_encoder.py:613",
                       err, ex <= GRAD_REL_L2 and et <= GRAD_REL_L2, ms, pms,
                       *hash_cost(spec, N, rows, jac, True),
                       f"(rel L2: grad_x {ex:.2e}, grad_table {et:.2e}; {N} points, "
                       f"{rows} rows)")
            del xx, tt, pgx, pgt, g_table, g_x, gf, gd, feats, dfeat, x
            torch.cuda.empty_cache()
        del table
        torch.cuda.empty_cache()


def check_demo_kernels(dev, chk: Checks, R: int = 4096):
    """K4 and K5 (cached prepass) at the demo slice's shapes."""
    import torch
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    from nicer_slam_tpu_torch.ops import volume_rendering as vr

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    S, Ne = 98, 640
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
    chk.values("composite.fwd", cu + "composite.cu",
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
    chk.record("composite.bwd", cu + "composite.cu",
               "nicer_slam_tpu/ops/volume_rendering.py:15",
               max(max_abs(a, b) for a, b in zip(kg, pg)), max(errs) <= GRAD_REL_L2,
               ms, pms, nbytes(z, dens, rgb, nrm, *gouts, *kg), R * S * 60,
               "(rel L2 density/rgb/normals " + "/".join(f"{e:.1e}" for e in errs) + ")")

    # ---- K5 importance sampler at R rays, Ne = 640 prepass samples
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=Ne, N_samples_extra=32,
                            prepass_mode="cached", prepass_cache_res=128)
    res = scfg.prepass_cache_res
    ii = torch.linspace(-1, 1, res, device=dev)
    gx, gy, gz = torch.meshgrid(ii, ii, ii, indexing="ij")
    # a shell density (sphere of radius 0.6) like a Laplace density of an SDF
    sdf = torch.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6
    cache = (80.0 * torch.sigmoid(-sdf / 0.0125)).reshape(-1).contiguous()
    o, d = _sampler_rays(g, dev, R)
    t_rand = torch.rand((R, Ne), generator=g, device=dev)
    perm = torch.randperm(Ne, generator=g, device=dev)[:32]
    eik = torch.randint(0, scfg.total_samples, (R,), generator=g, device=dev)
    kz, ke = rs.importance_sample(scfg, o, d, cache, t_rand, perm, eik)
    pz, pe = rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm, eik)
    ms = cuda_time(lambda: rs.importance_sample(scfg, o, d, cache, t_rand, perm, eik))
    pms = cuda_time(lambda: rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm, eik))
    # the cache counted whole; per prepass sample a trilinear read and a
    # CDF step (~40 operations), per output sample a binary search
    _sampler_record(chk, "importance_sample", kz, ke, pz, pe, ms, pms, R,
                    nbytes(o, d, cache, t_rand, perm, eik, kz, ke),
                    R * Ne * 40 + R * kz.shape[1] * 40)


def _sampler_record(chk, name, kz, ke, pz, pe, ms, pms, R, bytes_, ops):
    ray_ok = ((kz - pz).abs().amax(1) <= Z_ATOL) & ((ke - pe).abs()[:, 0] <= Z_ATOL)
    n_off = int((~ray_ok).sum())
    chk.record(name, "nicer_slam_tpu_torch/csrc/sampler.cu",
               "nicer_slam_tpu/ops/ray_sampling.py:112", max_abs(kz, pz), n_off == 0, ms, pms,
               bytes_, ops,
               f"(rays off by more than {Z_ATOL:g}: {n_off} of {R}; median ray err "
               f"{float((kz - pz).abs().amax(1).median()):.1e})")


def check_flagship_kernels(dev, chk: Checks, R: int = 8192, S: int = 98, Kc: int = 16,
                           R_render: int = 2580):
    """K7, K3, K4 with colour top-k and K5 given densities at the flagship
    configuration's shapes."""
    import torch
    from nicer_slam_tpu_torch.models import fields
    from nicer_slam_tpu_torch.ops import density as dens_ops
    from nicer_slam_tpu_torch.ops import hash_encoder as he
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    from nicer_slam_tpu_torch.ops import volume_rendering as vr
    from nicer_slam_tpu_torch.config import parse_file

    conf = parse_file(PATHS["flagship"]["conf"]).get_config("model")
    comb = fields.combine_config_from_conf(conf.get_config("implicit_network"),
                                           conf.get_int("feature_vector_size"))
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    N = R * S
    cu = "nicer_slam_tpu_torch/csrc/"

    # ---- K7: 802,816 points per mapping iteration, most on a thin shell
    # (the surface the samples crowd to), the rest anywhere, a few outside
    u = torch.randn((N, 3), generator=g, device=dev)
    shell = u / u.norm(dim=-1, keepdim=True) * (
        0.6 + 0.02 * torch.randn((N, 1), generator=g, device=dev))
    anywhere = torch.rand((N, 3), generator=g, device=dev) * 2.1 - 1.05
    pick = torch.rand((N, 1), generator=g, device=dev) < 0.7
    x = torch.where(pick, shell, anywhere).contiguous()
    vox0 = torch.randint(0, 200, (64, 64, 64), generator=g, device=dev).to(torch.float32)
    kv = dens_ops.update_voxels(vox0, x)
    pv = dens_ops.update_voxels_plain(vox0, x)
    exact = bool(torch.equal(kv, pv))
    ms = cuda_time(lambda: dens_ops.update_voxels(vox0, x))
    pms = cuda_time(lambda: dens_ops.update_voxels_plain(vox0, x))
    # the library call: one accumulating index_put_ of ones at the points'
    # voxels (indices computed outside the timed call)
    vidx, boundary = dens_ops._voxel_index(x, 64)
    flat = ((vidx[:, 0] * 64 + vidx[:, 1]) * 64 + vidx[:, 2])[~boundary]
    ones, counter = torch.ones_like(flat, dtype=torch.float32), vox0.clone().view(-1)
    lib_ms = cuda_time(lambda: counter.index_put_((flat,), ones, accumulate=True))
    # x read, the counter copied and scattered into (read and written once)
    chk.record("voxels.scatter", cu + "voxels.cu", "nicer_slam_tpu/ops/density.py:61",
               max_abs(kv, pv), exact, ms, pms, nbytes(x, vox0, kv), N * 12,
               f"(counter bit for bit: {exact}; {N} points, largest count {float(pv.max()):g})",
               library_ms=lib_ms)
    del vidx, boundary, flat, ones, counter
    kb = dens_ops.grid_predefined_beta(kv, x)
    pb = dens_ops.grid_predefined_beta_plain(kv, x)
    ms = cuda_time(lambda: dens_ops.grid_predefined_beta(kv, x))
    pms = cuda_time(lambda: dens_ops.grid_predefined_beta_plain(kv, x))
    chk.values("voxels.beta", cu + "voxels.cu", "nicer_slam_tpu/ops/density.py:46",
               [kb], [pb], ms, pms, ("beta",), nbytes(x, kv, kb), N * 20)
    del u, shell, anywhere, pick, kv, pv, kb, pb

    # ---- K3 on both SDF grids at one render chunk's prepass (1,651,200
    # points), from tables rounded to bf16
    Np = R_render * 640
    xp = (torch.rand((Np, 3), generator=g, device=dev) * 2.1 - 1.05).contiguous()
    for grid, spec in (("coarse", comb.coarse.hash_spec()), ("fine", comb.fine.hash_spec())):
        table = torch.rand((spec.total_entries, spec.level_dim), generator=g, device=dev) * 2 - 1
        packed = he.pack_table_bf16(table)
        L, C = spec.num_levels, spec.level_dim
        ko = he.hash_encode_bf16(spec, packed, xp)
        po = he.hash_encode_bf16_plain(spec, packed, xp)
        ms = cuda_time(lambda: he.hash_encode_bf16(spec, packed, xp))
        pms = cuda_time(lambda: he.hash_encode_bf16_plain(spec, packed, xp), iters=3, warmup=1)
        chk.values(f"hash_encode_bf16[{grid}]", cu + "hash_encoder.cu",
                   "nicer_slam_tpu/ops/hash_encoder.py:858", [ko], [po], ms, pms, ("feats",),
                   nbytes(xp, ko) + touched_rows(spec, xp) * C * 2, 2 * C * 8 * L * Np)
        del table, packed, ko, po
    del xp
    torch.cuda.empty_cache()

    # ---- K4 weights pass with the top-16 picks, and the top-k colour
    # composite, at 8192 x 98
    z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 3.0, dim=1)[0]
    dens = torch.rand((R, S), generator=g, device=dev) * 20.0
    nrm = torch.randn((R, S, 3), generator=g, device=dev)
    with torch.no_grad():
        ko = vr.weights_topk(z, dens, nrm, Kc)
        po = vr.weights_topk_plain(z, dens, nrm, Kc)
        ms = cuda_time(lambda: vr.weights_topk(z, dens, nrm, Kc))
        pms = cuda_time(lambda: vr.weights_topk_plain(z, dens, nrm, Kc))
    # the picks through the plain weights: equal values whatever order ties
    # take (exact zeros behind an opaque sample)
    picked_k = torch.gather(po[0], 1, ko[3])
    picked_p = torch.gather(po[0], 1, po[3])
    n_diff = int((ko[3] != po[3]).any(1).sum())
    chk.values("weights_topk.fwd", cu + "composite.cu",
               "nicer_slam_tpu/models/scene_model.py:321",
               list(ko[:3]) + [picked_k], list(po[:3]) + [picked_p], ms, pms,
               ("weights", "depth", "normal", f"picked weights ({n_diff} rays pick "
                                                f"other indices)"),
               nbytes(z, dens, nrm, *ko), R * S * (30 + Kc))
    idx = po[3]
    gw = torch.randn((R, S), generator=g, device=dev)
    gdep = torch.randn((R, 1), generator=g, device=dev)
    gn = torch.randn((R, 3), generator=g, device=dev)
    ins_k = [t.clone().requires_grad_(True) for t in (dens, nrm)]
    ins_p = [t.clone().requires_grad_(True) for t in (dens, nrm)]
    ok_ = vr.weights_topk(z, ins_k[0], ins_k[1], Kc)
    op_ = vr.weights_topk_plain(z, ins_p[0], ins_p[1], Kc)
    kl = (ok_[0] * gw).sum() + (ok_[1] * gdep).sum() + (ok_[2] * gn).sum()
    pl = (op_[0] * gw).sum() + (op_[1] * gdep).sum() + (op_[2] * gn).sum()
    kg = torch.autograd.grad(kl, ins_k, retain_graph=True)
    pg = torch.autograd.grad(pl, ins_p, retain_graph=True)
    errs = [rel_l2(a, b) for a, b in zip(kg, pg)]
    # the backward kernel's launch alone, on the same cotangents
    ms = cuda_time(lambda: vr._composite_bwd("weights_topk.bwd", z, dens, None, nrm, gw,
                                             None, gdep, gn))
    pms = cuda_time(lambda: torch.autograd.grad(pl, ins_p, retain_graph=True))
    chk.record("weights_topk.bwd", cu + "composite.cu",
               "nicer_slam_tpu/models/scene_model.py:321",
               max(max_abs(a, b) for a, b in zip(kg, pg)), max(errs) <= GRAD_REL_L2, ms, pms,
               nbytes(z, dens, nrm, gw, gdep, gn, *kg), R * S * 50,
               "(rel L2 density/normals " + "/".join(f"{e:.1e}" for e in errs) + ")")
    with torch.no_grad():
        w = po[0]
        topk_w = torch.gather(w, 1, idx).contiguous()
        wsum = w.sum(1, keepdim=True)
    rgb = torch.rand((R, Kc, 3), generator=g, device=dev)
    with torch.no_grad():
        ko = vr.topk_rgb(topk_w, wsum, rgb)
        po = vr.topk_rgb_plain(topk_w, wsum, rgb)
        ms = cuda_time(lambda: vr.topk_rgb(topk_w, wsum, rgb))
        pms = cuda_time(lambda: vr.topk_rgb_plain(topk_w, wsum, rgb))
    chk.values("topk_rgb.fwd", cu + "composite.cu", "nicer_slam_tpu/models/scene_model.py:338",
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
    chk.values("topk_rgb.bwd", cu + "composite.cu", "nicer_slam_tpu/models/scene_model.py:338",
               kg, pg, ms, pms, ("g_topk_w", "g_wsum", "g_rgb"),
               nbytes(topk_w, wsum, rgb, go, *kg), R * Kc * 12)

    # ---- K5 given densities: one render chunk of 2580 rays x 640
    scfg = rs.SamplerConfig(N_samples=64, N_samples_eval=640, N_samples_extra=32)
    o, d = _sampler_rays(g, dev, R_render)
    zs, _, _ = rs.uniform_z_vals(scfg, o, d, None)
    pts = o[:, None, :] + zs[..., None] * d[:, None, :]
    sdf = pts.norm(dim=-1) - 0.6
    dens = dens_ops.laplace_density(sdf, torch.tensor(0.0125, device=dev))
    perm = torch.linspace(0, 639, 32, device=dev).to(torch.int64)
    eik = torch.zeros((R_render,), dtype=torch.int64, device=dev)
    kz, ke = rs.importance_sample_given(scfg, zs, dens, perm, eik)
    pz, pe = rs.importance_sample_given_plain(scfg, zs, dens, perm, eik)
    ms = cuda_time(lambda: rs.importance_sample_given(scfg, zs, dens, perm, eik))
    pms = cuda_time(lambda: rs.importance_sample_given_plain(scfg, zs, dens, perm, eik))
    _sampler_record(chk, "importance_sample_given", kz, ke, pz, pe, ms, pms, R_render,
                    nbytes(zs, dens, perm, eik, kz, ke),
                    R_render * 640 * 20 + R_render * kz.shape[1] * 40)


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


def write_conf(kind: str, data_dir: str) -> str:
    p = PATHS[kind]
    text = open(p["conf"]).read()
    edits = [(f"data_dir = {p['data_dir']}", f'data_dir = "{data_dir}"'),
             (f"n_images = {p['n_images']}", f"n_images = {N_FRAMES}"),
             ("mapping_every_frame = 5\n", "mapping_every_frame = 5\n"
              f"        global_window_start = {GLOBAL_WINDOW_START}\n"),
             ("resolution = 512", f"resolution = {MESH_RESOLUTION}")] + p["edits"]
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{kind} conf edit failed ({old!r})")
        text = text.replace(old, new)
    if f"img_res = [\n        {p['H']}\n        {p['W']}\n    ]" not in text:
        raise RuntimeError(f"{kind} conf: unexpected img_res")
    path = os.path.join(SMOKE_DIR, f"{kind}_smoke.conf")
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
    log(f"[1/6] card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    procs = start_scenes()
    try:
        t = time.perf_counter()
        path = _cuda.build()
        _cuda.library()
        log(f"[2/6] build: {os.path.relpath(path, ROOT)} in {time.perf_counter() - t:.1f} s")

        log(f"[3/6] kernels vs plain versions (tolerance: values {VAL_RTOL:g}·max|ref| "
            f"per output, atomic gradients rel L2 {GRAD_REL_L2:g}, sampler {Z_ATOL:g} "
            f"on every ray, the voxel counter bit for bit); each kernel's launch "
            f"alone, mean of 10 after 2; the plain versions of K1/K2 once; bounds at "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s and {FP32_OPS_PER_S / 1e12:g} "
            f"TFLOP/s float32; card {card}")
        chk = Checks()
        check_hash_kernels(dev, chk)
        check_demo_kernels(dev, chk)
        check_flagship_kernels(dev, chk)
        torch.cuda.empty_cache()

        runs = {}
        for step, kind in ((4, "demo"), (5, "flagship")):
            t = time.perf_counter()
            data_dir = wait_scene(procs, kind)
            p = PATHS[kind]
            log(f"[{step}/6] SLAM main path: {kind} configuration, {N_FRAMES} frames, "
                f"{p['H']}x{p['W']}, global_window_start {GLOBAL_WINDOW_START} "
                f"(waited {time.perf_counter() - t:.1f} s for the scan)")
            runs[kind] = run_slam(dev, kind, data_dir)
            torch.cuda.empty_cache()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    log("[6/6] report (card: " + card + ")")
    failures = list(chk.failures)
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
