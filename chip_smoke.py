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
     the card, with errors, tolerances and CUDA-event times of both: K1,
     K2, K4 and K5 at the demo slice's shapes (4096 mapping rays x 98
     samples, the demo configuration's coarse, fine and full 133M-entry
     color grids), the flagship kernels at the flagship configuration's
     (8192 mapping rays x 98 samples = 802,816 points, colour top-16, the
     exact prepass of a 2580-ray render chunk = 1,651,200 points).
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
    "flagship": ("hash_encode_bf16", "weights_topk.fwd", "weights_topk.bwd", "topk_rgb.fwd",
                 "topk_rgb.bwd", "importance_sample_given", "voxels.scatter", "voxels.beta"),
}
# (tolerance) values: max|kernel - plain| <= VAL_RTOL * max|plain|, per
# output; gradients written with float atomics (order changes from run to
# run): ||kernel - plain||_2 <= GRAD_REL_L2 * ||plain||_2
VAL_RTOL = 1e-5
GRAD_REL_L2 = 1e-5
# importance sampler: every ray's z_vals and z_eik within Z_ATOL (float32
# scans in another order move a sample by a few ulps of z <= 3.5)
Z_ATOL = 1e-4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_time(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


class Checks:
    """Kernel results by name, and the names that failed."""

    def __init__(self):
        self.results, self.failures = {}, []

    def record(self, name, source, replaces, err, ok, ms, plain_ms, extra=""):
        self.results[name] = {"name": name, "route": "cuda", "source": source,
                              "replaces": replaces, "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms}
        log(f"  {name:30s} max_abs_err {err:.3e} {extra} kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms {'OK' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)

    def values(self, name, source, replaces, kern_outs, plain_outs, ms, pms, labels):
        """Per output: max|kernel - plain| <= VAL_RTOL * max|plain|."""
        errs = [max_abs(a, b) for a, b in zip(kern_outs, plain_outs)]
        scales = [float(b.abs().max()) for b in plain_outs]
        self.record(name, source, replaces, max(errs),
                    all(e <= VAL_RTOL * s for e, s in zip(errs, scales)), ms, pms,
                    "(" + ", ".join(f"{n} {e:.2e} of {s:.2e}" for n, e, s
                                    in zip(labels, errs, scales)) + ")")


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

def check_demo_kernels(dev, chk: Checks, R: int = 4096):
    """K1, K2, K4 and K5 (cached prepass) at the demo slice's shapes."""
    import torch
    from nicer_slam_tpu_torch.models import fields
    from nicer_slam_tpu_torch.ops import hash_encoder as he
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    from nicer_slam_tpu_torch.ops import volume_rendering as vr
    from nicer_slam_tpu.config import parse_file

    conf = parse_file(PATHS["demo"]["conf"]).get_config("model")
    fvs = conf.get_int("feature_vector_size")
    comb = fields.combine_config_from_conf(conf.get_config("implicit_network"), fvs)
    rend = fields.rendering_config_from_conf(conf.get_config("rendering_network"), fvs)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    S, Ne = 98, 640
    N = R * S

    def x_points(n):
        # mostly inside [-1, 1]^3 (some outside: zero features)
        return (torch.rand((n, 3), generator=g, device=dev) * 2.1 - 1.05).contiguous()

    # ---- K1 on the fine (C=4) and coarse (C=8) SDF grids; K2 on the color grid
    hash_cases = [("fine", comb.fine.hash_spec(), True),
                  ("coarse", comb.coarse.hash_spec(), True),
                  ("color", rend.hash_spec(), False)]
    for grid, spec, jac in hash_cases:
        table = (torch.rand((spec.level_dim, spec.total_entries), generator=g,
                            device=dev) * 2 - 1)
        x = x_points(N)
        L, C = spec.num_levels, spec.level_dim
        gf = torch.randn((N, L * C), generator=g, device=dev)
        gd = torch.randn((N, L * C, 3), generator=g, device=dev) if jac else None
        kname = "hash_encode_with_grad" if jac else "hash_encode"
        kern = he.hash_encode_with_grad if jac else he.hash_encode

        def plain(xx, tt):
            return he.hash_encode_plain(spec, tt, xx, 1.0, jac)

        def run(fn, need_grad):
            xx = x.clone().requires_grad_(need_grad)
            tt = table.clone().requires_grad_(need_grad)
            out = fn(spec, tt, xx) if fn is kern else fn(xx, tt)
            return out, xx, tt

        with torch.no_grad():
            ko = kern(spec, table, x)
            po = plain(x, table)
            ms = cuda_time(lambda: kern(spec, table, x))
            pms = cuda_time(lambda: plain(x, table), iters=3, warmup=1)
        # feats, and dfeat for K1, each against its own scale
        chk.values(f"{kname}.fwd[{grid}]", "nicer_slam_tpu_torch/csrc/hash_encoder.cu",
                   "nicer_slam_tpu/ops/hash_encoder.py:266" if jac
                   else "nicer_slam_tpu/ops/hash_encoder.py:177",
                   ko if jac else [ko], po if jac else [po], ms, pms, ("feats", "dfeat"))
        del ko, po

        def loss_of(out):
            if jac:
                return (out[0] * gf).sum() + (out[1] * gd).sum()
            return (out * gf).sum()

        ko, kx, kt = run(kern, True)
        kl = loss_of(ko)
        kgx, kgt = torch.autograd.grad(kl, [kx, kt], retain_graph=True)
        po, px, pt = run(plain, True)
        pl = loss_of(po)
        pgx, pgt = torch.autograd.grad(pl, [px, pt], retain_graph=True)
        ex, et = rel_l2(kgx, pgx), rel_l2(kgt, pgt)
        ms = cuda_time(lambda: torch.autograd.grad(kl, [kx, kt], retain_graph=True))
        pms = cuda_time(lambda: torch.autograd.grad(pl, [px, pt], retain_graph=True),
                        iters=3, warmup=1)
        err = max(max_abs(kgx, pgx), max_abs(kgt, pgt))
        chk.record(f"{kname}.bwd[{grid}]", "nicer_slam_tpu_torch/csrc/hash_encoder.cu",
                   "nicer_slam_tpu/ops/hash_encoder.py:266" if jac
                   else "nicer_slam_tpu/ops/hash_encoder.py:613",
                   err, ex <= GRAD_REL_L2 and et <= GRAD_REL_L2, ms, pms,
                   f"(rel L2: grad_x {ex:.2e}, grad_table {et:.2e})")
        del ko, kx, kt, kl, kgx, kgt, po, px, pt, pl, pgx, pgt, table
        torch.cuda.empty_cache()

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
    chk.values("composite.fwd", "nicer_slam_tpu_torch/csrc/composite.cu",
               "nicer_slam_tpu/ops/volume_rendering.py:15", ko, po, ms, pms,
               ("weights", "rgb", "depth", "normal"))
    ins_k = [t.clone().requires_grad_(True) for t in (dens, rgb, nrm)]
    ins_p = [t.clone().requires_grad_(True) for t in (dens, rgb, nrm)]
    kl = sum((o * go).sum() for o, go in zip(vr.composite(z, *ins_k), gouts))
    pl = sum((o * go).sum() for o, go in zip(vr.composite_plain(z, *ins_p), gouts))
    kg = torch.autograd.grad(kl, ins_k, retain_graph=True)
    pg = torch.autograd.grad(pl, ins_p, retain_graph=True)
    errs = [rel_l2(a, b) for a, b in zip(kg, pg)]
    ms = cuda_time(lambda: torch.autograd.grad(kl, ins_k, retain_graph=True))
    pms = cuda_time(lambda: torch.autograd.grad(pl, ins_p, retain_graph=True))
    chk.record("composite.bwd", "nicer_slam_tpu_torch/csrc/composite.cu",
               "nicer_slam_tpu/ops/volume_rendering.py:15",
               max(max_abs(a, b) for a, b in zip(kg, pg)), max(errs) <= GRAD_REL_L2,
               ms, pms, "(rel L2 density/rgb/normals " + "/".join(f"{e:.1e}" for e in errs) + ")")

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
    _sampler_record(chk, "importance_sample", kz, ke, pz, pe, ms, pms, R)


def _sampler_record(chk, name, kz, ke, pz, pe, ms, pms, R):
    ray_ok = ((kz - pz).abs().amax(1) <= Z_ATOL) & ((ke - pe).abs()[:, 0] <= Z_ATOL)
    n_off = int((~ray_ok).sum())
    chk.record(name, "nicer_slam_tpu_torch/csrc/sampler.cu",
               "nicer_slam_tpu/ops/ray_sampling.py:112", max_abs(kz, pz), n_off == 0, ms, pms,
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
    from nicer_slam_tpu.config import parse_file

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
    chk.record("voxels.scatter", cu + "voxels.cu", "nicer_slam_tpu/ops/density.py:61",
               max_abs(kv, pv), exact, ms, pms,
               f"(counter bit for bit: {exact}; {N} points, largest count {float(pv.max()):g})")
    kb = dens_ops.grid_predefined_beta(kv, x)
    pb = dens_ops.grid_predefined_beta_plain(kv, x)
    ms = cuda_time(lambda: dens_ops.grid_predefined_beta(kv, x))
    pms = cuda_time(lambda: dens_ops.grid_predefined_beta_plain(kv, x))
    chk.values("voxels.beta", cu + "voxels.cu", "nicer_slam_tpu/ops/density.py:46",
               [kb], [pb], ms, pms, ("beta",))
    del u, shell, anywhere, pick, kv, pv, kb, pb

    # ---- K3 on both SDF grids at one render chunk's prepass (1,651,200
    # points), from tables rounded to bf16
    Np = R_render * 640
    xp = (torch.rand((Np, 3), generator=g, device=dev) * 2.1 - 1.05).contiguous()
    for grid, spec in (("coarse", comb.coarse.hash_spec()), ("fine", comb.fine.hash_spec())):
        table = torch.rand((spec.level_dim, spec.total_entries), generator=g, device=dev) * 2 - 1
        packed = he.pack_table_bf16(table)
        ko = he.hash_encode_bf16(spec, packed, xp)
        po = he.hash_encode_bf16_plain(spec, packed, xp)
        ms = cuda_time(lambda: he.hash_encode_bf16(spec, packed, xp))
        pms = cuda_time(lambda: he.hash_encode_bf16_plain(spec, packed, xp), iters=3, warmup=1)
        chk.values(f"hash_encode_bf16[{grid}]", cu + "hash_encoder.cu",
                   "nicer_slam_tpu/ops/hash_encoder.py:858", [ko], [po], ms, pms, ("feats",))
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
                                                f"other indices)"))
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
    ms = cuda_time(lambda: torch.autograd.grad(kl, ins_k, retain_graph=True))
    pms = cuda_time(lambda: torch.autograd.grad(pl, ins_p, retain_graph=True))
    chk.record("weights_topk.bwd", cu + "composite.cu",
               "nicer_slam_tpu/models/scene_model.py:321",
               max(max_abs(a, b) for a, b in zip(kg, pg)), max(errs) <= GRAD_REL_L2, ms, pms,
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
               [ko], [po], ms, pms, ("rgb",))
    go = torch.randn((R, 3), generator=g, device=dev)
    ins_k = [t.clone().requires_grad_(True) for t in (topk_w, wsum, rgb)]
    ins_p = [t.clone().requires_grad_(True) for t in (topk_w, wsum, rgb)]
    kl = (vr.topk_rgb(*ins_k) * go).sum()
    pl = (vr.topk_rgb_plain(*ins_p) * go).sum()
    kg = torch.autograd.grad(kl, ins_k, retain_graph=True)
    pg = torch.autograd.grad(pl, ins_p, retain_graph=True)
    ms = cuda_time(lambda: torch.autograd.grad(kl, ins_k, retain_graph=True))
    pms = cuda_time(lambda: torch.autograd.grad(pl, ins_p, retain_graph=True))
    chk.values("topk_rgb.bwd", cu + "composite.cu", "nicer_slam_tpu/models/scene_model.py:338",
               kg, pg, ms, pms, ("g_topk_w", "g_wsum", "g_rgb"))

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
    _sampler_record(chk, "importance_sample_given", kz, ke, pz, pe, ms, pms, R_render)


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
    from nicer_slam_tpu.utils.ply import read_ply

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
            f"on every ray, the voxel counter bit for bit); card {card}")
        chk = Checks()
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
