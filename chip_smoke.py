#!/usr/bin/env python3
"""Smoke run of nicer_slam_tpu_torch on one CUDA card.

  python3 chip_smoke.py

Phases, in order (any failure exits non-zero without the final line):
  1. card: require CUDA; print the card's name and power limit.
  2. build: compile csrc/*.cu for sm_90a (nvcc, plain C interface).
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the SLAM slice's shapes (4096 mapping rays x 98 samples,
     the demo configuration's coarse, fine and full 133M-entry color grids),
     with errors, tolerances and CUDA-event times of both.
  4. slam: write an 11-frame synthetic scene with flow, write the demo
     configuration (confs/runconf_demo_1.conf, every network at full width)
     pointed at it, and run the port's exp_runner through the 11 frames:
     tracking on every frame, mapping + BA at frames 0, 5 and 10. The conf
     gets global_window_start = 10 (200 by default, which would need 200
     frames), so the frame-10 mapping call runs the global keyframe window
     with live flow edges (keyframes 0 <-> 10). Launch counters are reset
     just before and read just after this run.
  5. report: per-frame translation error against GT, the loss terms of
     each mapping call's last iteration, launch counts, s/frame, ms per
     track and map iteration, the runner's phase times, peak memory; the
     final model checkpoint is read back and held against the model. Then
     one JSON line with every kernel, the nvidia-smi line, and the result
     line.

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
DEMO_CONF = os.path.join(ROOT, "confs", "runconf_demo_1.conf")
N_FRAMES = 11
H, W = 720, 1280          # the demo configuration's img_res
# the frame from which the mapping window is global and carries flow edges
GLOBAL_WINDOW_START = 10
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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev, R: int = 4096):
    import torch
    from nicer_slam_tpu_torch.models import fields
    from nicer_slam_tpu_torch.ops import hash_encoder as he
    from nicer_slam_tpu_torch.ops import ray_sampling as rs
    from nicer_slam_tpu_torch.ops import volume_rendering as vr
    from nicer_slam_tpu.config import parse_file

    conf = parse_file(DEMO_CONF).get_config("model")
    fvs = conf.get_int("feature_vector_size")
    comb = fields.combine_config_from_conf(conf.get_config("implicit_network"), fvs)
    rend = fields.rendering_config_from_conf(conf.get_config("rendering_network"), fvs)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    S, Ne = 98, 640
    N = R * S
    results, failures = {}, []

    def record(name, source, replaces, err, ok, ms, plain_ms, extra=""):
        results[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms}
        log(f"  {name:28s} max_abs_err {err:.3e} {extra} kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)

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
        pairs = list(zip(ko, po)) if jac else [(ko, po)]
        errs = [max_abs(a, b) for a, b in pairs]
        scales = [float(b.abs().max()) for _, b in pairs]
        record(f"{kname}.fwd[{grid}]", "nicer_slam_tpu_torch/csrc/hash_encoder.cu",
               "nicer_slam_tpu/ops/hash_encoder.py:266" if jac
               else "nicer_slam_tpu/ops/hash_encoder.py:177",
               max(errs), all(e <= VAL_RTOL * s for e, s in zip(errs, scales)), ms, pms,
               "(" + ", ".join(f"{n} {e:.2e} of scale {s:.2e}" for n, e, s
                               in zip(("feats", "dfeat"), errs, scales)) + ")")
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
        record(f"{kname}.bwd[{grid}]", "nicer_slam_tpu_torch/csrc/hash_encoder.cu",
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
        errs = [max_abs(a, b) for a, b in zip(ko, po)]
        scales = [float(b.abs().max()) for b in po]
        ms = cuda_time(lambda: vr.composite(z, dens, rgb, nrm))
        pms = cuda_time(lambda: vr.composite_plain(z, dens, rgb, nrm))
    record("composite.fwd", "nicer_slam_tpu_torch/csrc/composite.cu",
           "nicer_slam_tpu/ops/volume_rendering.py:15", max(errs),
           all(e <= VAL_RTOL * s for e, s in zip(errs, scales)), ms, pms,
           "(weights/rgb/depth/normal " + "/".join(f"{e:.1e}" for e in errs) + ")")
    ins_k = [t.clone().requires_grad_(True) for t in (dens, rgb, nrm)]
    ins_p = [t.clone().requires_grad_(True) for t in (dens, rgb, nrm)]
    kl = sum((o * go).sum() for o, go in zip(vr.composite(z, *ins_k), gouts))
    pl = sum((o * go).sum() for o, go in zip(vr.composite_plain(z, *ins_p), gouts))
    kg = torch.autograd.grad(kl, ins_k, retain_graph=True)
    pg = torch.autograd.grad(pl, ins_p, retain_graph=True)
    errs = [rel_l2(a, b) for a, b in zip(kg, pg)]
    ms = cuda_time(lambda: torch.autograd.grad(kl, ins_k, retain_graph=True))
    pms = cuda_time(lambda: torch.autograd.grad(pl, ins_p, retain_graph=True))
    record("composite.bwd", "nicer_slam_tpu_torch/csrc/composite.cu",
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
    ang = torch.rand((R, 2), generator=g, device=dev)
    o = torch.stack([torch.zeros(R, device=dev), torch.zeros(R, device=dev),
                     torch.full((R,), -0.9, device=dev)], -1)
    d = torch.stack([ang[:, 0] - 0.5, ang[:, 1] - 0.5, torch.ones(R, device=dev)], -1)
    d = d / (d * d).sum(-1, keepdim=True)
    t_rand = torch.rand((R, Ne), generator=g, device=dev)
    perm = torch.randperm(Ne, generator=g, device=dev)[:32]
    eik = torch.randint(0, scfg.total_samples, (R,), generator=g, device=dev)
    kz, ke = rs.importance_sample(scfg, o, d, cache, t_rand, perm, eik)
    pz, pe = rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm, eik)
    ray_ok = ((kz - pz).abs().amax(1) <= Z_ATOL) & ((ke - pe).abs()[:, 0] <= Z_ATOL)
    n_off = int((~ray_ok).sum())
    ms = cuda_time(lambda: rs.importance_sample(scfg, o, d, cache, t_rand, perm, eik))
    pms = cuda_time(lambda: rs.importance_sample_plain(scfg, o, d, cache, t_rand, perm, eik))
    record("importance_sample", "nicer_slam_tpu_torch/csrc/sampler.cu",
           "nicer_slam_tpu/ops/ray_sampling.py:112", max_abs(kz, pz),
           n_off == 0, ms, pms,
           f"(rays off by more than {Z_ATOL:g}: {n_off} of {R}; median ray err "
           f"{float((kz - pz).abs().amax(1).median()):.1e})")
    return results, failures


# ---------------------------------------------------------------------------
# phase 4: the SLAM main path
# ---------------------------------------------------------------------------

def write_scene() -> str:
    from nicer_slam_tpu_torch.datasets.synthetic import generate
    data_dir = os.path.join(SMOKE_DIR, f"Synthetic_{H}x{W}")
    marker = os.path.join(data_dir, "complete")
    if not os.path.exists(marker):
        shutil.rmtree(data_dir, ignore_errors=True)
        generate(data_dir, scan_id=1, n_frames=N_FRAMES, H=H, W=W,
                 keyframe_every=10, with_flow=True)
        open(marker, "w").close()
    return data_dir


def write_conf(data_dir: str) -> str:
    text = open(DEMO_CONF).read()
    text = text.replace('data_dir = "../Datasets/processed/Demo"',
                        f'data_dir = "{data_dir}"')
    text = text.replace("n_images = 200", f"n_images = {N_FRAMES}")
    text = text.replace("mapping_every_frame = 5\n", "mapping_every_frame = 5\n"
                        f"        global_window_start = {GLOBAL_WINDOW_START}\n")
    for must in (data_dir, f"n_images = {N_FRAMES}",
                 f"global_window_start = {GLOBAL_WINDOW_START}",
                 f"img_res = [\n        {H}\n        {W}\n    ]"):
        if must not in text:
            raise RuntimeError(f"demo conf edit failed ({must!r})")
    path = os.path.join(SMOKE_DIR, "demo_smoke.conf")
    with open(path, "w") as f:
        f.write(text)
    return path


def run_slam(dev):
    import numpy as np
    import torch
    from nicer_slam_tpu_torch.ops import _cuda
    from nicer_slam_tpu_torch.training import exp_runner

    t0 = time.perf_counter()
    data_dir = write_scene()
    log(f"  scene {H}x{W}, {N_FRAMES} frames with flow: "
        f"{time.perf_counter() - t0:.1f} s")
    conf = write_conf(data_dir)
    exps = os.path.join(SMOKE_DIR, "exps")
    shutil.rmtree(exps, ignore_errors=True)

    map_terms, flow_edges = {}, {}

    def hook(runner, frame_idx):
        if frame_idx % runner.mapping_every_frame == 0:
            map_terms[frame_idx] = runner.last_map_terms
            edges = runner._edge_refs
            flow_edges[frame_idx] = 0 if edges is None else int(edges[0].numel())

    # the CLI entry point, as a user runs it; counts and peak memory cover
    # set-up (model init, first density cache) and the 11 frames
    argv = ["--conf", conf, "--root_dir", SMOKE_DIR, "--device", str(dev)]
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
    # frame, checkpoint = the npz writes; "other" is the rest of the loop
    phase_s = {k: v["total_s"] for k, v in summ.items()}
    stats = {
        "setup_s": wall - runner.run_s,
        "s_per_frame": runner.run_s / N_FRAMES,
        "ms_per_track_iter": 1000 * phase_s["tracking"]
        / (summ["tracking"]["count"] * runner.num_cam_iters),
        "ms_per_map_iter": summ["mapping"]["mean_ms"],
        "cache_builds": summ["cache"]["count"],
        "ms_per_cache_build": summ["cache"]["mean_ms"],
        **{f"{k}_s": v for k, v in phase_s.items()},
        "other_s": runner.run_s - sum(phase_s.values()),
        "peak_mem_GiB": peak / 2 ** 30,
    }
    # the run's own outputs: the final model checkpoint holds the model
    from nicer_slam_tpu_torch.slam.checkpoint import params_to_numpy
    ck = runner.checkpoints_path
    for sub in ("ModelParameters", "OptimizerParameters", "PoseParameters"):
        if not os.path.exists(os.path.join(ck, sub, "latest.npz")):
            raise RuntimeError(f"missing checkpoint {sub}")
    with np.load(os.path.join(ck, "ModelParameters", "latest.npz")) as saved:
        for k, v in params_to_numpy(runner.model).items():
            if not np.array_equal(saved["model_state_dict/" + k], v):
                raise RuntimeError(f"checkpoint differs from the model at {k}")
    return runner, map_terms, flow_edges, errs, counts, stats


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
    log(f"[1/5] card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    t = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    log(f"[2/5] build: {os.path.relpath(path, ROOT)} in {time.perf_counter() - t:.1f} s")

    log(f"[3/5] kernels vs plain versions (tolerance: values {VAL_RTOL:g}·max|ref| "
        f"per output, atomic gradients rel L2 {GRAD_REL_L2:g}, sampler {Z_ATOL:g} "
        f"on every ray); card {card}")
    results, failures = check_kernels(dev)

    log(f"[4/5] SLAM main path: demo configuration, {N_FRAMES} frames, "
        f"{H}x{W}, global_window_start {GLOBAL_WINDOW_START}")
    runner, map_terms, flow_edges, errs, counts, stats = run_slam(dev)
    log("[5/5] report (card: " + card + ")")
    log("  translation error vs GT per frame: "
        + " ".join(f"{i}:{e:.4f}" for i, e in errs.items()))
    for f, terms in map_terms.items():
        log(f"  loss terms, last iteration of the frame-{f} mapping call "
            f"({flow_edges[f]} flow edges): "
            + " ".join(f"{k}={float(v):.5g}" for k, v in terms.items()))
    log("  launches: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    log("  " + " ".join(f"{k}={v:.4g}" for k, v in stats.items()))
    bad = [(f, k) for f, terms in map_terms.items() for k, v in terms.items()
           if not torch.isfinite(v).all()]
    if bad:
        failures.append(f"non-finite loss terms {bad}")
    if not all(map(lambda e: e == e and e < 1e3, errs.values())):
        failures.append("non-finite poses")
    last = max(map_terms)
    if flow_edges[last] == 0 or not float(map_terms[last]["flow_loss"]) > 0:
        failures.append(f"the frame-{last} mapping call ran without live flow edges")
    never = [k for k in _cuda.KERNELS if counts[k] == 0]
    if never:
        failures.append(f"kernels never launched on the main path: {never}")

    kernels = []
    for name, r in results.items():
        base = name.split("[")[0]
        kernels.append(dict(r, launches=counts[base]))
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
