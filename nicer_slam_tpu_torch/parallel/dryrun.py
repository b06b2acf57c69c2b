"""Dry run of the ray-parallel mapping step (counterpart of the JAX
package's ``dryrun_multichip``): full mapping iterations of the flagship
configuration (forward, second-order backward, 6-group Adam, BA, flow and
warp losses) over the ranks of a process group, on random frame stores.

  torchrun --nproc_per_node N -m nicer_slam_tpu_torch.parallel.dryrun \\
      [--full] [--backend nccl|gloo] [--device cuda|cuda:0|cpu] [--check] \\
      [--out OUT.json]

Each collective mode (replicated, psum_bf16) runs ITERS mapping
iterations from the same seed-0 weights and draws (the second starts
from the first's all-reduced update). By default the flagship networks are shrunk as the JAX dry run
shrinks them (two levels per SDF grid, a 4-level colour grid, 8 + 4
samples, colour top-4 at 32 x 40 pixels, 64 rays per rank; psum_bf16
then takes the colour grid from 2^12 rows, as the JAX dry run lowers its
threshold); ``--full`` keeps every width of the flagship configuration
(8192 rays at 680 x 1200, its grids, colour top-16). With ``--check``
rank 0 then runs the same iterations without a shard (the one-process
step) and holds each mode against it under the JAX package's multichip
bounds, psum_bf16's colour grid by its all-reduced gradient (``compare``).
Rank 0 prints one line per mode and writes ``--out`` (losses, ms per
iteration, the bytes and time of one gradient all-reduce, the check, and
on the card the kernel launches of the sharded steps summed over the
ranks). With ``--backend gloo --device cuda:0``
every rank shares one card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP_CONF = os.path.join(ROOT, "confs", "replica", "runconf_replica_2.conf")
# the JAX dry run's shrunk flagship (__graft_entry__._flagship_setup(tiny=True))
TINY_EDITS = {"implicit_network.coarse.logmap": 15, "implicit_network.coarse.num_levels": 2,
              "implicit_network.fine.logmap": 15, "implicit_network.fine.num_levels": 2,
              "rendering_network.use_grid_feature": True,
              "rendering_network.color_num_levels": 4, "rendering_network.color_logmap": 13,
              "rendering_network.color_desired_res": 64, "ray_sampler.N_samples": 8,
              "ray_sampler.N_samples_eval": 32, "ray_sampler.N_samples_extra": 4,
              "ray_sampler.prepass_cache_res": 32, "color_topk": 4}
TINY_RES, TINY_RAYS_PER_RANK, TINY_BF16_ROWS = (32, 40), 64, 1 << 12
SLOTS, EDGES, ITERS = 8, 4, 2


class StepCase:
    """The inputs of the dry run's mapping step on ``device``."""

    def __init__(self, full: bool, rays: int, device, seed: int = 0):
        import torch

        from .. import config as cm
        from ..models import scene_model as sm
        from ..models.losses import loss_config_from_conf
        from ..slam.mapping import FrameData, MapBatchRefs, MapConfig
        from ..utils.camera import tensor_from_camera_np

        conf = cm.parse_file(FLAGSHIP_CONF)
        mconf = conf.get_config("model")
        if not full:
            for k, v in TINY_EDITS.items():
                mconf.put(k, v)
        H, W = (tuple(conf.get_list("dataset.img_res")) if full else TINY_RES)
        self.device = torch.device(device)
        self.seed = seed
        self.scene_cfg = sm.scene_config_from_conf(mconf, (H, W), 8)
        self.loss_cfg = loss_config_from_conf(conf.get_config("loss"))
        self.map_cfg = MapConfig(num_pixels=rays, max_slots=SLOTS, BA_cam_lr=1e-3)
        rng = np.random.default_rng(seed)
        HW = H * W
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self.store = FrameData(
            rgb=T(rng.integers(0, 255, (SLOTS, HW, 3), np.uint8)),
            depth=T(rng.uniform(0.1, 1, (SLOTS, HW)).astype(np.float16)),
            normal=T(rng.normal(size=(SLOTS, HW, 3)).astype(np.float16)),
            gt_depth=T(rng.uniform(0.1, 1, (SLOTS, HW)).astype(np.float16)),
            mask=T(np.ones((SLOTS, HW), bool)))
        q = np.zeros((SLOTS, 7), np.float32)
        for s in range(SLOTS):
            pose = np.eye(4, dtype=np.float32)
            pose[2, 3] = -0.3 + 0.01 * s
            q[s] = tensor_from_camera_np(pose)
        self.poses_q = T(q)
        K = np.eye(4, dtype=np.float32)
        K[0, 0] = K[1, 1] = 600.0 if full else 35.0
        K[0, 2], K[1, 2] = W / 2, H / 2
        self.refs = MapBatchRefs(
            slot_rows=T(np.arange(SLOTS)), frame_ids=T(np.arange(SLOTS)), n_valid=SLOTS,
            intrinsics=T(np.tile(K[None], (SLOTS, 1, 1))),
            edge_idii=T(np.array([0, 1, 2, 3])), edge_idjj=T(np.array([1, 2, 3, 0])),
            flow_imgs=T(np.zeros((EDGES, HW, 2), np.float16)),
            flow_occ=T(np.ones((EDGES, HW), bool)),
            slot_conf=T(np.ones((SLOTS,), np.float32)))

    def run(self, iters: int, shard=None, timed_allreduce: bool = False,
            keep_grads=()) -> dict:
        """``iters`` mapping iterations with BA from fresh seed weights and
        the seed's draws: per iteration the loss, its time, and the
        parameters, poses and voxel counter after it (numpy); the last
        iteration's loss terms; the first iteration's (all-reduced)
        gradients of the parameters named in ``keep_grads`` and, with a
        shard, of the tables it all-reduces in bf16 (``grads0``)."""
        import torch

        from . import mesh
        from ..models import scene_model as sm
        from ..slam.mapping import make_map_draws, map_step
        from ..slam.state import OptimConfig, make_optimizer

        model = sm.SceneModel(self.scene_cfg, np.random.default_rng(self.seed)).to(self.device)
        keep = set(keep_grads)
        if shard is not None:
            bf16 = mesh.bf16_tables(model, shard)
            keep |= {n for n, p in model.named_parameters() if id(p) in bf16}
        opt = make_optimizer(OptimConfig(learning_rate=2e-3, lr_factor_for_fine_grid=20.0,
                                         lr_factor_for_coarse_grid=20.0,
                                         lr_factor_for_color_grid=5.0), model)
        voxels = sm.init_voxels(self.scene_cfg, self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        q, losses, ms = self.poses_q, [], []
        params, qs, voxs, grads0 = [], [], [], {}
        for i in range(iters):
            cache = (sm.build_density_cache(self.scene_cfg, model, voxels)
                     if self.scene_cfg.sampler.prepass_mode == "cached" else None)
            draws = make_map_draws(self.scene_cfg, self.map_cfg, gen, self.device)
            _sync(self.device)
            t = time.perf_counter()
            voxels, q, terms = map_step(
                self.scene_cfg, self.map_cfg, self.loss_cfg, model, opt, voxels, q,
                self.refs, self.store, draws, cache, None, stage="fine",
                color_stage="highfreq", ba=True, is_first_frame=False, shard=shard)
            _sync(self.device)
            ms.append(1e3 * (time.perf_counter() - t))
            losses.append(float(terms["loss"]))
            # copies: on the CPU .numpy() would share the parameters' memory
            params.append({n: p.detach().cpu().numpy().copy()
                           for n, p in model.named_parameters()})
            qs.append(q.cpu().numpy().copy())
            voxs.append(voxels.cpu().numpy().copy())
            if i == 0:
                grads0 = {n: p.grad.cpu().numpy().copy() for n, p in model.named_parameters()
                          if n in keep and p.grad is not None}
        out = {"losses": losses, "ms_per_iter": ms, "params": params, "q": qs,
               "voxels": voxs, "grads0": grads0,
               "terms": {k: v.cpu().numpy() for k, v in terms.items()}}
        if shard is not None and timed_allreduce:
            # one more all-reduce of the last step's gradients, timed alone
            params = [p for g in opt.param_groups for p in g["params"]]
            _sync(self.device)
            t = time.perf_counter()
            mesh.allreduce_grads(params, shard, mesh.bf16_tables(model, shard))
            _sync(self.device)
            out["allreduce_ms"] = 1e3 * (time.perf_counter() - t)
            out["bf16_tables"] = len(mesh.bf16_tables(model, shard))
        return out


def compare(ref: dict, got: dict, init: dict, bf16=()) -> dict:
    """Per iteration, against the one-process run: the JAX package's
    multichip bounds (tests/_multichip_equiv_main.py) on the loss (rtol
    2e-4), the poses (rtol 1e-3 / atol 1e-6) and the voxel counter (equal);
    after the first iteration also each parameter's update within 5e-3 of
    its largest one-process update, the JAX bound for one step. The
    bf16-reduced tables (``bf16``), whose sign-like first Adam update
    flips with the rounding of a gradient near 0, are held instead by
    their first all-reduced gradient, within 4e-2 of the largest
    one-process gradient (tests/_grid_collectives_main.py's bound, as
    tests/test_torch_parallel.py holds it). Later iterations' update
    shares are reported, not held: from the second step on the rounding
    of the first moves every sample. Returns the errors and ``ok``."""
    grads, ok = {}, True
    for n in bf16:
        g1, g2 = ref["grads0"][n], got["grads0"][n]
        bound = 4e-2 * float(np.abs(g1).max())
        err = float(np.abs(g2 - g1).max())
        grads[n] = {"max_abs": err, "bound": bound, "ok": err <= bound}
        ok &= err <= bound
    rows = []
    for i, (l1, l2) in enumerate(zip(ref["losses"], got["losses"])):
        prev = init if i == 0 else ref["params"][i - 1]
        prev2 = init if i == 0 else got["params"][i - 1]
        worst, worst_name = 0.0, None
        for n, p in ref["params"][i].items():
            if n in bf16:
                continue
            u1, u2 = p - prev[n], got["params"][i][n] - prev2[n]
            share = float(np.abs(u2 - u1).max() / max(np.abs(u1).max(), 1e-8))
            if share > worst:
                worst, worst_name = share, n
        row = {"loss_rel": abs(l2 - l1) / max(abs(l1), 1e-30),
               "q_max_abs": float(np.abs(got["q"][i] - ref["q"][i]).max()),
               "q_ok": bool(np.allclose(got["q"][i], ref["q"][i], rtol=1e-3, atol=1e-6)),
               "voxels_equal": bool(np.array_equal(got["voxels"][i], ref["voxels"][i])),
               "update_worst_share": worst, "update_worst_param": worst_name}
        row["ok"] = (row["loss_rel"] <= 2e-4 and row["q_ok"] and row["voxels_equal"]
                     and (i > 0 or worst <= 5e-3))
        ok &= row["ok"]
        rows.append(row)
    return {"iterations": rows, "bf16_grads": grads, "ok": ok}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true", help="the flagship's full widths")
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:LOCAL_RANK), cuda:K (every rank on one card) or cpu")
    ap.add_argument("--backend", default=None, help="nccl (CUDA default) or gloo")
    ap.add_argument("--check", action="store_true",
                    help="rank 0 holds each mode against the one-process step")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from . import mesh
    from ..ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = args.device
    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    mesh.init_process_group(backend=args.backend, device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    rays = 8192 if args.full else TINY_RAYS_PER_RANK * world
    case = StepCase(args.full, rays, device)
    report = {"world": world, "rays": rays, "full": args.full, "device": device,
              "backend": dist.get_backend(), "modes": {}}
    results = {}
    try:
        if case.device.type == "cuda":
            _cuda.reset_launch_counts()
        for mode in mesh.COLLECTIVE_MODES:
            shard = mesh.ray_shard(
                mode, min_entries=mesh.GRID_SHARD_MIN_ENTRIES if args.full else TINY_BF16_ROWS)
            res = results[mode] = case.run(ITERS, shard, timed_allreduce=True)
            if not all(np.isfinite(res["losses"])):
                raise RuntimeError(f"{mode}: non-finite loss {res['losses']}")
            m = report["modes"][mode] = {
                "losses": res["losses"], "ms_per_iter": res["ms_per_iter"],
                "allreduce_bytes": float(res["terms"]["allreduce_bytes"]),
                "allreduce_ms": res["allreduce_ms"],
                "bf16_tables": res["bf16_tables"]}
            if rank == 0:
                print(f"dryrun({world}) {mode}: ok, loss={res['losses'][-1]:.6f} "
                      f"{np.mean(res['ms_per_iter']):.1f} ms/iter, all-reduce "
                      f"{m['allreduce_bytes'] / 1e6:.1f} MB in {m['allreduce_ms']:.2f} ms",
                      flush=True)
        if case.device.type == "cuda":
            # the sharded steps' launches, summed over the ranks (the
            # one-process reference below is not counted)
            counts = [None] * world
            dist.all_gather_object(counts, _cuda.launch_counts())
            report["launches"] = {k: sum(c[k] for c in counts) for k in counts[0]}
    finally:
        dist.destroy_process_group()
    if rank == 0 and args.check:
        from ..models import scene_model as sm

        bf16 = sorted({n for res in results.values() for n in res["grads0"]})
        ref = case.run(ITERS, keep_grads=bf16)
        report["reference"] = {"losses": ref["losses"], "ms_per_iter": ref["ms_per_iter"]}
        init = {n: p.detach().numpy() for n, p in sm.SceneModel(
            case.scene_cfg, np.random.default_rng(case.seed)).named_parameters()}
        for mode, res in results.items():
            c = report["modes"][mode]["check"] = compare(ref, res, init, sorted(res["grads0"]))
            print(f"dryrun({world}) {mode} vs one process: {'ok' if c['ok'] else 'FAILED'} "
                  f"{json.dumps(c)}", flush=True)
    if rank == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report

if __name__ == "__main__":
    main()
