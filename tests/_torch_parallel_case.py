"""The ray-parallel mapping step's test case, shared by
tests/test_torch_parallel.py, the gloo rank processes it spawns and the
JAX package's sharded step in tests/_torch_parallel_jax_main.py.

The case is tests/test_torch_slice.py's map_step case (frames 0 and 4 of a
24x32 synthetic scan, 48 rays over two slots with a tracking error and
fractional slot weights, flow edges both ways, the warp loss, BA, the
smooth cached prepass density) as numpy arrays, so a process without
jax builds the port's step from them. Importing this module imports
neither torch nor jax.
"""

from __future__ import annotations

import os

import numpy as np

H, W, N_IMAGES = 24, 32, 5
FRAMES, SMAX, R = [0, 4], 4, 48
SLOT_ROWS = np.array([0, 1, 0, 0])
FRAME_IDS = np.array([0, 4, 0, 0])
SLOT_CONF = np.array([1.0, 0.6, 1.0, 1.0], np.float32)
OPTIM = dict(learning_rate=0.002, lr_factor_for_fine_grid=20.0,
             lr_factor_for_coarse_grid=20.0, lr_factor_for_color_grid=5.0)


def scene_arrays(data_dir: str) -> dict:
    """The step's inputs from a scan written by the port's synthetic
    generator (``generate(data_dir, scan_id=1, n_frames=5, H=24, W=32,
    keyframe_every=4, with_flow=True)``)."""
    from nicer_slam_tpu_torch.datasets.scene_dataset import SLAMDataset
    from nicer_slam_tpu_torch.utils.camera import tensor_from_camera_np

    ds = SLAMDataset(data_dir=data_dir, img_res=[H, W], scan_id=1, use_gt_depth=True,
                     n_images=N_IMAGES)
    rows = [ds.frame(f) for f in FRAMES]
    a = dict(
        rgb=np.stack([np.clip(r["rgb"] * 255 + 0.5, 0, 255).astype(np.uint8) for r in rows]),
        depth=np.stack([r["depth"] for r in rows]).astype(np.float16),
        normal=np.stack([r["normal"] for r in rows]).astype(np.float16),
        gt_depth=np.stack([r["gt_depth"] for r in rows]).astype(np.float16),
        mask=np.stack([r["mask"] for r in rows]))
    pairs = [ds.flow_pair(0, 4), ds.flow_pair(4, 0)]
    a["flows"] = np.stack([np.where(o.reshape(-1, 1), f.reshape(-1, 2), 0)
                           for f, o in pairs]).astype(np.float16)
    a["occ"] = np.stack([o.reshape(-1) for _, o in pairs])
    intr = np.tile(np.eye(4, dtype=np.float32), (SMAX, 1, 1))
    intr[:2] = [ds.intrinsics_all[f] for f in FRAMES]
    a["intr"] = intr
    q = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (SMAX, 1))
    for i, f in enumerate(FRAMES):
        q[i] = tensor_from_camera_np(ds.gt_pose_all[f])
    q[1, 4:] += np.array([0.02, -0.01, 0.015], np.float32)     # a tracking error
    a["q"] = q
    a["vox"] = np.random.default_rng(0).integers(0, 30, (16, 16, 16)).astype(np.float32)
    # the slice test's thin, smooth prepass density (no inverse-CDF tie at u = 1)
    g = np.linspace(-1, 1, 16)
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    a["cache"] = (0.3 + 0.2 * np.cos(3 * gx) * np.cos(2 * gy) * np.cos(gz)).astype(np.float32)
    return a


def port_configs():
    """(torch SceneConfig, mapping LossConfig) of the case."""
    from nicer_slam_tpu_torch import config
    from nicer_slam_tpu_torch.models import losses as tl
    from nicer_slam_tpu_torch.models import scene_model as tsm

    import _torch_tiny
    c = config.parse_string(_torch_tiny.MODEL_CONF + _torch_tiny.LOSS_CONF)
    return (tsm.scene_config_from_conf(c.get_config("model"), (H, W), N_IMAGES),
            tl.loss_config_from_conf(c.get_config("loss")))


def port_step(a: dict, draws, shard=None, device="cpu") -> dict:
    """The port's map_step with BA on the case, fresh seed-0 weights:
    {"terms", "params" (after the step), "grads" (as the Adam step read
    them), "q", "voxels"} as numpy."""
    import torch

    from nicer_slam_tpu_torch.models import scene_model as tsm
    from nicer_slam_tpu_torch.slam import mapping as tmap
    from nicer_slam_tpu_torch.slam import state as tstate

    tcfg, tloss = port_configs()
    dev = torch.device(device)
    T = lambda x: torch.from_numpy(np.asarray(x)).to(dev)
    model = tsm.SceneModel(tcfg, np.random.default_rng(0)).to(dev)
    opt = tstate.make_optimizer(tstate.OptimConfig(**OPTIM), model)
    grads = {}

    def keep(_opt, _args, _kwargs):
        for n, p in model.named_parameters():
            if p.grad is not None:
                grads[n] = p.grad.detach().cpu().numpy().copy()

    hook = opt.register_step_pre_hook(keep)
    refs = tmap.MapBatchRefs(
        slot_rows=T(SLOT_ROWS), frame_ids=T(FRAME_IDS), n_valid=2, intrinsics=T(a["intr"]),
        edge_idii=T(np.array([0, 1])), edge_idjj=T(np.array([1, 0])), flow_imgs=T(a["flows"]),
        flow_occ=T(a["occ"]), slot_conf=T(SLOT_CONF))
    store = tmap.FrameData(*(T(a[k]) for k in ("rgb", "depth", "normal", "gt_depth", "mask")))
    pix, rd = draws
    draws = tmap.MapDraws(pix.to(dev), tsm.RenderDraws(*(None if t is None else t.to(dev)
                                                          for t in rd)))
    vox, q, terms = tmap.map_step(
        tcfg, tmap.MapConfig(num_pixels=R, max_slots=SMAX, BA_cam_lr=1e-3), tloss, model,
        opt, T(a["vox"]), T(a["q"]), refs, store, draws, T(a["cache"].reshape(-1)), None,
        stage="fine", color_stage="highfreq", ba=True, is_first_frame=False, shard=shard)
    hook.remove()
    return {"terms": {k: v.cpu().numpy() for k, v in terms.items()},
            "params": {n: p.detach().cpu().numpy() for n, p in model.named_parameters()},
            "grads": grads, "q": q.cpu().numpy(), "voxels": vox.cpu().numpy()}


def worker(rank: int, world: int, init_method: str, in_path: str, out_dir: str,
           mode: str, min_entries: int, repeats: int, device: str = "cpu") -> None:
    """One gloo rank: the case's step ``repeats`` times from fresh weights,
    each result saved to ``out_dir/rank<rank>.pt``."""
    import torch

    from nicer_slam_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_process_group(rank, world, init_method, backend="gloo")
    try:
        blob = torch.load(in_path, weights_only=False)
        shard = mesh.ray_shard(mode, min_entries=min_entries)
        outs = [port_step(blob["arrays"], blob["draws"], shard, device)
                for _ in range(repeats)]
        torch.save(outs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def run_ranks(in_path: str, out_dir: str, world: int = 2, mode: str = "replicated",
              min_entries: int = 1 << 22, repeats: int = 1, device: str = "cpu") -> list:
    """Spawn ``world`` gloo ranks on the case; returns each rank's list of
    results."""
    import torch
    import torch.multiprocessing as mp

    init = "file://" + os.path.join(out_dir, "store")
    mp.start_processes(worker, args=(world, init, in_path, out_dir, mode, min_entries,
                                     repeats, device),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
