"""The sharded colour encode's test case (tests/test_torch_sharded.py):
the JAX collective-modes test's grid (tests/_grid_collectives_main.py:
33-37) and inputs drawn with numpy, for the gloo ranks the test spawns
and for the JAX package's two-device step in
tests/_torch_sharded_jax_main.py. Importing this module imports neither
torch nor jax.
"""

from __future__ import annotations

import os

import numpy as np

# the grid of tests/_grid_collectives_main.py: 4 levels x 2 channels,
# 2^13-row hashed levels, 26,176 rows; its thresholds lowered to 2^12 so
# that the grid takes the collective modes
SPEC = dict(num_levels=4, level_dim=2, base_resolution=8, log2_hashmap_size=13,
            desired_resolution=64)
MIN_ENTRIES = 1 << 12
WORLD = 2
N = 64 * WORLD


def inputs() -> dict:
    """The table ([C, T], the JAX layout), points [N, 3] and output
    weights [N, L·C], as tests/_grid_collectives_main.py draws them."""
    from nicer_slam_tpu_torch.ops import hash_encoder as he

    spec = he.make_spec(3, **SPEC)
    rng = np.random.default_rng(0)
    emb = rng.uniform(-1e-2, 1e-2, (spec.level_dim, spec.total_entries)).astype(np.float32)
    x = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    w_out = rng.normal(size=(N, spec.num_levels * spec.level_dim)).astype(np.float32)
    return {"emb": emb, "x": x, "w_out": w_out}


def encode_worker(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """One gloo rank: the sum of w_out · hash_encode_sharded(x) over this
    rank's points and its gradient; rank 0 saves the loss over all ranks,
    the whole table gradient ([T, C]), the points' gradient and the bytes
    sent to ``out_dir/sharded.npz``."""
    import torch
    import torch.distributed as dist

    from nicer_slam_tpu_torch.ops import hash_encoder as he
    from nicer_slam_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_process_group(rank, world, init_method, backend="gloo")
    try:
        a = inputs()
        spec = he.make_spec(3, **SPEC)
        shard = mesh.RayShard(rank, world, "sharded", MIN_ENTRIES)
        rows = spec.total_entries // world
        table = torch.from_numpy(np.ascontiguousarray(a["emb"].T))
        mine = torch.nn.Parameter(table[rank * rows:(rank + 1) * rows].clone())
        lo, hi = shard.rays(N)
        x = torch.from_numpy(a["x"][lo:hi]).requires_grad_(True)
        mesh.reset_sent()
        feats = he.hash_encode_sharded(spec, mine, x, shard)
        loss = (feats * torch.from_numpy(a["w_out"][lo:hi])).sum()
        loss.backward()
        sent = mesh.sent_bytes()
        total = mesh.all_gather_shard(loss.detach().reshape(1, 1), shard).sum()
        g_table = mesh.all_gather_shard(mine.grad, shard)
        g_x = mesh.all_gather_shard(x.grad, shard)
        if rank == 0:
            np.savez(os.path.join(out_dir, "sharded.npz"), loss=total.numpy(),
                     g_table=g_table.numpy(), g_x=g_x.numpy(),
                     **{f"sent_{k}": v for k, v in sent.items()})
    finally:
        dist.destroy_process_group()


def run_encode_ranks(out_dir: str, world: int = WORLD) -> dict:
    """Spawn ``world`` gloo ranks on the case; returns rank 0's arrays."""
    import torch.multiprocessing as mp

    init = "file://" + os.path.join(out_dir, "store")
    mp.start_processes(encode_worker, args=(world, init, out_dir), nprocs=world, join=True,
                       start_method="spawn")
    with np.load(os.path.join(out_dir, "sharded.npz")) as z:
        return dict(z)
