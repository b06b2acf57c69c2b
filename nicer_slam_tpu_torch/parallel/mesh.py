"""Ray-parallel mapping over ``torch.distributed`` (counterpart of
nicer_slam_tpu/parallel/mesh.py).

The JAX package shards the rays of a mapping step across a device mesh,
keeps every table and the frame store replicated, and lets GSPMD insert
the one collective the step needs, an all-reduce of the gradients. Here
the same split is explicit, one process per device:

  * every rank draws the step's *global* draws from the same generator
    state and keeps its contiguous slice of rays (``RayShard.rays``), so
    the step's numbers are those of one process on all rays;
  * the voxel counter's increment is all-reduced between its update and
    the density's read of it, within the forward (``sum_counts``; whole
    counts below 2^24 add exactly, so every rank's counter equals the
    one-process counter bit for bit);
  * the loss stack runs on every rank on the per-ray outputs of all ranks
    (``gather_rays``, whose backward keeps the rank's own rows: each rank
    then holds the gradient of its own rays), and a replicated input
    (the SDF at the cameras) passes ``replicated``, whose backward divides
    by the world size;
  * after ``backward()`` one sum all-reduce of every parameter gradient
    and of the BA pose gradient (``allreduce_grads``), so every rank holds
    the same bits and takes the same Adam and sign steps.

``DistributedDataParallel`` would do neither the forward exchanges nor
the eikonal terms' second-order backward, so it is not used.

Collective modes for the gradient all-reduce (the JAX package's
``enable_grid_collectives``): ``replicated`` (float32, the JAX default)
and ``psum_bf16`` (the colour grid's gradient, a table of at least
``GRID_SHARD_MIN_ENTRIES`` rows, all-reduced in bfloat16 and cast back;
the SDF grids and the MLPs stay in float32). The JAX package's ``sharded``
mode (the table and its Adam moments row-sharded) is not ported yet.

The K1/K2 table gradient is summed in 64-bit fixed point on each rank and
converted to float32 there; the ranks' float32 gradients are then summed
by the all-reduce, which adds one rounding per rank to the one-process
sum (the bounds of tests/test_torch_parallel.py hold it; an int64
all-reduce of the accumulator would make it bit-equal at twice the
bytes).

Process groups: ``init_process_group`` reads the ``torchrun`` environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or takes rank, world size and
an ``init_method`` (``tcp://localhost:<port>``, ``file://<path>``). NCCL
serves CUDA ranks, gloo CPU ranks; gloo also takes CUDA tensors for the
all-reduce, which is the only collective used here, so two gloo ranks can
share one card. Gathers are all-reduces of zero-padded buffers for that
reason (a row plus zeros is the row; the rows are small next to the
gradients).
"""

from __future__ import annotations

import os
from typing import Iterable, NamedTuple, Optional

import torch
import torch.distributed as dist

# the JAX package's collective modes; "sharded" is not ported yet
COLLECTIVE_MODES = ("replicated", "psum_bf16")
# the smallest table (rows) whose gradient psum_bf16 all-reduces in bf16
# (nicer_slam_tpu/ops/hash_encoder.py GRID_SHARD_MIN_ENTRIES)
GRID_SHARD_MIN_ENTRIES = 1 << 22


def check_mode(mode: str) -> None:
    if mode == "sharded":
        raise ValueError("collective mode 'sharded' (the colour grid and its Adam "
                         "moments row-sharded, bf16 all-gather forward and "
                         "reduce-scatter backward) is not in the port yet; use "
                         "'replicated' or 'psum_bf16'")
    if mode not in COLLECTIVE_MODES:
        raise ValueError(f"unknown grid collective mode: {mode}")


def init_process_group(rank: Optional[int] = None, world_size: Optional[int] = None,
                       init_method: Optional[str] = None, backend: Optional[str] = None,
                       device: str = "cuda") -> None:
    """Join the process group: from the torchrun environment when rank and
    world size are not given, else from them and ``init_method``. The
    backend defaults to NCCL for a CUDA device and gloo for the CPU."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


class RayShard(NamedTuple):
    """This rank's share of a step's rays, and the gradient collective mode."""

    rank: int
    world: int
    mode: str = "replicated"
    min_entries: int = GRID_SHARD_MIN_ENTRIES

    def rays(self, R: int):
        """(lo, hi): this rank's contiguous slice of R rays."""
        if R % self.world:
            raise ValueError(f"{R} rays do not split over {self.world} ranks")
        n = R // self.world
        return self.rank * n, (self.rank + 1) * n


def ray_shard(mode: str = "replicated",
              min_entries: int = GRID_SHARD_MIN_ENTRIES) -> RayShard:
    """This process's shard of the initialised process group."""
    check_mode(mode)
    return RayShard(dist.get_rank(), dist.get_world_size(), mode, min_entries)


def _sum(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_gather_rows(x: torch.Tensor, shard: RayShard, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, through a sum all-reduce of a zero-padded buffer."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * shard.world
    buf = x.new_zeros(shape)
    buf.narrow(dim, shard.rank * n, n).copy_(x)
    return _sum(buf)


class _GatherRays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim, ctx.n = shard, dim, x.shape[dim]
        return all_gather_rows(x.detach().contiguous(), shard, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.shard.rank * ctx.n, ctx.n), None, None


def gather_rays(x: torch.Tensor, shard: RayShard, dim: int = 0) -> torch.Tensor:
    """All ranks' rows of a per-ray output along ``dim``; the backward
    keeps this rank's rows of the cotangent (every rank evaluates the same
    loss on the gathered rows, and each differentiates its own rays)."""
    if x.dtype == torch.bool:
        return all_gather_rows(x.to(torch.uint8).contiguous(), shard, dim).to(torch.bool)
    return _GatherRays.apply(x, shard, dim)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None


def replicated(x: torch.Tensor, shard: RayShard) -> torch.Tensor:
    """``x`` as it is, computed alike on every rank; its backward divides
    by the world size, so the gradient all-reduce counts it once."""
    return _Replicated.apply(x, shard.world)


def sum_counts(before: torch.Tensor, after: torch.Tensor) -> torch.Tensor:
    """The voxel counter with every rank's visits: ``before`` plus the sum
    over ranks of ``after - before`` (whole counts: exact)."""
    return before + _sum((after - before).contiguous())


def bf16_tables(model: torch.nn.Module, shard: RayShard) -> set:
    """The parameters whose gradient ``psum_bf16`` all-reduces in bf16:
    the colour grid's table (K2's), when it has ``shard.min_entries`` rows
    or more."""
    if shard.mode != "psum_bf16":
        return set()
    render = getattr(model, "render", None)
    table = getattr(render, "encoding", None)
    if table is None or table.shape[0] < shard.min_entries:
        return set()
    return {id(table)}


def allreduce_grads(params: Iterable[torch.Tensor], shard: RayShard,
                    bf16: Optional[set] = None) -> int:
    """Sum every parameter's gradient over the ranks, in place (``bf16``:
    ids of the parameters all-reduced in bfloat16); returns the bytes each
    rank contributed."""
    sent = 0
    for p in params:
        g = p.grad
        if g is None:
            continue
        if bf16 and id(p) in bf16:
            h = _sum(g.to(torch.bfloat16))
            g.copy_(h.to(g.dtype))
            sent += h.numel() * h.element_size()
        else:
            _sum(g)
            sent += g.numel() * g.element_size()
    return sent
