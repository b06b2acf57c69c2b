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
    (but a row shard's, below) and of the BA pose gradient
    (``allreduce_grads``), so every rank holds the same bits and takes the
    same Adam and sign steps.

``DistributedDataParallel`` would do neither the forward exchanges nor
the eikonal terms' second-order backward, so it is not used.

Collective modes for the colour grid (the JAX package's
``enable_grid_collectives``), each for a table of at least
``GRID_SHARD_MIN_ENTRIES`` rows: ``replicated`` (the gradients all-reduced
in float32, the JAX default); ``psum_bf16`` (the colour grid's gradient
all-reduced in bfloat16 and cast back; the SDF grids and the MLPs stay in
float32); ``sharded`` (``shard_color_grid``: each rank keeps its
contiguous T / N rows of the table, so torch's Adam keeps its moments at
the shard's shape too; the forward all-gathers the rows in bf16 and
encodes from them with K3, the backward scatters the rank's cotangents
into a full-size gradient with K2's backward on the bf16 rows and a bf16
reduce-scatter brings the summed rows to their owners,
``ops/hash_encoder.hash_encode_sharded``). Where ``sharded_applies`` is
false (one rank, a table under the threshold, rows or points that do not
divide over the ranks: 133,023,682 rows at four ranks) the mode takes the
replicated path, as the JAX package does, and ``shard_color_grid`` says so.

The bytes a rank sends (``sent_bytes``, by purpose) follow a ring: an
all-reduce of B bytes sends 2 (N - 1) / N B, an all-gather or a
reduce-scatter of a B-byte whole (N - 1) / N B. NCCL serves the rows'
all-gather and reduce-scatter with ``all_gather_into_tensor`` and
``reduce_scatter_tensor``; gloo with a sum all-reduce of a zero-padded
buffer (``COLLECTIVE_SERVED``), twice the bytes.

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
all-reduce, which is the only collective used with it, so two gloo ranks
can share one card. The per-ray gathers are all-reduces of zero-padded
buffers under either backend (a row plus zeros is the row; the rows are
small next to the gradients).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, NamedTuple, Optional

import torch
import torch.distributed as dist

# the JAX package's collective modes (nicer_slam_tpu/parallel/mesh.py
# enable_grid_collectives)
COLLECTIVE_MODES = ("replicated", "psum_bf16", "sharded")
# the smallest table (rows) that psum_bf16 and sharded take
# (nicer_slam_tpu/ops/hash_encoder.py GRID_SHARD_MIN_ENTRIES)
GRID_SHARD_MIN_ENTRIES = 1 << 22
# backend -> the collective that serves the bf16 rows' all-gather and
# reduce-scatter
COLLECTIVE_SERVED = {
    "nccl": {"all_gather": "all_gather_into_tensor", "reduce_scatter": "reduce_scatter_tensor"},
    "gloo": {"all_gather": "all_reduce of a zero-padded buffer",
             "reduce_scatter": "all_reduce, then the rank's rows"},
}
# purpose -> bytes this rank sent since reset_sent()
_SENT: Dict[str, int] = {}


def check_mode(mode: str) -> None:
    if mode not in COLLECTIVE_MODES:
        raise ValueError(f"unknown grid collective mode: {mode}")


def sharded_applies(rows: int, n_points: int, world: int,
                    min_entries: int = GRID_SHARD_MIN_ENTRIES) -> bool:
    """Whether the ``sharded`` mode shards a table of ``rows`` rows that
    encodes ``n_points`` points (over all ranks) on ``world`` ranks: the
    JAX package's ``_collective_mode_applies(spec, "sharded", n_points)``
    on a mesh of ``world`` devices."""
    return (world > 1 and rows >= min_entries and n_points % world == 0
            and rows % world == 0)


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


def reset_sent() -> None:
    _SENT.clear()


def sent_bytes() -> Dict[str, int]:
    """Bytes this rank sent since ``reset_sent``, by purpose: ``grads``
    (the gradient all-reduce), ``counts`` (the voxel visits), ``rays`` (the
    per-ray outputs), ``grid_gather`` and ``grid_reduce_scatter`` (the
    sharded colour grid's rows)."""
    return dict(_SENT)


def _count(purpose: str, t: torch.Tensor, world: int, all_reduce: bool) -> None:
    nbytes = t.numel() * t.element_size()
    sent = (2 if all_reduce else 1) * (world - 1) * nbytes // world
    _SENT[purpose] = _SENT.get(purpose, 0) + sent


def _sum(t: torch.Tensor, purpose: str, world: int) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    _count(purpose, t, world, all_reduce=True)
    return t


def _native() -> bool:
    return dist.get_backend() == "nccl"


def all_gather_rows(x: torch.Tensor, shard: RayShard, dim: int = 0,
                    purpose: str = "rays") -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, through a sum all-reduce of a zero-padded buffer."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * shard.world
    buf = x.new_zeros(shape)
    buf.narrow(dim, shard.rank * n, n).copy_(x)
    return _sum(buf, purpose, shard.world)


def gather_table_rows(rows: torch.Tensor, shard: RayShard) -> torch.Tensor:
    """The whole table ``[N·n, C]`` from each rank's contiguous ``[n, C]``
    rows, in their dtype (the sharded encode passes bf16):
    ``all_gather_into_tensor`` under NCCL, else a zero-padded all-reduce."""
    rows = rows.contiguous()
    if not _native():
        return all_gather_rows(rows, shard, 0, "grid_gather")
    out = rows.new_empty((rows.shape[0] * shard.world, *rows.shape[1:]))
    dist.all_gather_into_tensor(out, rows)
    _count("grid_gather", out, shard.world, all_reduce=False)
    return out


def reduce_scatter_rows(full: torch.Tensor, shard: RayShard) -> torch.Tensor:
    """This rank's ``[T / N, C]`` rows of the sum over the ranks of
    ``full`` ``[T, C]``, summed in its dtype (the sharded encode passes
    bf16): ``reduce_scatter_tensor`` under NCCL, else an all-reduce of the
    whole and the rank's rows of it."""
    full = full.contiguous()
    n = full.shape[0] // shard.world
    if not _native():
        return _sum(full, "grid_reduce_scatter", shard.world).narrow(0, shard.rank * n, n)
    out = full.new_empty((n, *full.shape[1:]))
    dist.reduce_scatter_tensor(out, full, op=dist.ReduceOp.SUM)
    _count("grid_reduce_scatter", full, shard.world, all_reduce=False)
    return out


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
    return before + _sum((after - before).contiguous(), "counts", dist.get_world_size())


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


def _color_grid_rows(model: torch.nn.Module) -> int:
    """The colour grid's rows, whole (0 without a colour grid)."""
    render = getattr(model, "render", None)
    if getattr(render, "encoding", None) is None:
        return 0
    return render.spec.total_entries


def _shards(model: torch.nn.Module, shard: RayShard) -> bool:
    # every rank encodes as many points (its equal share of the rays), so
    # the points over all ranks are a multiple of the world size
    rows = _color_grid_rows(model)
    return (shard.mode == "sharded" and rows > 0
            and sharded_applies(rows, shard.world, shard.world, shard.min_entries))


def sharded_tables(model: torch.nn.Module, shard: RayShard) -> set:
    """The parameters the ``sharded`` mode holds as row shards: the colour
    grid's table where ``sharded_applies``, else none. Their gradients
    arrive summed by the reduce-scatter, so ``allreduce_grads`` skips
    them; ``shard_color_grid`` must have cut the table first."""
    if not _shards(model, shard):
        return set()
    render = model.render
    if getattr(render, "color_shard", None) is None:
        raise ValueError("collective mode 'sharded': call mesh.shard_color_grid(model, shard) "
                         "before building the optimizer")
    return {id(render.encoding)}


def shard_color_grid(model: torch.nn.Module, shard: RayShard) -> int:
    """Under the ``sharded`` mode, replace the colour grid's ``[T, C]``
    table by this rank's contiguous ``[T / N, C]`` rows (a new parameter:
    call before building the optimizer, whose Adam moments then take the
    shard's shape); the render net's ``color_shard`` routes its encode
    through ``hash_encode_sharded``. Where ``sharded_applies`` is false the
    table stays whole and the mode takes the replicated path, as the JAX
    package does; a line says so. Returns the number of tables sharded
    (``sharded_tables``' count: 0 or 1)."""
    if shard.mode != "sharded":
        return 0
    rows = _color_grid_rows(model)
    if not _shards(model, shard):
        why = ("no colour grid" if rows == 0 else
               f"{shard.world} rank" if shard.world <= 1 else
               f"{rows} rows < {shard.min_entries}" if rows < shard.min_entries else
               f"{rows} rows do not split over {shard.world} ranks")
        print(f"[mesh] collective mode sharded: sharded_tables: 0 ({why}); the colour grid "
              f"takes the replicated path", flush=True)
        return 0
    render = model.render
    n = rows // shard.world
    with torch.no_grad():
        rows_mine = render.encoding[shard.rank * n:(shard.rank + 1) * n].clone()
    render.encoding = torch.nn.Parameter(rows_mine)
    render.color_shard = shard
    return 1


def all_gather_shard(rows: torch.Tensor, shard: RayShard) -> torch.Tensor:
    """The whole float32 tensor from each rank's rows (the sharded table or
    its gradient), for the checks: outside the step, not counted."""
    out = rows.new_zeros((rows.shape[0] * shard.world, *rows.shape[1:]))
    out.narrow(0, shard.rank * rows.shape[0], rows.shape[0]).copy_(rows.detach())
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def full_color_grid(model: torch.nn.Module, shard: Optional[RayShard] = None) -> torch.Tensor:
    """The colour grid's whole float32 ``[T, C]`` table: gathered from the
    ranks where ``shard_color_grid`` cut it (every rank must call), else
    the parameter itself."""
    render = model.render
    if shard is None or getattr(render, "color_shard", None) is None:
        return render.encoding.detach()
    return all_gather_shard(render.encoding, shard)


def allreduce_grads(params: Iterable[torch.Tensor], shard: RayShard,
                    bf16: Optional[set] = None, skip: Optional[set] = None) -> int:
    """Sum every parameter's gradient over the ranks, in place (``bf16``:
    ids of the parameters all-reduced in bfloat16; ``skip``: ids of the
    row shards, whose gradients the reduce-scatter summed); returns the
    bytes this rank sent."""
    before = _SENT.get("grads", 0)
    for p in params:
        g = p.grad
        if g is None or (skip and id(p) in skip):
            continue
        if bf16 and id(p) in bf16:
            g.copy_(_sum(g.to(torch.bfloat16), "grads", shard.world).to(g.dtype))
        else:
            _sum(g, "grads", shard.world)
    return _SENT.get("grads", 0) - before
