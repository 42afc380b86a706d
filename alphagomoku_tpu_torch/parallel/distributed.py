"""Multi-process bring-up, per-rank data ingest and the DP learner step.

Port of the reference package's `parallel/distributed.py` over
`torch.distributed`: one process per device, NCCL between GPUs, gloo
between CPU processes.

- `initialize()` wraps `init_process_group`: a coordinator address
  (`host:port`, or any init URL such as `file://...`), the process count
  and this process's id, or, with none of them, torchrun's environment.
- self-play is embarrassingly parallel: each rank plays its own batch on
  its device from its own generator (`host_fold`), with no cross-rank
  traffic, and ingests only its own games into its local `ReplayBuffer`.
- the learner is data-parallel: every rank samples a local sub-batch,
  `global_batch_from_local` marks it as its slice of the global batch, and
  `make_dp_train_step` runs the train step so that it computes what one
  process computes on the concatenated global batch: BatchNorm moments
  and loss denominators are the global batch's, each rank's loss is its
  part of the global loss, and the gradients are all-reduce-SUMMED.  The
  replicated train state (parameters, BatchNorm statistics, optimizer
  moments) stays bitwise identical on every rank.
- on a (dp, tp) mesh the tp ranks of one dp coordinate take the same
  slice of the batch.  With a replicated state they run the same step;
  with a state placed by `param_shardings(tensor_parallel=True)`
  (`sharding.shard_state_`) the sharded layers are column-parallel
  (`models.blocks.ParallelLayer`): each rank computes its slice of their
  output channels and all-gathers them (`_GatherTP`: backward takes this
  rank's slice), their input entering through `_EnterTP` (backward
  all-reduces over tp), so the rest of the step is replicated.
- checkpoint/metadata files are written by the coordinator only
  (`is_coordinator`), with `barrier()` ordering writers before readers.

`make_rl_round` packages one actor -> learner round: self-play of
`batch_per_host` boards on each dp coordinate, `make_targets`, one train
step over the mesh."""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..game import vectorized as V
from ..models import blocks
from ..search import mcts
from ..selfplay import SelfplayConfig, make_targets, play_games
from ..training import train as T
from .sharding import make_mesh, mesh_device, mesh_size


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Bring up the process group: NCCL when the card is there, gloo
    otherwise (or `backend`).  `coordinator_address` is `host:port` (TCP)
    or an init URL (`file:///path` for a shared file); with no arguments
    the address, world size and rank come from torchrun's environment
    (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`).  Under NCCL each
    process takes the card of its `LOCAL_RANK` (else its rank modulo the
    cards it sees) as its current device."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend)
    else:
        url = coordinator_address if "://" in coordinator_address else (
            f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the process that owns file writes (checkpoints, metadata)."""
    return process_index() == 0


def fold_seed(seed: int, *data: int) -> int:
    """A generator seed (63 bits) derived from `seed` and the integers
    `data`: the first 64-bit word of numpy's `SeedSequence([seed, *data])`,
    shifted right by one.  Distinct `data` give independent streams."""
    word = np.random.SeedSequence([int(seed), *(int(d) for d in data)]).generate_state(
        1, np.uint64)[0]
    return int(word >> np.uint64(1))


def dp_fold(mesh, seed: int) -> int:
    """Per-dp-coordinate generator seed: `fold_seed(seed, dp rank)`.  The
    tp ranks of one dp coordinate draw alike (they hold one slice of the
    batch); at tp = 1 the dp rank is the process's rank, and this is
    `host_fold(seed)`."""
    return fold_seed(seed, mesh.get_local_rank("dp"))


def host_fold(seed: int) -> int:
    """Per-rank generator seed: `fold_seed(seed, rank)`, folding this
    process's rank into a seed shared by every rank (the reference
    package's `fold_in(key, process_index)`; the port draws its own
    streams, so the draws are not the reference package's).  Use for
    rank-local randomness (self-play games, buffer sampling); never for a
    draw every rank must make alike (the train step's symmetries)."""
    return fold_seed(seed, process_index())


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (orders coordinator
    file writes before other ranks read them).  No-op single-process."""
    if process_count() > 1:
        dist.barrier()


class GlobalBatch(dict):
    """This rank's slice of a global batch: a dict of tensors on the rank's
    device, with the global batch's size and this slice's offset in it."""

    global_size: int
    offset: int


def global_batch_from_local(mesh, local_batch: dict) -> GlobalBatch:
    """Each rank passes its own `local_batch` (leading axis = per-rank
    batch, the same size on every rank); the result is that batch on the
    rank's device as its slice of the global batch of per-rank * dp
    samples (the reference package's globally sharded array)."""
    dev = mesh_device(mesh)
    out = GlobalBatch({k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(dev)
                       for k, v in local_batch.items()})
    local = len(next(iter(out.values())))
    out.global_size = local * mesh_size(mesh, "dp")
    out.offset = local * mesh.get_local_rank("dp")
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; its gradient is the sum of the ranks' output
    gradients (the gradient of the sum of the ranks' losses)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _EnterTP(torch.autograd.Function):
    """The input of a column-parallel layer (Megatron's f): the identity;
    its gradient, this rank's part from its slice of the channels, summed
    over the tp group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherTP(torch.autograd.Function):
    """The output of a column-parallel layer (Megatron's g): the tp ranks'
    slices joined along `dim` (all_gather); its gradient, this rank's
    slice of the whole output's (the same on every tp rank, as what
    follows runs replicated)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.size, ctx.rank = dim, size, rank
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.tensor_split(ctx.size, ctx.dim)[ctx.rank].contiguous(), None, None, None, None


def _tensor_parallel(mesh) -> blocks.TensorParallel:
    group, size, rank = mesh.get_group("tp"), mesh_size(mesh, "tp"), mesh.get_local_rank("tp")
    return blocks.TensorParallel(
        size, rank, lambda x: _EnterTP.apply(x, group),
        lambda y, dim: _GatherTP.apply(y, dim, group, size, rank))


def _all_reduce(group):
    def reduce(x: torch.Tensor) -> torch.Tensor:
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    return reduce


@contextlib.contextmanager
def _parallel(group, share: float, tp: blocks.TensorParallel | None = None):
    """For the length of one step: loss denominators and gradients summed
    over the dp `group` (`train._DP`), BatchNorm's moments the global
    batch's (`blocks.BatchNorm.sync_moments`): each rank's mean and E[x^2]
    weighted by its share of the global batch, then summed,
    differentiably; and, at tp > 1, the tp group for the column-parallel
    layers (`blocks.ParallelLayer.tensor_parallel`)."""

    def sync(mean, sq):
        both = _AllReduceSum.apply(torch.stack([mean, sq]) * share, group)
        return both[0], both[1]

    T._DP = T.DataParallel(_all_reduce(group), share)
    blocks.BatchNorm.sync_moments = sync
    blocks.ParallelLayer.tensor_parallel = tp
    try:
        yield
    finally:
        T._DP = None
        blocks.BatchNorm.sync_moments = None
        blocks.ParallelLayer.tensor_parallel = None


def make_dp_train_step(train_step: Callable, mesh) -> Callable:
    """A train step (`training.train.make_train_step`'s, or the distill
    step's) run over the mesh, data-parallel over its `dp` axis:
    `dp_step(state, [teacher,] batch, modes) -> (state, parts)`, where
    `batch` is this rank's `GlobalBatch` (the same on the tp ranks of one
    dp coordinate) and `modes` the symmetries of the whole global batch,
    drawn alike on every rank (each rank takes its slice).  The step's
    BatchNorm moments and loss denominators are the global batch's, its
    gradients are summed over the dp ranks, and `parts` are the global
    batch's losses, equal on every rank.  At tp > 1 a state placed by
    `sharding.shard_state_` runs its sharded layers column-parallel over
    tp; a replicated state runs the same step on every tp rank."""
    group = mesh.get_group("dp")
    dp = mesh_size(mesh, "dp")
    tp = _tensor_parallel(mesh) if mesh_size(mesh, "tp") > 1 else None

    def dp_step(state, *args):
        *extra, batch, modes = args
        local = len(next(iter(batch.values())))
        global_size = getattr(batch, "global_size", local * dp)
        offset = getattr(batch, "offset", local * mesh.get_local_rank("dp"))
        if modes is not None:
            modes = modes[offset:offset + local]
        with _parallel(group, local / global_size, tp):
            state, parts = train_step(state, *extra, batch, modes)
        names = list(parts)
        summed = _all_reduce(group)(torch.stack([parts[k] for k in names]))
        return state, dict(zip(names, summed.unbind(0)))

    return dp_step


def make_rl_round(
    net_apply: Callable,
    train_step: Callable,
    tables: V.RuleTables,
    mcfg: mcts.MCTSConfig,
    scfg: SelfplayConfig,
    batch_per_host: int,
    rows: int,
    cols: int,
    mesh=None,
    tp: int = 1,
):
    """One actor -> learner round over the mesh: each dp coordinate plays
    `batch_per_host` games on its device, turns them into targets
    (`make_targets`) and takes one train step (`make_dp_train_step`) on
    the global batch of every dp coordinate's samples; the train state
    may be replicated or placed by `sharding.shard_state_`.

    Returns (round_fn, mesh).  round_fn(variables_infer, train_state, seed)
    -> (train_state, loss_parts): `seed` must be the same on every rank;
    the games come from a generator seeded `dp_fold(mesh, fold_seed(seed,
    0))` (other games on each dp coordinate, the same on its tp ranks;
    at tp = 1 `host_fold`'s seed), the symmetries from one seeded
    `fold_seed(seed, 1)` (alike on every rank)."""
    if mesh is None:
        mesh = make_mesh(tp=tp)
    dp_step = make_dp_train_step(train_step, mesh)
    dev = mesh_device(mesh)

    def rl_round(variables_infer: Any, train_state: Any, seed: int):
        games = torch.Generator(device=dev).manual_seed(dp_fold(mesh, fold_seed(seed, 0)))
        result = play_games(net_apply, variables_infer, tables, mcfg, scfg, games,
                            batch_per_host, rows, cols, device=dev)
        batch = global_batch_from_local(mesh, make_targets(result, rows * cols))
        sym = torch.Generator(device=dev).manual_seed(fold_seed(seed, 1))
        modes = T.draw_modes(sym, batch.global_size, rows, cols)
        return dp_step(train_state, batch, modes)

    return rl_round, mesh
