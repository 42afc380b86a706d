"""Device mesh and shardings for the learner and the self-play actors.

Port of the reference package's `parallel/sharding.py` over
`torch.distributed`: one process per device (one GPU each, NCCL; or CPU
processes, gloo), joined by `parallel.distributed.initialize`.  The mesh
is a `DeviceMesh` with a data-parallel axis `dp` and a tensor-parallel
axis `tp`.  Where the reference package hands GSPMD sharding annotations,
the port names placements (`Shard`, `Replicate`) and slices tensors
itself: a batch sharded over `dp` is each rank's slice of it, and a
state placed by `param_shardings(tensor_parallel=True)` holds, on each
rank, its tp slice of every sharded leaf (`local_state`, `shard_state_`;
back with `gather_state`, `full_state_dict`).  The step at tp > 1 runs
the sharded layers column-parallel (`models/blocks.py` `ParallelLayer`,
`parallel.distributed.make_dp_train_step`).  The mesh's device type is the
tensors': gloo carries CUDA tensors too (two processes on one card).
"""

from __future__ import annotations

from typing import Any

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


def _mesh_device_type(device: str | torch.device | None) -> str:
    """The type of the tensors the mesh's ranks hold: `device`'s, else the
    card's where there is one (the port runs on the card unless asked for
    the CPU), whatever the backend: gloo carries CUDA tensors too."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(n_devices: int | None = None, tp: int = 1, device: str | torch.device | None = None):
    """DeviceMesh over the process group, `("dp", "tp")` of shape
    (n / tp, tp); `n_devices` must be the world size (one device per
    process; under gloo, processes may share a card).  `device` is where
    the ranks' tensors live (`_mesh_device_type`).
    `parallel.distributed.initialize` must have run."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.distributed.initialize() first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"the mesh spans every process, one device each: n_devices={n_devices} "
                         f"but the world size is {n}")
    if n % tp != 0:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return init_device_mesh(_mesh_device_type(device), (n // tp, tp),
                            mesh_dim_names=("dp", "tp"))


def mesh_size(mesh, name: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def mesh_device(mesh) -> torch.device:
    """This rank's device of the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh) -> tuple:
    """Leading-axis data sharding for env/sample batches: the placements
    over (dp, tp)."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def _flax_last_axis_dim(key: str, shape: tuple, blocks: dict) -> tuple[tuple, int]:
    """(flax shape, torch dim holding flax's last axis) of the state_dict
    entry `key` of torch shape `shape`, from `models/convert.py`'s layout
    mapping: flax's last axis is the output channel, dim 0 of a torch conv
    or dense weight."""
    from ..models import convert

    path = convert._flax_path(key, blocks)
    leaf, kind = path[-1], convert._kind(path[-2])
    flax_shape = convert._flax_layout(leaf, kind, np.empty(shape, np.float32)).shape
    if not flax_shape:
        return flax_shape, 0
    # each element holds its index along flax's last axis; the torch dim
    # along which that index moves is the one sharded
    probe = np.broadcast_to(np.arange(flax_shape[-1], dtype=np.float32), flax_shape).copy()
    laid = convert._layout(leaf, kind, probe)
    for d in range(laid.ndim):
        if laid.shape[d] > 1 and not (np.diff(laid, axis=d) == 0).all():
            return flax_shape, d
    return flax_shape, 0


def param_shardings(mesh, params: dict[str, torch.Tensor], tensor_parallel: bool) -> dict:
    """Placements over (dp, tp) for each entry of a network's state_dict
    (or of its named parameters): replicated, or, when tensor_parallel,
    the output channels of conv/dense kernels over `tp`.  The choice is
    the reference package's rule on the flax shape: a kernel of two or more
    axes whose last (output-channel) axis divides by the tp size is
    sharded, every other leaf is replicated; the torch dim sharded is the
    one that holds flax's last axis."""
    from torch.distributed.tensor import Replicate, Shard

    from ..models import convert

    tp_size = mesh_size(mesh, "tp")
    blocks = convert._block_names(params)
    out = {}
    for key, t in params.items():
        flax_shape, dim = _flax_last_axis_dim(key, tuple(t.shape), blocks)
        if tensor_parallel and len(flax_shape) >= 2 and flax_shape[-1] % tp_size == 0:
            out[key] = (Replicate(), Shard(dim))
        else:
            out[key] = (Replicate(), Replicate())
    return out


def shard_batch(mesh, batch: Any) -> Any:
    """This rank's slice of a host batch (a dict of tensors or arrays),
    split over dp on the leading axis, on the rank's device."""
    dp = mesh_size(mesh, "dp")
    rank = mesh.get_local_rank("dp")
    dev = mesh_device(mesh)

    def one(x):
        x = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        return x.tensor_split(dp)[rank].to(dev)

    return {k: one(v) for k, v in batch.items()}


def _tp_dim(placement) -> int | None:
    """The tensor dim a (dp, tp) placement shards over tp, or None."""
    from torch.distributed.tensor import Shard

    tp = placement[1]
    return tp.dim if isinstance(tp, Shard) else None


def local_state(mesh, state: dict[str, torch.Tensor], placements: dict) -> dict:
    """This rank's tensors of a full state dict under `param_shardings`'
    placements: each entry sharded over tp, its tp rank's slice of the
    sharded dim (`tensor_split` into the tp size); every other entry as it
    is."""
    size, rank = mesh_size(mesh, "tp"), mesh.get_local_rank("tp")
    out = {}
    for key, t in state.items():
        dim = _tp_dim(placements[key])
        out[key] = t if dim is None else t.tensor_split(size, dim)[rank].contiguous()
    return out


def gather_state(mesh, local: dict[str, torch.Tensor], placements: dict) -> dict:
    """The full state dict from each rank's `local_state`: the sharded
    entries all-gathered over tp (a collective every tp rank calls), the
    others as they are."""
    group, size = mesh.get_group("tp"), mesh_size(mesh, "tp")
    out = {}
    for key, t in local.items():
        dim = _tp_dim(placements[key])
        if dim is None:
            out[key] = t
            continue
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out[key] = torch.cat(parts, dim)
    return out


class Shards(NamedTuple):
    """What `shard_state_` placed a network under: the mesh and the
    placements of its state_dict entries."""

    mesh: Any
    placements: dict


def shard_state_(state, mesh, placements: dict | None = None) -> None:
    """Place a train state (`training.train.TrainState`) in place as
    `placements` (by default `param_shardings(mesh, ...,
    tensor_parallel=True)`): each sharded parameter and buffer, and the
    optimizer's moments of each sharded parameter, keep this rank's tp
    slice; the network remembers the placements (`full_state_dict`)."""
    net = state.net
    if placements is None:
        placements = param_shardings(mesh, net.state_dict(), tensor_parallel=True)
    full = dict(net.named_parameters())
    full.update(net.named_buffers())
    local = local_state(mesh, {k: t.detach() for k, t in full.items()}, placements)
    size, rank = mesh_size(mesh, "tp"), mesh.get_local_rank("tp")
    opt = state.opt_state
    with torch.no_grad():
        for i, (key, _) in enumerate(net.named_parameters()):
            dim = _tp_dim(placements[key])
            if dim is not None:
                opt.mu[i] = opt.mu[i].tensor_split(size, dim)[rank].contiguous()
                opt.nu[i] = opt.nu[i].tensor_split(size, dim)[rank].contiguous()
        for key, t in full.items():
            t.data = local[key]
    net.tp_shards = Shards(mesh, placements)


def full_state_dict(net) -> dict[str, torch.Tensor]:
    """The network's whole state dict: where `shard_state_` placed it, its
    ranks' slices gathered over tp (a collective every tp rank calls);
    otherwise `net.state_dict()`."""
    shards = getattr(net, "tp_shards", None)
    if shards is None:
        return net.state_dict()
    local = {k: t.detach() for k, t in net.state_dict().items()}
    return gather_state(shards.mesh, local, shards.placements)
