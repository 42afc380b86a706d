"""Device mesh and shardings for the learner and the self-play actors.

Port of the reference package's `parallel/sharding.py` over
`torch.distributed`: one process per device (one GPU each, NCCL; or CPU
processes, gloo), joined by `parallel.distributed.initialize`.  The mesh
is a `DeviceMesh` with a data-parallel axis `dp` and a tensor-parallel
axis `tp`.  Where the reference package hands GSPMD sharding annotations,
the port names placements (`Shard`, `Replicate`) and slices tensors
itself: a batch sharded over `dp` is each rank's slice of it.  A step at
tp > 1 is not ported (`parallel.distributed.TP_NOT_PORTED`); the learner
and the actors run at tp = 1, as the reference package's manager does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, tp: int = 1):
    """DeviceMesh over the process group, `("dp", "tp")` of shape
    (n / tp, tp); `n_devices` must be the world size (one device per
    process).  `parallel.distributed.initialize` must have run."""
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
    return init_device_mesh(_mesh_device_type(), (n // tp, tp), mesh_dim_names=("dp", "tp"))


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
