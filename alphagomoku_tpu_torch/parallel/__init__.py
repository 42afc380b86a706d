from .sharding import (
    make_mesh,
    batch_sharding,
    replicated,
    param_shardings,
    shard_batch,
)

__all__ = ["make_mesh", "batch_sharding", "replicated", "param_shardings", "shard_batch"]

from . import distributed
__all__.append("distributed")
