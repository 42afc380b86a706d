from .sharding import (
    make_mesh,
    batch_sharding,
    replicated,
    param_shardings,
    shard_batch,
    local_state,
    gather_state,
    shard_state_,
    full_state_dict,
)

__all__ = ["make_mesh", "batch_sharding", "replicated", "param_shardings", "shard_batch",
           "local_state", "gather_state", "shard_state_", "full_state_dict"]

from . import distributed
__all__.append("distributed")
