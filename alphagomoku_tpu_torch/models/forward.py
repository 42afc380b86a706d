"""The network as the searches evaluate it, for every architecture.

`network_apply(net)` returns the `(net_apply, variables)` pair that
`search.mcts.run_search`, self-play, the openings, match play and the
engine take (`net_apply(variables, planes) -> NetOutput`):

- the convnext trunk: `ops.convnext_fused.fused_apply` on a
  `pack_weights` snapshot, the trunk kernel on the card at every width
  and every board up to 20x20 (`convnext_fused.trunk_plan`: widths between
  built ones on zero channels padded to the next, C = 128 above 252 cells
  on the cluster entry, 129 to 256 on the wide entry, above 256 the
  streamed entry at the next multiple of 64);
- every other trunk: `module_apply` on `networks.snapshot(net)`, the
  module's own `forward`, as the reference package calls `net.apply` for
  them (its engine and trainer run those trunks outside any Pallas
  kernel).

The choice is made by the network's configuration alone.  Either way the
variables are a detached copy: training `net` afterwards changes neither,
and `net` keeps its train/eval mode.  Take a new pair after an optimizer
step.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..ops import convnext_fused as CF
from .networks import AGNetwork, NetOutput, snapshot

__all__ = ["network_apply", "net_apply_for", "module_apply"]


def module_apply(variables: AGNetwork, planes: torch.Tensor) -> NetOutput:
    """`net_apply` of a `snapshot`: its inference forward."""
    return variables(planes)


def net_apply_for(cfg) -> Callable:
    """The `net_apply` of a network of ModelConfig `cfg`: the fused trunk
    for the convnext trunk, the module's forward for every other trunk."""
    return CF.fused_apply if cfg.trunk == "convnext" else module_apply


def network_apply(net: AGNetwork) -> tuple[Callable, Any]:
    """`(net_apply, variables)` of `net` for the searches (`net_apply_for`
    its configuration)."""
    apply = net_apply_for(net.cfg)
    return apply, (CF.pack_weights(net) if apply is CF.fused_apply else snapshot(net))
