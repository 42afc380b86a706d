"""Carry the reference package's flax weights over to the port.

`from_flax` takes the flax `{"params", "batch_stats"}` tree (nested dicts
of numpy arrays, as `utils/checkpoint.load` or `flax.serialization`
return them) and returns a `state_dict` for `networks.AGNetwork`, with the
layouts converted: conv kernels HWIO -> OIHW (depthwise (7, 7, 1, C) ->
(C, 1, 7, 7)), dense kernels (in, out) -> (out, in), BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .networks import AGNetwork, create_network

# top-level flax scopes -> module attributes of AGNetwork
_TOP = {
    "ConvBN_0": "stem",
    "PolicyHead_0": "policy",
    "PolicyHead_1": "soft_policy",
    "ValueHead_0": "value",
    "ActionValuesHead_0": "q",
    "MovesLeftHead_0": "moves_left",
}
_HEAD_MLP = {"Conv_0": "conv", "Dense_0": "fc1", "BatchNorm_0": "bn", "Dense_1": "fc2"}
_HEAD_CONV = {"ConvBN_0": "conv_bn", "Conv_0": "out"}
# (parent flax module type, child scope) -> child attribute
_CHILD = {
    "ConvNextBlock": {
        "Conv_0": "dw", "BatchNorm_0": "bn", "Conv_1": "pw1", "Conv_2": "pw2",
        "SqueezeExcitation_0": "se",
    },
    "SqueezeExcitation": {"Dense_0": "fc1", "Dense_1": "fc2"},
    "ConvBN": {"Conv_0": "conv", "BatchNorm_0": "bn"},
    "PolicyHead": _HEAD_CONV,
    "ActionValuesHead": _HEAD_CONV,
    "ValueHead": _HEAD_MLP,
    "MovesLeftHead": _HEAD_MLP,
}
_LEAF = {
    ("Conv", "kernel"): "conv.weight", ("Conv", "bias"): "conv.bias",
    ("Dense", "kernel"): "linear.weight", ("Dense", "bias"): "linear.bias",
    ("BatchNorm", "scale"): "weight", ("BatchNorm", "bias"): "bias",
    ("BatchNorm", "mean"): "running_mean", ("BatchNorm", "var"): "running_var",
}


def _kind(scope: str) -> str:
    return re.sub(r"_\d+$", "", scope)


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(scopes: tuple[str, ...], leaf: str) -> str:
    first = scopes[0]
    m = re.fullmatch(r"ConvNextBlock_(\d+)", first)
    parts = ["blocks", m.group(1)] if m else [_TOP[first]]
    for parent, child in zip(scopes, scopes[1:]):
        parts.append(_CHILD[_kind(parent)][child])
    parts.append(_LEAF[(_kind(scopes[-1]), leaf)])
    return ".".join(parts)


def _layout(leaf: str, scope_kind: str, a: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and scope_kind == "Conv":
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and scope_kind == "Dense":
        return a.T  # (in, out) -> (out, in)
    return a


def from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree -> AGNetwork state_dict."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, a in _flatten(variables[coll]):
            scopes, leaf = path[:-1], path[-1]
            arr = _layout(leaf, _kind(scopes[-1]), np.asarray(a, np.float32))
            out[_torch_key(scopes, leaf)] = torch.from_numpy(np.array(arr, copy=True))
    return out


def network_from_flax(
    variables: dict, arch: str = "ConvNextPVQMraw", rows: int = 15, cols: int = 15
) -> AGNetwork:
    """An AGNetwork of `arch` sized from the weights (blocks, filters) with
    the flax weights loaded."""
    params = variables["params"]
    blocks = sum(1 for k in params if k.startswith("ConvNextBlock_"))
    filters = int(np.asarray(params["ConvBN_0"]["Conv_0"]["kernel"]).shape[-1])
    net = create_network(arch, blocks=blocks, filters=filters, rows=rows, cols=cols)
    net.load_state_dict(from_flax(variables))
    return net.eval()
