"""Carry the reference package's flax weights over to the port.

`from_flax` takes the flax `{"params", "batch_stats"}` tree (nested dicts
of numpy arrays, as `utils/checkpoint.load` or `flax.serialization`
return them) and returns a `state_dict` for `networks.AGNetwork`, with the
layouts converted: conv kernels HWIO -> OIHW (depthwise (7, 7, 1, C) ->
(C, 1, 7, 7)), dense kernels (in, out) -> (out, in), BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var.  `to_flax`
is its inverse: a network's `state_dict` back to the flax tree, float32
numpy arrays in the flax layouts, which `utils/checkpoint.save` writes as
the reference package's checkpoint.  Both cover every trunk of the zoo:
the attention projections' kernels [C, heads, head_dim] (q/k/v) and
[heads, head_dim, C] (out) become dense (out, in) matrices, and a
positional embedding [1, H*W, C] is carried as it is.
`tree_policy_from_jax` carries the learnable tree policy's MLP weights.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .blocks import MoEConvNextBlock, TransformerBlock
from .networks import AGNetwork, create_network

# top-level flax scopes -> module attributes of AGNetwork (the trunk's
# blocks are `blocks.i`, see `_block_scopes`)
_TOP = {
    "ConvBN_0": "stem",
    "UnetTrunk_0": "unet",
    "PolicyHead_0": "policy",
    "PolicyHead_1": "soft_policy",
    "ValueHead_0": "value",
    "ActionValuesHead_0": "q",
    "MovesLeftHead_0": "moves_left",
}
# the flax module types of a block-stack trunk's blocks; a convnext_moe
# trunk is ConvNextBlock_0 ... ConvNextBlock_{L-2}, then MoEConvNextBlock_0
_BLOCKS = ("ResidualBlock", "BottleneckBlock", "ConvNextBlock", "MoEConvNextBlock",
           "TransformerBlock")
_HEAD_MLP = {"Conv_0": "conv", "Dense_0": "fc1", "BatchNorm_0": "bn", "Dense_1": "fc2"}
_HEAD_CONV = {"ConvBN_0": "conv_bn", "Conv_0": "out"}
_UNET_CONVS = 20  # ConvBNs of the conv UnetTrunk (the transformer one has 16)
_EXPERTS = MoEConvNextBlock.EXPERTS
# (parent flax module type, child scope) -> child attribute (a dotted
# attribute is an entry of a ModuleList)
_CHILD = {
    "ConvNextBlock": {
        "Conv_0": "dw", "BatchNorm_0": "bn", "Conv_1": "pw1", "Conv_2": "pw2",
        "SqueezeExcitation_0": "se",
    },
    "MoEConvNextBlock": {
        "Conv_0": "dw", "BatchNorm_0": "bn", "Conv_1": "router", "SqueezeExcitation_0": "se",
        **{f"Conv_{2 + 2 * e}": f"up.{e}" for e in range(_EXPERTS)},
        **{f"Conv_{3 + 2 * e}": f"down.{e}" for e in range(_EXPERTS)},
    },
    "ResidualBlock": {"ConvBN_0": "conv1", "ConvBN_1": "conv2"},
    "BottleneckBlock": {f"ConvBN_{n}": f"convs.{n}" for n in range(4)},
    "TransformerBlock": {
        "RMSNorm_0": "norm1", "SelfAttention_0": "attn", "RMSNorm_1": "norm2",
        "Dense_0": "fc1", "Dense_1": "fc2",
    },
    "SelfAttention": {name: name for name in ("query", "key", "value", "out")},
    "UnetTrunk": {
        **{f"ConvBN_{n}": f"convs.{n}" for n in range(_UNET_CONVS)},
        **{f"TransformerBlock_{n}": f"attn.{n}" for n in range(2)},
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
    ("RMSNorm", "scale"): "weight",
    ("TransformerBlock", "pos_embedding"): "pos_embedding",
    **{(p, leaf): f"linear.{attr}" for p in ("query", "key", "value", "out")
       for leaf, attr in (("kernel", "weight"), ("bias", "bias"))},
}


def _kind(scope: str) -> str:
    return re.sub(r"_\d+$", "", scope)


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _block_scopes(params: dict) -> list[str]:
    """The trunk's block scopes in block order."""
    found = [k for k in params if _kind(k) in _BLOCKS]
    return sorted(found, key=lambda k: (_kind(k) == "MoEConvNextBlock", int(k.rsplit("_", 1)[1])))


def _torch_key(scopes: tuple[str, ...], leaf: str, blocks: dict[str, int]) -> str:
    first = scopes[0]
    parts = ["blocks", str(blocks[first])] if first in blocks else [_TOP[first]]
    for parent, child in zip(scopes, scopes[1:]):
        parts.append(_CHILD[_kind(parent)][child])
    parts.append(_LEAF[(_kind(scopes[-1]), leaf)])
    return ".".join(parts)


def _layout(leaf: str, scope_kind: str, a: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and scope_kind == "Conv":
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and scope_kind == "Dense":
        return a.T  # (in, out) -> (out, in)
    if scope_kind in ("query", "key", "value"):  # [C, heads, d], [heads, d]
        return a.reshape(a.shape[0], -1).T if leaf == "kernel" else a.reshape(-1)
    if scope_kind == "out" and leaf == "kernel":  # [heads, d, C]
        return a.reshape(-1, a.shape[-1]).T
    return a


def from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree -> AGNetwork state_dict."""
    blocks = {scope: i for i, scope in enumerate(_block_scopes(variables["params"]))}
    out = {}
    for coll in ("params", "batch_stats"):
        for path, a in _flatten(variables[coll]):
            scopes, leaf = path[:-1], path[-1]
            arr = _layout(leaf, _kind(scopes[-1]), np.asarray(a, np.float32))
            out[_torch_key(scopes, leaf, blocks)] = torch.from_numpy(np.array(arr, copy=True))
    return out


def network_from_flax(
    variables: dict, arch: str = "ConvNextPVQMraw", rows: int = 15, cols: int = 15
) -> AGNetwork:
    """An AGNetwork of `arch` sized from the weights (blocks, filters) with
    the flax weights loaded."""
    params = variables["params"]
    blocks = len(_block_scopes(params))
    filters = int(np.asarray(params["ConvBN_0"]["Conv_0"]["kernel"]).shape[-1])
    net = create_network(arch, blocks=blocks or None, filters=filters, rows=rows, cols=cols)
    net.load_state_dict(from_flax(variables))
    return net.eval()


_TOP_INV = {attr: scope for scope, attr in _TOP.items()}
_CHILD_INV = {kind: {attr: scope for scope, attr in m.items()} for kind, m in _CHILD.items()}
_LEAF_INV = {(kind, attr): leaf for (kind, leaf), attr in _LEAF.items()}


def _block_kind(names: set[str]) -> str:
    """The flax module type of a block from its state_dict keys (below
    `blocks.i.`)."""
    if any(n.startswith("router.") for n in names):
        return "MoEConvNextBlock"
    if "pos_embedding" in names:
        return "TransformerBlock"
    if any(n.startswith("dw.") for n in names):
        return "ConvNextBlock"
    if any(n.startswith("convs.") for n in names):
        return "BottleneckBlock"
    return "ResidualBlock"


def _block_names(keys) -> dict[str, str]:
    """`blocks.i` -> its flax scope, numbered per module type in block
    order, as flax numbers them."""
    below: dict[int, set[str]] = {}
    for key in keys:
        parts = key.split(".", 2)
        if parts[0] == "blocks":
            below.setdefault(int(parts[1]), set()).add(parts[2])
    counts: dict[str, int] = {}
    names = {}
    for i in sorted(below):
        kind = _block_kind(below[i])
        names[f"blocks.{i}"] = f"{kind}_{counts.get(kind, 0)}"
        counts[kind] = counts.get(kind, 0) + 1
    return names


def _flax_path(key: str, blocks: dict[str, str]) -> tuple[str, ...]:
    """state_dict key -> (collection, scope, ..., leaf)."""
    parts = key.split(".")
    if parts[0] == "blocks":
        scopes, rest = [blocks[".".join(parts[:2])]], parts[2:]
    else:
        scopes, rest = [_TOP_INV[parts[0]]], parts[1:]
    while _kind(scopes[-1]) in _CHILD_INV:
        inv = _CHILD_INV[_kind(scopes[-1])]
        if ".".join(rest[:2]) in inv:
            scopes.append(inv[".".join(rest[:2])])
            rest = rest[2:]
        elif rest[0] in inv:
            scopes.append(inv[rest[0]])
            rest = rest[1:]
        else:
            break
    leaf = _LEAF_INV[(_kind(scopes[-1]), ".".join(rest))]
    return ("batch_stats" if leaf in ("mean", "var") else "params", *scopes, leaf)


def _flax_layout(leaf: str, scope_kind: str, a: np.ndarray) -> np.ndarray:
    """Inverse of `_layout`."""
    heads = TransformerBlock.HEADS
    if leaf == "kernel" and scope_kind == "Conv":
        return a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if leaf == "kernel" and scope_kind == "Dense":
        return a.T  # (out, in) -> (in, out)
    if scope_kind in ("query", "key", "value"):
        return a.T.reshape(a.shape[1], heads, -1) if leaf == "kernel" else a.reshape(heads, -1)
    if scope_kind == "out" and leaf == "kernel":
        return a.T.reshape(heads, -1, a.shape[0])
    return a


def to_flax(state_dict: dict[str, torch.Tensor]) -> dict:
    """AGNetwork state_dict -> flax {"params", "batch_stats"} tree of float32
    numpy arrays in flax's layouts (conv kernels OIHW -> HWIO, dense kernels
    (out, in) -> (in, out), attention projections back to their
    [C, heads, head_dim] / [heads, head_dim, C] kernels), each collection's
    keys sorted as in the reference package's checkpoints."""
    blocks = _block_names(state_dict)
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        path = _flax_path(key, blocks)
        a = t.detach().to("cpu", torch.float32).numpy()
        a = _flax_layout(path[-1], _kind(path[-2]), a)
        node = tree
        for scope in path[:-1]:
            node = node.setdefault(scope, {})
        node[path[-1]] = np.ascontiguousarray(a)

    def ordered(node):
        return {k: ordered(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    return {coll: ordered(sub) for coll, sub in tree.items()}


def tree_policy_from_jax(params, device="cpu"):
    """The reference package's `TreePolicyParams` pytree (fields w1, b1,
    w2, b2, w3, b3; arrays or numpy) -> the port's
    `search.tree_policy.TreePolicyParams` of float32 tensors on `device`
    (the same [in, out] layouts)."""
    from ..search.tree_policy import TreePolicyParams

    return TreePolicyParams(*(
        torch.from_numpy(np.asarray(getattr(params, name), np.float32).copy()).to(device)
        for name in TreePolicyParams._fields))
