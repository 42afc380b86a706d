"""Learnable tree policy: a small MLP over per-edge statistics, the root
selection policy of `MCTSConfig(policy="learnable")`.

Port of the reference package's `search/tree_policy.py`, the counterpart
of the reference's LearnablePolicySelector (reference:
src/search/monte_carlo/EdgeSelector.cpp:735-860, EdgeSelector.hpp:50-65):
an 8 -> 64 -> 64 -> 1 ReLU MLP whose input rows are [log10(parent
visits), parent win rate, parent draw rate, log10(1 + edge visits),
log10(max(1e-6, prior)), edge win rate, edge draw rate, 1.0].  The
parameters are plain tensors (`TreePolicyParams`, weights [in, out] as
the reference package lays them out; `models/convert.py`
`tree_policy_from_jax` carries its pytree across); `make_train_step`
distills finished searches: the MLP learns to rank root edges by their
final visit share.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

FEATURES = 8
HIDDEN = 64


class TreePolicyParams(NamedTuple):
    w1: torch.Tensor  # [8, 64]
    b1: torch.Tensor  # [64]
    w2: torch.Tensor  # [64, 64]
    b2: torch.Tensor  # [64]
    w3: torch.Tensor  # [64, 1]
    b3: torch.Tensor  # [1]

    def to(self, device) -> "TreePolicyParams":
        return TreePolicyParams(*(t.to(device) for t in self))


def init_params(generator: torch.Generator, device="cpu") -> TreePolicyParams:
    """He-normal weights (std sqrt(2 / fan_in)) and zero biases, as the
    reference package's initialiser draws them, from `generator`."""

    def dense(fan_in, fan_out):
        w = torch.randn((fan_in, fan_out), generator=generator, device=generator.device)
        return (w * math.sqrt(2.0 / fan_in)).to(device)

    zeros = lambda n: torch.zeros(n, device=device)
    return TreePolicyParams(
        w1=dense(FEATURES, HIDDEN), b1=zeros(HIDDEN),
        w2=dense(HIDDEN, HIDDEN), b2=zeros(HIDDEN),
        w3=dense(HIDDEN, 1), b3=zeros(1),
    )


def edge_features(
    parent_visits: torch.Tensor,  # [B]
    parent_wdl: torch.Tensor,  # [B, 2] (win, draw) rates
    edge_visits: torch.Tensor,  # [B, K] float
    prior: torch.Tensor,  # [B, K]
    edge_win: torch.Tensor,  # [B, K]
    edge_draw: torch.Tensor,  # [B, K]
) -> torch.Tensor:
    """The 8 per-edge input features [B, K, 8] (reference feature packing:
    EdgeSelector.cpp:795-810)."""
    k = edge_visits.shape[-1]
    bcast = lambda x: x[:, None].expand(x.shape[0], k)
    return torch.stack([
        bcast(torch.log10(parent_visits.clamp(min=1.0))),
        bcast(parent_wdl[..., 0]),
        bcast(parent_wdl[..., 1]),
        torch.log10(1.0 + edge_visits),
        torch.log10(prior.clamp(min=1.0e-6)),
        edge_win,
        edge_draw,
        torch.ones_like(edge_visits),
    ], dim=-1)


def apply(params: TreePolicyParams, feats: torch.Tensor) -> torch.Tensor:
    """[..., 8] features -> [...] scores (the reference's 3-gemm forward,
    EdgeSelector.cpp:816-822)."""
    h = torch.relu(feats @ params.w1 + params.b1)
    h = torch.relu(h @ params.w2 + params.b2)
    return (h @ params.w3 + params.b3)[..., 0]


def make_train_step(learning_rate: float = 1e-3):
    """SGD step distilling final root visit shares: the cross-entropy
    between the MLP's softmax over edges and the search's visit
    distribution.  `step(params, feats [B, K, 8], target [B, K], valid
    [B, K]) -> (new params, loss)`."""

    def loss_fn(params, feats, target, valid):
        logits = torch.where(valid, apply(params, feats), float("-inf"))
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.where(valid, target * logp, 0.0).sum(-1)
        return ce.mean()

    def step(params: TreePolicyParams, feats, target, valid):
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            loss = loss_fn(TreePolicyParams(*leaves), feats, target, valid)
            grads = torch.autograd.grad(loss, leaves)
        new = TreePolicyParams(*(p.detach() - learning_rate * g for p, g in zip(leaves, grads)))
        return new, loss.detach()

    return step


def training_batch_from_state(state):
    """(feats, visit-share target, valid) at the root of a finished search,
    for `make_train_step`."""
    from . import mcts as _mcts

    tree = state.tree
    b = torch.arange(tree.batch, device=state.root_node.device)
    root = state.root_node
    es = _mcts.edge_stats(tree, b, root)
    visits = es.visits.float()
    valid = tree.edge_action[b, root] != _mcts.NULL
    prior = tree.edge_prior[b, root].float()
    n_parent = tree.node_visits[b, root].float()
    parent_wdl = tree.node_value_sum[b, root] / n_parent.clamp(min=1.0)[..., None]
    feats = edge_features(n_parent, parent_wdl, visits, prior, es.q_win, es.q_draw)
    target = torch.where(valid, visits, 0.0)
    target = target / target.sum(-1, keepdim=True).clamp(min=1e-9)
    return feats, target, valid
