"""Final-move selector family over finished search roots.

Port of the reference package's `search/selectors.py` (reference:
src/search/monte_carlo/EdgeSelector.cpp:680+ create registry): the in-tree
policy (PUCT + init-to + noise) lives in mcts._edge_utility; this module
provides the *final* selectors applied to the root when a move must be
produced — best (visits+value with proven-score overrides), max_visit,
min_visit, max_value, max_policy, lcb, and balanced (minimize
|expectation - 0.5|, used by opening balancing / swap2, reference:
BalancedSelector).  Ties go to the first slot, as `jnp.argmax` gives them.
"""

from __future__ import annotations

import torch

from . import mcts
from . import score as S


def _root_edges(state: mcts.SearchState):
    tree = state.tree
    rb = torch.arange(tree.batch, device=state.root_board.device)
    root = state.root_node
    actions = tree.edge_action[rb, root]
    es = mcts.edge_stats(tree, rb, root)
    visits = es.visits.float()
    prior = tree.edge_prior[rb, root].float()
    valid = actions != mcts.NULL
    q = es.q_win + 0.5 * es.q_draw
    return rb, actions, visits, q, es.score, prior, valid


def _pick(state: mcts.SearchState, rb, actions, util: torch.Tensor,
          valid: torch.Tensor) -> torch.Tensor:
    h, w = state.root_board.shape[1], state.root_board.shape[2]
    slot = torch.argmax(torch.where(valid, util, float("-inf")), dim=-1)
    return actions[rb, slot].long().clamp(0, h * w - 1)


def select(state: mcts.SearchState, policy: str = "best",
           generator: torch.Generator | None = None, temperature: float = 0.0) -> torch.Tensor:
    """Pick a root move [B] (flat action index) with the named selector
    (reference: EdgeSelectorConfig policy strings, utils/configs.hpp:67-87)."""
    rb, actions, visits, q, escore, prior, valid = _root_edges(state)
    if policy in ("best", "max_balance"):  # default play selector
        return mcts.select_move(state, generator, temperature)
    if policy == "max_visit":
        return _pick(state, rb, actions, visits, valid)
    if policy == "min_visit":
        return _pick(state, rb, actions, -visits, valid & (visits > 0))
    if policy == "max_value":
        dist = S.get_distance(escore).float()
        util = torch.where(S.is_win(escore), 1000.0 - dist, q)
        util = torch.where(S.is_loss(escore), -1000.0 + dist, util)
        return _pick(state, rb, actions, util, valid & (visits > 0))
    if policy == "max_policy":
        return _pick(state, rb, actions, prior, valid)
    if policy == "lcb":
        # lower confidence bound: conservative final pick (reference:
        # LCBSelector + LCB op, EdgeSelector.cpp:446-470,1340-1346)
        n_parent = state.tree.node_visits[rb, state.root_node].float()
        u = 1.25 * torch.sqrt(torch.log(n_parent.clamp(min=1.0))[:, None] / (1.0 + visits))
        dist = S.get_distance(escore).float()
        util = torch.where(S.is_loss(escore), -1.0e6 + dist + prior, q - u)
        return _pick(state, rb, actions, util, valid & (visits > 0))
    if policy == "balanced":
        # closest-to-draw evaluation among visited moves, never a proven
        # win/loss (reference: BalancedSelector for swap2/opening balance)
        util = torch.where(S.is_proven(escore), -1000.0, -(q - 0.5).abs())
        return _pick(state, rb, actions, util, valid & (visits > 0))
    raise ValueError(f"unknown selector policy {policy!r}")
