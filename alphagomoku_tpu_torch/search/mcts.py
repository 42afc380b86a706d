"""Batched MCTS: fixed-capacity array trees, one tree per board, advanced
in lockstep by `leaf_batch` simulations per tree per step.

Port of the reference package's `search/mcts.py`, every configuration
value and keyword of it: all five rules; every in-tree policy (puct,
puct_fpu, puct_variance, ucb, lcb, thompson, bayes_ucb, kl_ucb and the
learnable tree policy, `tree_policy.py`) and `init_to` mode; `leaf_batch`
S >= 1 descents a step under virtual loss (S > 1: one evaluation of the
S * B leaves, the closed-form dedup and allocation, and the proven-score
backup of all paths through `ops/score_scan.py:score_backup_paths`); with
or without symmetry averaging; the NNUE leaf blend (`models/nnue.py`);
root move masks (`search/generators.py`); transpositions on (or off);
root noise of the three types (dirichlet, gumbel, custom) and the
between-move subtree carry-over of self-play (`reuse_or_init_root`); the
leaf solver off, `leaf_solver="vcf"` (`search/vcf.py`) or `"vct"` (the
engine default, `search/vct_batched.py`), with or without the loss prover
(`vct_batched.prepare_loss` / `finish_loss` at the leaves, `solve_loss` at
the roots).  `check_config` raises ValueError for a policy or `init_to`
name that no selector has.

Random numbers come in as tensors: `init_root`, `run_search` and
`reuse_or_init_root` take the root noise already drawn and `select_move`
the Gumbel draw of its temperature sampling, so that a caller can inject
any draws; `sample_root_noise` and `sample_gumbel` draw them from an
explicit `torch.Generator`.

Mapping to the reference (src/search/monte_carlo/{Tree,Search,Node,Edge,
EdgeSelector,EdgeGenerator}.cpp), as in the reference package:
- nodes and edges are struct-of-arrays `[B, N]` and `[B, N, K]` tensors;
  K = max_edges mirrors the reference's max_children pruning and a per-node
  `complete` flag records whether pruning dropped legal moves;
- PUCT selection is a masked argmax over the K edge slots, with proven
  edges pinned (EdgeSelector.cpp:389-424);
- edge visits and values are derived from the child node (graph-MCTS
  statistics through transpositions); edge scores are stored and
  minimax-updated in the backup (`ops/score_scan.py:score_backup` at
  S = 1, `score_backup_paths` at S > 1);
- transpositions: every node stores its 64-bit zobrist hash and expansion
  probes the existing nodes first, so the tree is a DAG.

The reference package's TPU workarounds are not semantics and are not
copied: its one-hot einsum reads and writes, byte-split bf16 integer
contractions and dynamic-update-slice blocks are gathers, `index_put_` and
slice writes here, with the same results.  The tree tensors are updated in
place (a search owns its tree), which keeps one copy of each in memory.

Types: packed Scores are int32, actions and child ids int32, priors bf16,
hashes int64 (two u32 lanes).  The descent runs exactly `max_depth`
levels (a finished row only writes NULL path entries, so this equals the
reference package's early-exit loop without a host sync per level).  The
allocation frontier is a host int, the largest node count of the batch:
it follows the step count, and `reuse_or_init_root` reads it from the
device once.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..game.types import CROSS, CIRCLE, GameOutcome
from ..game import vectorized as V
from ..models.networks import postprocess
from ..patterns import features as F
from ..utils import augment as AUG
from ..ops.score_scan import score_backup, score_backup_paths
from . import score as S
from . import static_solver
from . import vcf
from . import vct_batched
from . import zobrist

NULL = -1


class MCTSConfig(NamedTuple):
    """Search configuration (reference: utils/configs.hpp MCTSConfig +
    EdgeSelectorConfig + TreeConfig); same fields and defaults as the
    reference package."""

    max_nodes: int = 1024
    max_edges: int = 32
    max_depth: int = 48
    policy: str = "puct"
    exploration_constant: float = 1.25
    exploration_scaling: float = 0.0
    fpu_reduction: float = 0.25
    init_to: str = "parent"
    policy_expansion_temperature: float = 1.0
    noise_weight: float = 0.0
    noise_alpha: float = 0.1
    noise_type: str = "dirichlet"
    leaf_batch: int = 1
    use_transpositions: bool = True
    symmetry_averaging: bool = False
    leaf_solver: str = "none"
    leaf_solver_steps: int = 24
    leaf_solver_depth: int = 6
    leaf_solver_threes: int = 2
    leaf_solver_cap: int = 0
    loss_prover: bool = False
    loss_cap: int = 64
    loss_options: int = 8
    draw_after: int = 0


def check_config(cfg: MCTSConfig) -> None:
    """Raise ValueError for a policy or `init_to` name that no selector
    has, and for a degenerate tree."""
    if cfg.policy not in POLICIES:
        raise ValueError(f"MCTSConfig policy={cfg.policy!r} is not one of {POLICIES}")
    if cfg.init_to not in INIT_TO:
        raise ValueError(f"MCTSConfig init_to={cfg.init_to!r} is not one of {INIT_TO}")
    if cfg.max_nodes < 1 + max(1, cfg.leaf_batch) or cfg.max_edges < 1 or cfg.max_depth < 1:
        raise ValueError(f"degenerate MCTSConfig {cfg}")


class Tree(NamedTuple):
    """Struct-of-arrays search forest: B independent trees.  Values are
    (win, draw) pairs; edge stats from the PARENT's side-to-move view, node
    stats from the node's own view."""

    node_visits: torch.Tensor  # [B, N] int32
    node_value_sum: torch.Tensor  # [B, N, 2] f32
    node_score: torch.Tensor  # [B, N] int32 packed Score
    node_moves_left_sum: torch.Tensor  # [B, N] f32
    node_complete: torch.Tensor  # [B, N] bool: edges cover ALL legal moves
    edge_action: torch.Tensor  # [B, N, K] int32 (r*W + c; -1 empty slot)
    edge_child: torch.Tensor  # [B, N, K] int32 (-1 unexpanded)
    edge_prior: torch.Tensor  # [B, N, K] bf16
    edge_score: torch.Tensor  # [B, N, K] int32 packed Score
    edge_q_init: torch.Tensor  # [B, N, K] bf16 (q-head prior expectation)
    node_hash: torch.Tensor  # [B, N, 2] int64 (two u32 lanes)
    node_count: torch.Tensor  # [B] int32

    @property
    def batch(self) -> int:
        return self.node_visits.shape[0]

    @property
    def capacity(self) -> int:
        return self.node_visits.shape[1]


def init_tree(batch: int, cfg: MCTSConfig, device="cuda") -> Tree:
    n, k = cfg.max_nodes, cfg.max_edges
    dev = torch.device(device)
    full = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=dev)
    return Tree(
        node_visits=full((batch, n), 0, torch.int32),
        node_value_sum=full((batch, n, 2), 0.0, torch.float32),
        node_score=full((batch, n), S.zero(), torch.int32),
        node_moves_left_sum=full((batch, n), 0.0, torch.float32),
        node_complete=full((batch, n), False, torch.bool),
        edge_action=full((batch, n, k), NULL, torch.int32),
        edge_child=full((batch, n, k), NULL, torch.int32),
        edge_prior=full((batch, n, k), 0.0, torch.bfloat16),
        edge_score=full((batch, n, k), S.zero(), torch.int32),
        edge_q_init=full((batch, n, k), 0.0, torch.bfloat16),
        node_hash=full((batch, n, 2), 0, torch.int64),
        node_count=full((batch,), 0, torch.int32),
    )


class EdgeStats(NamedTuple):
    visits: torch.Tensor  # [..., K] int32 (0 for unexpanded edges)
    q_win: torch.Tensor  # [..., K] f32 parent-perspective win rate
    q_draw: torch.Tensor  # [..., K] f32 draw rate
    score: torch.Tensor  # [..., K] int32 stored packed score
    child: torch.Tensor  # [..., K] int64 child ids (-1 unexpanded)


def pack_node_stats(tree: Tree) -> torch.Tensor:
    """[B, N, 3] f32 (visits, win_sum, draw_sum): one gather per descent
    level reads all three (visit counts are exact in f32 up to 2^24)."""
    return torch.cat([tree.node_visits.float()[..., None], tree.node_value_sum], dim=-1)


def edge_stats_of_rows(
    tree: Tree, child: torch.Tensor, stored: torch.Tensor, packed: torch.Tensor | None = None
) -> EdgeStats:
    """Derived edge statistics for [B, K] child-id rows: visits/values come
    from the child node inverted to the parent's view; the score is the
    stored per-edge value."""
    child = child.long()
    has = child >= 0
    cs = child.clamp(0, tree.capacity - 1)
    if packed is None:
        packed = pack_node_stats(tree)
    st = packed.gather(1, cs[..., None].expand(-1, -1, 3))
    visits = torch.where(has, st[..., 0].int(), 0)
    denom = visits.float().clamp(min=1.0)
    w_c = st[..., 1] / denom
    d_c = st[..., 2] / denom
    q_win = torch.where(has, 1.0 - w_c - d_c, 0.0)
    q_draw = torch.where(has, d_c, 0.0)
    return EdgeStats(visits, q_win, q_draw, stored, child)


def edge_stats(
    tree: Tree, b: torch.Tensor, node: torch.Tensor, packed: torch.Tensor | None = None
) -> EdgeStats:
    """Derived edge statistics [B, K] for one node row per tree."""
    return edge_stats_of_rows(tree, tree.edge_child[b, node], tree.edge_score[b, node], packed)


POLICIES = ("puct", "puct_fpu", "puct_variance", "ucb", "lcb", "thompson", "kl_ucb",
            "bayes_ucb", "learnable")
INIT_TO = ("loss", "draw", "parent", "q_head")

# sqrt(2 * variance) of the bandit selectors' prior fits, in float32 as
# `jnp.sqrt` of the Python constant gives it (reference: fit_mean with
# variance 2 * 0.6, BayesUCB's best + prior = 20)
_THOMPSON_SCALE = float(np.sqrt(np.float32(2.0 * (0.6 + 0.6))))
_BAYES_SCALE = float(np.sqrt(np.float32(2.0 * 20.0)))


def needs_q_init(cfg: MCTSConfig) -> bool:
    """Whether the configuration reads the q head's per-edge expectation
    (`edge_q_init`) below the root."""
    return cfg.init_to == "q_head" or cfg.policy in ("puct_variance", "learnable")


def _fit_kl(p: torch.Tensor, t: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Upper-confidence q solving KL(p||q) = t by damped Newton iteration
    (reference: KLUCB::fit_kl, EdgeSelector.cpp:258-277; the reference's
    early exit at 1e-3 becomes a fixed number of iterations)."""
    eps = 1e-9

    def log_eps(x):
        return torch.log(x.clamp(min=eps))

    rhs = p * log_eps(p) + (1.0 - p) * log_eps(1.0 - p) - t
    q = 0.5 * (1.0 + p)
    for _ in range(iters):
        f = p * log_eps(q) + (1.0 - p) * log_eps(1.0 - q) - rhs
        df = (p - q) / (q * (1.0 - q)).clamp(min=eps)
        df = torch.where(df.abs() > 1e-12, df, -1e-12)
        step = 0.9 * (1.0 - q)
        q = (q - torch.maximum(-step, f / df)).clamp(eps, 1.0 - eps)
    return q


_U32 = 0xFFFFFFFF


def _mul_u32(acc: torch.Tensor, c: int) -> torch.Tensor:
    """acc * c modulo 2^32 for acc in [0, 2^32) held in int64: the product
    split at 16 bits of `c`, so that no int64 product overflows."""
    lo = acc * (c & 0xFFFF)
    hi = ((acc * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_uniform(*ints: torch.Tensor) -> torch.Tensor:
    """Deterministic pseudo-uniform f32 in [0, 1) from integer streams (the
    reference's thread-local randFloat() inside the step: the stream
    varies per node, slot and visit).  The reference package multiplies
    in uint32 with wrap-around; torch on the CPU has no uint32 arithmetic,
    so the lanes are int64 masked to 32 bits after every multiply and
    xor, which gives the same bits."""
    acc = torch.zeros(torch.broadcast_shapes(*(x.shape for x in ints)), dtype=torch.int64,
                      device=ints[0].device)
    for i, x in enumerate(ints):
        acc = _mul_u32(acc ^ (x.long() & _U32), 2654435761 + 2 * i)
        acc = acc ^ (acc >> 15)
    return (acc >> 8).float() / float(1 << 24)


def _edge_utility(
    tree: Tree, cfg: MCTSConfig, node: torch.Tensor, prior: torch.Tensor,
    vl: torch.Tensor | None = None, is_root: torch.Tensor | None = None, tp_params: Any = None,
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """In-tree edge utility [B, K] of the edges of `node` [B], per
    `cfg.policy` (reference: the EdgeSelector op family,
    EdgeSelector.cpp:129-470, registry :680-712).  `vl` [B, K] counts the
    virtual visits of the step's earlier descents; `is_root` [B] marks
    trees whose `node` is the root (where the learnable policy runs its
    MLP, `tp_params`); `packed` is `pack_node_stats(tree)` (the tree is
    frozen during select)."""
    if packed is None:
        packed = pack_node_stats(tree)
    b = torch.arange(tree.batch, device=node.device)
    es = edge_stats(tree, b, node, packed)
    visits = es.visits
    escore = es.score
    valid = tree.edge_action[b, node] != NULL
    prow = packed[b, node]
    n_parent = prow[:, 0]
    pv_sum = prow[:, 1:3]
    policy = cfg.policy
    if policy in ("puct", "puct_fpu", "puct_variance"):
        c_puct = cfg.exploration_constant + cfg.exploration_scaling * torch.log(
            n_parent.clamp(min=1.0))
    if policy == "thompson":
        # the bandit selectors hardcode this schedule in the reference
        # (EdgeSelector.cpp: "0.25f + 0.073f * std::log(...)")
        c_bandit = 0.25 + 0.073 * torch.log(n_parent.clamp(min=1.0))
    nf = visits.float()
    expectation = es.q_win + 0.5 * es.q_draw
    pn = n_parent.clamp(min=1.0)
    parent_q = ((pv_sum[:, 0] + 0.5 * pv_sum[:, 1]) / pn)[:, None]
    if policy == "puct_fpu":
        # first-play urgency: unvisited edges start below the parent value
        # (reference: PUCTfpuSelector, EdgeSelector.cpp:862-890)
        q_init = (parent_q - cfg.fpu_reduction).clamp(min=0.0)
    elif policy in ("puct_variance", "learnable") or cfg.init_to == "q_head":
        # q-head ops: unvisited edges read the network's action value
        # (reference: PUCT_q_head, EdgeSelector.cpp:343-388)
        q_init = tree.edge_q_init[b, node].float()
    elif cfg.init_to == "parent":
        q_init = parent_q
    elif cfg.init_to == "draw":
        q_init = 0.5
    else:  # loss
        q_init = 0.0
    q = torch.where(visits > 0, expectation, q_init)

    if vl is not None:
        # virtual loss across the step's descents (reference: Edge
        # virtual_loss + is_being_expanded, Edge.hpp:25,148-151): virtual
        # visits count as losses, and an unvisited edge an earlier descent
        # is expanding is strongly avoided
        vlf = vl.float()
        q = q * nf / (nf + vlf).clamp(min=1.0)
        q = torch.where((visits == 0) & (vl > 0), -1000.0, q)
        n_parent = n_parent + vlf.sum(-1)
        nf = nf + vlf

    if policy in ("ucb", "lcb"):
        # prior-free UCB1 (reference: UCBSelector, EdgeSelector.cpp:424+)
        u = cfg.exploration_constant * torch.sqrt(
            torch.log(n_parent.clamp(min=1.0))[:, None] / (1.0 + nf))
        if policy == "ucb":
            util = q + u
        else:
            # the LOWER confidence bound, with only LOSS pinned (reference:
            # LCB op, EdgeSelector.cpp:446-470)
            util = torch.where(visits > 0, q, parent_q) - u
            dist = S.get_distance(escore).float()
            util = torch.where(S.is_loss(escore), -1.0e6 + dist + prior, util)
            return torch.where(valid, util, float("-inf"))
    elif policy == "thompson":
        # ThompsonSamplingNormal with the variance term disabled (reference:
        # EdgeSelector.cpp:129-218): the mean plus an exploration term,
        # unvisited means fitted from the prior by the inverse error function
        fit0 = _THOMPSON_SCALE * torch.erfinv((2.0 * prior - 1.0).clamp(-0.999999, 0.999999))
        util = torch.where(visits > 0, q, fit0) + (
            prior * (c_bandit * torch.sqrt(n_parent))[:, None] / (1.0 + nf))
    elif policy == "bayes_ucb":
        # posterior quantile (reference: BayesUCB, EdgeSelector.cpp:278-342):
        # the visited quantile is the mean, unvisited edges fit the prior
        fit0 = _BAYES_SCALE * torch.erfinv((2.0 * prior - 1.0).clamp(-0.999999, 0.999999))
        util = torch.where(visits > 0, q, fit0)
    elif policy == "kl_ucb":
        # KL-UCB (reference: KLUCB op, EdgeSelector.cpp:215-277): visited
        # edges take the KL upper bound, unvisited ones a bernoulli boost
        # drawn from the prior
        t_kl = torch.log(n_parent.clamp(min=1.0))[:, None] / nf.clamp(min=1.0)
        q_kl = _fit_kl(q.clamp(0.0, 1.0), t_kl)
        u = prior / (1.0 + nf)
        rnd = _hash_uniform(node[:, None], torch.arange(visits.shape[-1], device=node.device),
                            n_parent.int()[:, None])
        unvisited = torch.where(rnd <= prior, 100.0 + prior, prior)
        util = torch.where(visits > 0, q_kl + u, unvisited)
    elif policy == "puct_variance":
        # exploration scaled by the dispersion of the visited edges' values
        # (reference: PUCTvarianceSelector::select, EdgeSelector.cpp:1255+)
        visited = (visits > 0) & valid
        vcount = visited.sum(-1).float()
        sum_visits = torch.where(visited, nf, 0.0).sum(-1)
        avg = torch.where(visited, expectation * nf, 0.0).sum(-1) / sum_visits.clamp(min=1.0)
        var = torch.where(visited, (expectation - avg[:, None]) ** 2 * nf, 0.0).sum(-1)
        scale = torch.where(
            vcount > 1.0,
            torch.sqrt(vcount * var / ((vcount - 1.0) * sum_visits).clamp(min=1.0)), 1.0)
        util = q + prior * (cfg.exploration_constant * scale)[:, None]
    elif policy == "learnable":
        # LearnablePolicySelector (reference: EdgeSelector.cpp:735-860): at
        # the root an MLP over 8 edge features, its logits sampled with a
        # visit-scaled temperature by Gumbel-max; below the root PUCT_q_head
        # with the reference's c = 0.4062 + 0.1585 * log(N)
        c_learn = 0.4062 + 0.1585 * torch.log(n_parent.clamp(min=1.0))
        util = q + prior * (c_learn * torch.sqrt(n_parent))[:, None] / (1.0 + nf)
        if tp_params is not None and is_root is not None:
            from . import tree_policy as TP

            feats = TP.edge_features(n_parent, pv_sum / pn[:, None], nf, prior, es.q_win,
                                     es.q_draw)
            logits = TP.apply(tp_params, feats)
            temp = (cfg.exploration_constant + cfg.exploration_scaling * torch.log10(
                n_parent.clamp(min=1.0))[:, None]).clamp(min=1e-3)
            rnd = _hash_uniform(node[:, None],
                                torch.arange(visits.shape[-1], device=node.device),
                                n_parent.int()[:, None])
            gumbel = -torch.log(-torch.log(rnd.clamp(1e-7, 1.0 - 1e-7)))
            util = torch.where(is_root[:, None], logits / temp + gumbel, util)
    else:  # the puct family
        util = q + prior * (c_puct * torch.sqrt(n_parent))[:, None] / (1.0 + nf)

    # proven edges pin the utility (reference: EdgeSelector.cpp:400-410)
    dist = S.get_distance(escore).float()
    util = torch.where(S.is_win(escore), 1000.0 - dist, util)
    util = torch.where(S.is_loss(escore), -1000.0 + dist, util)
    util = torch.where(S.is_draw(escore) & S.is_finite(escore), 0.5, util)
    return torch.where(valid, util, float("-inf"))


def select_edge(
    tree: Tree, cfg: MCTSConfig, node: torch.Tensor, prior: torch.Tensor,
    vl: torch.Tensor | None = None, is_root: torch.Tensor | None = None, tp_params: Any = None,
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """Best edge slot [B] of `node` [B] by the configured in-tree policy
    (the first maximum on ties)."""
    return torch.argmax(
        _edge_utility(tree, cfg, node, prior, vl, is_root, tp_params, packed), dim=-1)


# ---------------------------------------------------------------------------
# Expansion helpers
# ---------------------------------------------------------------------------


def _topk_edges(policy: torch.Tensor, legal: torch.Tensor, k: int, temperature: float):
    """Choose up to K edges by prior (reference: EdgeGenerator.cpp:269-303).

    policy [B, H, W] masked probabilities; returns (actions [B, K] int32,
    priors [B, K] f32 renormalized, complete [B] bool).  Equal values keep
    the lowest cell first (a stable descending sort), as `lax.top_k` does:
    ties are common, every legal cell whose policy underflows is clamped to
    1e-12 and every illegal one is -1."""
    bsz = policy.shape[0]
    flat = policy.reshape(bsz, -1)
    legal_flat = legal.reshape(bsz, -1)
    if temperature != 1.0:
        # in float64, rounded once: torch's float32 pow on the CPU rounds
        # some positions of a row differently from others (its vector loop
        # and its tail), which would split ties of equal priors
        flat = (flat.double() ** (1.0 / temperature)).float()
    flat = torch.where(legal_flat, flat.clamp(min=1e-12), -1.0)
    vals, idxs = torch.sort(flat, dim=-1, descending=True, stable=True)
    vals, idxs = vals[:, :k], idxs[:, :k]
    keep = vals > 0.0
    priors = torch.where(keep, vals, 0.0)
    priors = priors / priors.sum(-1, keepdim=True).clamp(min=1e-12)
    actions = torch.where(keep, idxs, NULL).to(torch.int32)
    complete = legal_flat.sum(-1) <= k
    return actions, priors, complete


def _edge_scores_from_analysis(
    board: torch.Tensor, analysis: static_solver.StaticAnalysis, actions: torch.Tensor
) -> torch.Tensor:
    """Static tactical scores [B, K] at the chosen edge actions
    (reference: Search.cpp:159-183, EdgeGenerator.cpp:23-124)."""
    bsz, h, w = board.shape
    flat = analysis.action_scores.reshape(bsz, h * w)
    escore = flat.gather(1, actions.long().clamp(0, h * w - 1))
    # the last empty cell is a draw-in-1 unless it wins
    last_cell = ((board == 0).sum((1, 2)) <= 1)[:, None]
    escore = torch.where(last_cell & ~S.is_proven(escore), S.draw_in(1), escore)
    return torch.where(actions != NULL, escore, S.zero())


def _win_solve(tables: V.RuleTables, cfg: MCTSConfig, board: torch.Tensor, stm: torch.Tensor,
               max_steps: int):
    """The configured leaf solver (`vcf`, else `vct`) on [R, H, W]: (win,
    best_move, distance) [R]."""
    if cfg.leaf_solver == "vcf":
        return vcf.solve(tables, board, stm, max_depth=cfg.leaf_solver_depth, max_steps=max_steps)
    return vct_batched.solve(tables, board, stm, max_depth=cfg.leaf_solver_depth,
                             max_steps=max_steps, max_threes=cfg.leaf_solver_threes)


def _opp_threats(packed: torch.Tensor) -> torch.Tensor:
    """[B]: the opponent of the side to move has a five, open-four or
    double-four cell (its pattern-group bits of the encoded features): the
    loss prover's candidates."""
    return (((packed >> 20) & (0b111 << 8)) != 0).flatten(1).any(-1)


def _solve(
    tables: V.RuleTables, cfg: MCTSConfig, board: torch.Tensor, stm: torch.Tensor,
    active: torch.Tensor, dtd: torch.Tensor, max_steps: int, cap: int = 0,
    packed: torch.Tensor | None = None,
):
    """The leaf solver on the positions [B, H, W] (reference: the
    alpha-beta leg run on every leaf batch, Search.cpp:159-183).

    With `0 < cap < B`, only `cap` positions are solved: the `active` ones
    with any threat cell of the side to move (own pattern-group bits of the
    encoded features `packed`) first, then the lowest-indexed others, as
    `lax.top_k` picks them from a 0/1 mask.  With the loss prover and the
    VCT solver, the `loss_cap` positions with opponent threats
    (`_opp_threats`, active ones first) get their loss proof's option
    children (`vct_batched.prepare_loss`) solved in the same lockstep
    batch (reference: the fail-low leg of the per-leaf alpha-beta,
    AlphaBetaSearch.cpp:91-135).
    Returns (win [B], best_move [B], win score [B], lost [B], loss score
    [B]); `win` holds only for `active` positions whose mate fits the draw
    horizon `dtd`, `lost` (None without the fused loss prover) only for
    positions not proven won whose loss fits it."""
    bsz = board.shape[0]
    compact = bool(cap) and cap < bsz
    if compact:
        interest = ((packed >> 8) & 0xFFF).ne(0).flatten(1).any(-1) & active
        sel = V.first_k(interest, cap)
        solve_board, solve_stm = board[sel], stm[sel]
    else:
        solve_board, solve_stm = board, stm
    fuse_loss = cfg.loss_prover and cfg.leaf_solver == "vct"
    if fuse_loss:
        lcap = max(1, min(int(cfg.loss_cap), bsz))
        cand_l = _opp_threats(packed) & active
        sel_l = V.first_k(cand_l, lcap)
        prep = vct_batched.prepare_loss(tables, board[sel_l], stm[sel_l], cfg.loss_options)
        n_win = solve_board.shape[0]
        # one solve of both legs: its rows are independent
        solve_board = torch.cat([solve_board, prep.child_board])
        solve_stm = torch.cat([solve_stm.to(torch.int8), prep.child_stm])
    win, best, dist = _win_solve(tables, cfg, solve_board, solve_stm, max_steps)
    if fuse_loss:
        shape = (lcap, cfg.loss_options)
        lres = vct_batched.finish_loss(prep, win[n_win:].reshape(shape),
                                       dist[n_win:].reshape(shape))
        win, best, dist = win[:n_win], best[:n_win], dist[:n_win]
    if compact:
        # scatter the compacted proofs back (top-k indices are distinct)
        win = torch.zeros(bsz, dtype=torch.bool, device=board.device).index_copy(0, sel, win)
        best = torch.full((bsz,), -1, dtype=torch.int32, device=board.device).index_copy(
            0, sel, best)
        dist = torch.zeros(bsz, dtype=torch.int32, device=board.device).index_copy(0, sel, dist)
    # a mate longer than the draw horizon is a draw, not a win
    win = win & active & (dist <= dtd)
    win_sc = S.win_in(dist.clamp(1, 512))
    if not fuse_loss:
        return win, best, win_sc, None, None
    lost, loss_sc = _scatter_losses(lres, cand_l, sel_l, dtd)
    return win, best, win_sc, lost & ~win, loss_sc


def _scatter_losses(lres: vct_batched.LossResult, cand: torch.Tensor, sel: torch.Tensor,
                    dtd: torch.Tensor):
    """The loss proofs of the candidate rows `sel` [L] scattered back to
    the batch: (lost [B], loss score [B]); a mate past the draw horizon
    `dtd` is a draw, not a loss."""
    lost_rows = lres.loss & cand[sel]
    dist = torch.zeros_like(dtd).index_copy(0, sel, torch.where(lost_rows, lres.distance, 0))
    lost = torch.zeros_like(cand).index_copy(0, sel, lost_rows) & (dist <= dtd)
    return lost, S.loss_in(dist.clamp(1, 512))


def _apply_proofs(analysis: static_solver.StaticAnalysis, policy: torch.Tensor,
                  win: torch.Tensor, best: torch.Tensor, win_sc: torch.Tensor):
    """A proven win scores the winning action and the node, and boosts the
    action's prior by 1 so expansion keeps it (UnifiedGenerator
    solver-edge precedence).  Win scores pack above every unproven code and
    shorter mates pack higher, so maximum keeps the strongest claim."""
    bsz = policy.shape[0]
    b = torch.arange(bsz, device=policy.device)
    idx = best.long().clamp(0, policy[0].numel() - 1)
    asf = analysis.action_scores.reshape(bsz, -1).clone()
    asf[b, idx] = torch.where(win, torch.maximum(asf[b, idx], win_sc), asf[b, idx])
    policy = policy.reshape(bsz, -1).clone()
    policy[b, idx] += win.to(policy.dtype)
    analysis = analysis._replace(
        action_scores=asf.reshape(analysis.action_scores.shape),
        node_score=torch.where(win, torch.maximum(analysis.node_score, win_sc),
                               analysis.node_score),
    )
    return analysis, policy.reshape(bsz, *analysis.action_scores.shape[1:])


def _evaluate(
    net_apply: Callable, variables: Any, tables: V.RuleTables, board, stm, raw_input: bool,
    sym_modes: torch.Tensor | None = None,
):
    """NN forward on [B, H, W] boards: (policy [B, H, W] masked probs, value
    (win, draw) [B, 2], q_expect [B, H, W], moves_left [B], legal mask,
    packed features).

    `sym_modes` [B] applies a per-sample board symmetry before the network
    and the inverse to the spatial outputs: random per-evaluation symmetry
    averaging (reference: NNEvaluator random augmentation + inverse unpack,
    NNEvaluator.cpp:134-141,263-286)."""
    packed = F.encode(tables, board, stm)
    packed_in = packed if sym_modes is None else F.augment_features_batch(packed, sym_modes)
    planes = F.unpack_raw_planes(packed_in) if raw_input else F.unpack_planes(packed_in)
    out = net_apply(variables, planes)
    if sym_modes is not None:
        q = out.q_logits
        out = out._replace(
            policy_logits=AUG.inverse_symmetry_batch(out.policy_logits, sym_modes),
            q_logits=(None if q is None else AUG.inverse_symmetry_batch(
                q.permute(0, 3, 1, 2), sym_modes).permute(0, 2, 3, 1)),
        )
    legal = ((packed & 1) == 1) & ~(((packed >> 6) & 1) == 1)
    ev = postprocess(out, legal)
    if ev.q is not None:
        q_expect = ev.q[..., 0] + 0.5 * ev.q[..., 1]
    else:
        q_expect = torch.zeros_like(ev.policy)
    if ev.moves_left is not None:
        moves_left = ev.moves_left
    else:
        moves_left = torch.zeros(ev.policy.shape[:1], dtype=torch.float32, device=legal.device)
    return ev.policy, ev.value[:, :2], q_expect, moves_left, legal, packed


# ---------------------------------------------------------------------------
# The simulation step
# ---------------------------------------------------------------------------


class SearchStats(NamedTuple):
    """Per-tree phase counters, [B] int32 each (reference:
    monte_carlo/Search.hpp:33-54)."""

    depth_sum: torch.Tensor
    expansions: torch.Tensor
    transpositions: torch.Tensor
    duplicates: torch.Tensor
    proven_revisits: torch.Tensor
    terminals: torch.Tensor
    solver_wins: torch.Tensor
    solver_losses: torch.Tensor

    @staticmethod
    def zeros(batch: int, device) -> "SearchStats":
        return SearchStats(*[
            torch.zeros(batch, dtype=torch.int32, device=device) for _ in range(8)
        ])

    def summary(self, sims) -> dict:
        """Host-side aggregate dict."""
        s = max(float(torch.as_tensor(sims).double().sum()), 1.0)
        f = lambda x: float(x.double().sum())
        out = {name: f(getattr(self, name)) for name in self._fields if name != "depth_sum"}
        return {"avg_depth": f(self.depth_sum) / s, **out}


class SearchState(NamedTuple):
    """Carry of the per-move search: tree + root position.  `frontier` is
    the host-side allocation frontier (the node count of every tree)."""

    tree: Tree
    root_board: torch.Tensor  # [B, H, W] int8
    root_stm: torch.Tensor  # [B] int8 side to move at root
    root_node: torch.Tensor  # [B] int64 index of the root node
    noisy_prior: torch.Tensor  # [B, K] f32 root priors
    sims_done: torch.Tensor  # [B] int32
    stats: SearchStats
    frontier: int


class _Sub(NamedTuple):
    """One descent of a step, [B] per tree: the leaf node it stopped at,
    the leaf position and its side to move, the plies taken, whether it
    ended on an unexpanded edge, the last move, and the path's nodes and
    slots [B, D] (NULL past its end) with its last entry."""

    leaf: torch.Tensor
    board: torch.Tensor
    stm: torch.Tensor
    steps: torch.Tensor
    need: torch.Tensor
    move_r: torch.Tensor
    move_c: torch.Tensor
    pn: torch.Tensor
    ps: torch.Tensor
    last_node: torch.Tensor
    last_slot: torch.Tensor


def _descend(
    tree: Tree, cfg: MCTSConfig, state: SearchState, packed_stats: torch.Tensor, tp_params: Any,
    prev_nodes: torch.Tensor | None, prev_slots: torch.Tensor | None,
) -> _Sub:
    """One descent of exactly `max_depth` levels from every root (reference:
    Tree::select, Tree.cpp:226-251); a finished row only writes NULL path
    entries.  `prev_nodes`, `prev_slots` [B, P] are the paths of the step's
    earlier descents, seen as virtual visits (reference: SearchTaskList
    batching, Search.cpp:117-158); None for the first."""
    bsz = tree.batch
    D = cfg.max_depth
    h, w = state.root_board.shape[1], state.root_board.shape[2]
    dev = state.root_board.device
    b = torch.arange(bsz, device=dev)
    cur = state.root_node.clone()
    boardc = state.root_board.clone()
    stm = state.root_stm.clone()
    steps = torch.zeros(bsz, dtype=torch.int32, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    need = torch.zeros_like(done)
    move_r = torch.zeros(bsz, dtype=torch.int64, device=dev)
    move_c = torch.zeros_like(move_r)
    pn = torch.full((bsz, D), NULL, dtype=torch.int64, device=dev)
    ps = torch.full_like(pn, NULL)
    if prev_nodes is not None:
        prev_k = prev_slots.clamp(min=0)
        vl0 = torch.zeros((bsz, cfg.max_edges), dtype=torch.int32, device=dev)
    for d in range(D):
        at_root = (cur == state.root_node)[:, None]
        prior = torch.where(at_root, state.noisy_prior, tree.edge_prior[b, cur].float())
        vl = None
        if prev_nodes is not None:
            vl = vl0.scatter_add(1, prev_k, (prev_nodes == cur[:, None]).int())
        slot = select_edge(tree, cfg, cur, prior, vl, at_root[:, 0], tp_params, packed_stats)
        action = tree.edge_action[b, cur, slot]
        child = tree.edge_child[b, cur, slot].long()
        stop = (done | (tree.edge_action[b, cur, 0] == NULL)
                | S.is_proven(tree.node_score[b, cur]))
        take = ~stop
        act = torch.where(take, action, 0).long()
        r = (act // w).clamp(0, h - 1)
        c = (act % w).clamp(0, w - 1)
        boardc[b, r, c] = torch.where(take, stm, boardc[b, r, c])
        move_r = torch.where(take, r, move_r)
        move_c = torch.where(take, c, move_c)
        other = torch.where(stm == CROSS, CIRCLE, CROSS).to(torch.int8)
        stm = torch.where(take, other, stm)
        hit_unexpanded = take & (child == NULL)
        done = stop | hit_unexpanded
        pn[:, d] = torch.where(take, cur, NULL)
        ps[:, d] = torch.where(take, slot, NULL)
        cur = torch.where(take & ~hit_unexpanded, child, cur)
        steps = steps + take.int()
        need = need | hit_unexpanded
    last_i = (steps.long() - 1).clamp(0, D - 1)
    last_node = torch.where(steps > 0, pn[b, last_i], NULL)
    last_slot = torch.where(steps > 0, ps[b, last_i], 0)
    return _Sub(cur, boardc, stm, steps, need, move_r, move_c, pn, ps, last_node, last_slot)


class _Leaves(NamedTuple):
    """The evaluation of the step's R = S * B leaves (sub-major)."""

    policy: torch.Tensor  # [R, H, W]
    value: torch.Tensor  # [R, 2]
    q_expect: torch.Tensor  # [R, H, W]
    moves_left: torch.Tensor  # [R]
    analysis: static_solver.StaticAnalysis
    terminal: torch.Tensor  # [R]
    term_score: torch.Tensor  # [R] the leaf's own view
    solver_win: torch.Tensor  # [R]
    solver_loss: torch.Tensor | None  # [R], None without the fused loss prover


def _evaluate_leaves(
    net_apply: Callable, variables: Any, tables: V.RuleTables, cfg: MCTSConfig, raw_input: bool,
    board: torch.Tensor, stm: torch.Tensor, move_r: torch.Tensor, move_c: torch.Tensor,
    need: torch.Tensor, counter: torch.Tensor, nnue: Any, nnue_weight: float,
) -> _Leaves:
    """Terminal check, network evaluation (with the symmetry of
    `counter` under symmetry averaging, and the NNUE blend), static
    analysis and the leaf solver on the positions [R, H, W]."""
    h, w = board.shape[1], board.shape[2]
    with record_function("mcts.evaluate"):
        mover = torch.where(stm == CROSS, CIRCLE, CROSS).to(torch.int8)
        stones = (board != 0).sum((1, 2)).int()
        draw_after = cfg.draw_after if cfg.draw_after > 0 else h * w
        dtd = draw_after - stones
        outcome = V.outcome_after(tables, board, move_r, move_c, mover, stones, draw_after)
        outcome = torch.where(need, outcome, int(GameOutcome.UNKNOWN))
        terminal = outcome != int(GameOutcome.UNKNOWN)
        term_score = S.from_outcome(outcome, stm)  # the leaf's own view
        sym = None
        if cfg.symmetry_averaging:
            # deterministic pseudo-random per-evaluation symmetry: varies
            # by step counter, descent and reached cell
            sym = (move_r * 3 + move_c * 5 + counter) % AUG.num_symmetries(h, w)
        policy, value, q_expect, moves_left, legal, packed = _evaluate(
            net_apply, variables, tables, board, stm, raw_input, sym
        )
        if nnue is not None:
            # blend the quantized NNUE evaluation into the leaf values
            # (reference: the optional NNUE hooks of the solver,
            # AlphaBetaSearch.hpp:57,62, shipped off by default)
            from ..models import nnue as NN

            v_nnue = NN.evaluate_features(nnue, NN.nnue_features(tables, board, stm))
            value = (1.0 - nnue_weight) * value + nnue_weight * v_nnue
        value = torch.where(terminal[:, None], S.convert_to_value(term_score), value)
        analysis = static_solver.analyze(packed, legal, dtd)

    solver_win = torch.zeros_like(need)
    solver_loss = None
    if cfg.leaf_solver != "none":
        with record_function("mcts.solve"):
            solver_win, best, win_sc, solver_loss, loss_sc = _solve(
                tables, cfg, board, stm, need & ~terminal, dtd, cfg.leaf_solver_steps,
                cfg.leaf_solver_cap, packed,
            )
            analysis, policy = _apply_proofs(analysis, policy, solver_win, best, win_sc)
            if solver_loss is not None:
                analysis = analysis._replace(
                    node_score=torch.where(solver_loss, loss_sc, analysis.node_score))
    return _Leaves(policy, value, q_expect, moves_left, analysis, terminal, term_score,
                   solver_win, solver_loss)


PROFILE_CUTOFFS = ("select", "evaluate", "expand", "credit", "backupA")


def make_simulate_fn(
    net_apply: Callable, tables: V.RuleTables, cfg: MCTSConfig, raw_input: bool = True,
    profile_cutoff: str | None = None, tp_params: Any = None, nnue: Any = None,
    nnue_weight: float = 0.5,
):
    """Build the one-step simulation `(variables, state) -> state` that
    advances every tree by S = `cfg.leaf_batch` simulations: S descents,
    each seeing the earlier ones' paths as virtual visits, one network
    evaluation over the S * B reached positions, expansion with the
    transposition probe (S new nodes a tree at most, deduplicated on the
    edge), statistics credit and the two-phase backup.

    `tp_params` are the learnable policy's MLP weights
    (`tree_policy.TreePolicyParams`); `nnue` a `nnue.QuantizedNNUE`
    whose leaf values are blended in with weight `nnue_weight`.
    `profile_cutoff` in `PROFILE_CUTOFFS` ends the step after that phase
    (for attributing a step's cost; the counters are left as they are)."""
    check_config(cfg)
    if profile_cutoff is not None and profile_cutoff not in PROFILE_CUTOFFS:
        raise ValueError(f"profile_cutoff {profile_cutoff!r} is not one of {PROFILE_CUTOFFS}")
    NSIM = max(1, cfg.leaf_batch)

    def simulate(variables: Any, state: SearchState) -> SearchState:
        packed_stats = pack_node_stats(state.tree)  # the tree is frozen during select
        with record_function("mcts.select"):
            subs = []
            prev_nodes = prev_slots = None
            for s in range(NSIM):
                sub = _descend(state.tree, cfg, state, packed_stats, tp_params, prev_nodes,
                               prev_slots)
                subs.append(sub)
                if s + 1 < NSIM:
                    prev_nodes = sub.pn if prev_nodes is None else torch.cat([prev_nodes, sub.pn], 1)
                    prev_slots = sub.ps if prev_slots is None else torch.cat([prev_slots, sub.ps], 1)
        if profile_cutoff == "select":
            return state._replace(sims_done=state.sims_done + NSIM)

        if NSIM == 1:
            sub = subs[0]
            flat = (sub.board, sub.stm, sub.move_r, sub.move_c, sub.need, state.sims_done)
        else:
            flat = tuple(torch.cat(x) for x in zip(*(
                (s.board, s.stm, s.move_r, s.move_c, s.need, state.sims_done + 17 * i)
                for i, s in enumerate(subs))))
        leaves = _evaluate_leaves(net_apply, variables, tables, cfg, raw_input, *flat, nnue,
                                  nnue_weight)
        if profile_cutoff == "evaluate":
            return state._replace(sims_done=state.sims_done + NSIM)
        if NSIM == 1:
            return _expand_backup_one(state, cfg, subs[0], leaves, profile_cutoff)
        return _expand_backup_batch(state, cfg, subs, flat[0], flat[1], leaves, profile_cutoff)

    return simulate


def _expand_backup_one(state: SearchState, cfg: MCTSConfig, sub: _Sub, leaves: _Leaves,
                       profile_cutoff: str | None) -> SearchState:
    """Expansion, credit and backup of a step of one descent a tree."""
    tree = state.tree
    bsz = tree.batch
    cap = tree.capacity
    D = cfg.max_depth
    h, w = state.root_board.shape[1], state.root_board.shape[2]
    dev = state.root_board.device
    b = torch.arange(bsz, device=dev)
    leaf, steps, need, pn, ps = sub.leaf, sub.steps, sub.need, sub.pn, sub.ps
    analysis, terminal, term_score = leaves.analysis, leaves.terminal, leaves.term_score
    moves_left = leaves.moves_left

    with record_function("mcts.expand"):
        # -- EXPAND (reference: Tree::expand, Tree.cpp:257-298) ---------
        hash_f = zobrist.full_hash(sub.board, sub.stm)  # [B, 2]
        actions, priors, complete = _topk_edges(
            leaves.policy, analysis.restrict, cfg.max_edges, cfg.policy_expansion_temperature
        )
        actions = torch.where(terminal[:, None], NULL, actions)
        escore0 = _edge_scores_from_analysis(sub.board, analysis, actions)
        best_edge = torch.where(actions != NULL, escore0, S.MINUS_INF).amax(-1)
        new_score = torch.where(
            terminal, term_score,
            torch.where(S.is_win(best_edge), best_edge, analysis.node_score),
        )

        # backup seeds: proven revisits
        leaf_score = tree.node_score[b, leaf]
        revisit = ~need & S.is_proven(leaf_score)
        start_value = torch.where(revisit[:, None], S.convert_to_value(leaf_score), leaves.value)
        start_score = torch.where(need, term_score, torch.where(revisit, leaf_score, S.zero()))

        # transposition probe over each tree's pre-step nodes
        # (reference: NodeCache::seek, NodeCache.hpp:51-120); a lane that
        # `reuse_or_init_root` restarted holds fewer nodes than the
        # frontier, and its rows past them are unused
        frontier = state.frontier
        if cfg.use_transpositions:
            in_use = (torch.arange(frontier, device=dev)[None, :]
                      < tree.node_count[:, None])
            hm = (tree.node_hash[:, :frontier] == hash_f[:, None, :]).all(-1) & in_use
            found = hm.any(-1) & need & ~terminal
            found_idx = torch.argmax(hm.int(), dim=-1)
            found_score = tree.node_score[b, found_idx]
        else:
            found = torch.zeros_like(need)
            found_idx = torch.zeros_like(leaf)
            found_score = torch.zeros_like(leaf_score)

        # lockstep allocation: the step owns slot `start` in every tree
        # (one frontier shared by the batch); a step that does not expand
        # leaves its slot in the init state
        start = min(frontier, cap - 1)
        do_exp = need & ~found & (start >= frontier)
        alloc = max(frontier, start + 1)

        start_score = torch.where(need, new_score, start_score)
        start_value = torch.where(
            (need & S.is_proven(new_score))[:, None], S.convert_to_value(new_score),
            start_value,
        )
        start_score = torch.where(found, found_score, start_score)
        start_value = torch.where(
            (found & S.is_proven(found_score))[:, None], S.convert_to_value(found_score),
            start_value,
        )

        # new node row at `start`
        def put(arr, new):
            m = do_exp.reshape((bsz,) + (1,) * (new.dim() - 1))
            arr[:, start] = torch.where(m, new.to(arr.dtype), arr[:, start])

        put(tree.edge_action, actions)
        put(tree.edge_prior, priors)
        put(tree.edge_score, escore0)
        if needs_q_init(cfg):
            put(tree.edge_q_init, _q_init_rows(leaves.q_expect, actions))
        put(tree.node_visits, torch.ones_like(steps))
        put(tree.node_value_sum, start_value)
        put(tree.node_score, new_score)
        put(tree.node_moves_left_sum, moves_left)
        put(tree.node_complete, complete & ~terminal)
        put(tree.node_hash, hash_f)
        tree.node_count.fill_(alloc)

        # parent link of the expanded (or transposed) edge
        link = do_exp | found
        target = torch.where(found, found_idx, start)
        ln, ls = sub.last_node.clamp(min=0), sub.last_slot
        tree.edge_child[b, ln, ls] = torch.where(link, target.int(), tree.edge_child[b, ln, ls])
        if profile_cutoff == "expand":
            return state._replace(sims_done=state.sims_done + 1, frontier=alloc)

        # credit reached-but-not-created nodes: proven revisits, depth
        # cutoffs, transposition hits
        touch = ((~need) & (steps > 0)) | found
        tn = torch.where(found, found_idx, leaf)
        tree.node_visits[b, tn] += touch.int()
        tree.node_value_sum[b, tn] += torch.where(touch[:, None], start_value, 0.0)
        tree.node_moves_left_sum[b, tn] += torch.where(touch, moves_left, 0.0)
        if profile_cutoff == "credit":
            return state._replace(sims_done=state.sims_done + 1, frontier=alloc)

    with record_function("mcts.backup"):
        # -- BACKUP A: visit/value statistics of the path nodes ---------
        valid = pn != NULL  # [B, D]
        nd = torch.where(valid, pn, 0)
        bb = b[:, None].expand(bsz, D)
        flips = steps[:, None] - torch.arange(D, device=dev, dtype=torch.int32)[None, :]
        odd = ((flips & 1) == 1)[..., None]
        val = torch.where(odd, S.value_invert(start_value)[:, None], start_value[:, None])
        ml = moves_left[:, None] + flips.float()
        tree.node_visits.index_put_((bb, nd), valid.int(), accumulate=True)
        tree.node_value_sum.index_put_(
            (bb, nd), torch.where(valid[..., None], val, 0.0), accumulate=True
        )
        tree.node_moves_left_sum.index_put_(
            (bb, nd), torch.where(valid, ml, 0.0), accumulate=True
        )
        if profile_cutoff == "backupA":
            return state._replace(sims_done=state.sims_done + 1, frontier=alloc)

        # -- BACKUP B: proven-score minimax along the path, in place ---
        score_backup(
            tree.edge_score, tree.edge_action, tree.node_complete, tree.node_score, pn, ps,
            start_score.to(torch.int32),
        )

    st = state.stats
    zero = torch.zeros_like(steps)
    solver_loss = leaves.solver_loss
    stats = SearchStats(
        depth_sum=st.depth_sum + steps,
        expansions=st.expansions + do_exp.int(),
        transpositions=st.transpositions + found.int(),
        duplicates=st.duplicates + zero,
        proven_revisits=st.proven_revisits + revisit.int(),
        terminals=st.terminals + (terminal & need).int(),
        solver_wins=st.solver_wins + leaves.solver_win.int(),
        solver_losses=st.solver_losses + (zero if solver_loss is None else solver_loss.int()),
    )
    return state._replace(sims_done=state.sims_done + 1, stats=stats, frontier=alloc)


def _q_init_rows(q_expect: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """The q head's expectation [R, K] at the edge actions (0 for empty
    slots)."""
    safe = actions.long().clamp(0, q_expect[0].numel() - 1)
    return torch.where(actions != NULL, q_expect.reshape(q_expect.shape[0], -1).gather(1, safe),
                       0.0)


def _expand_backup_batch(state: SearchState, cfg: MCTSConfig, subs: list, board_f: torch.Tensor,
                         stm_f: torch.Tensor, leaves: _Leaves,
                         profile_cutoff: str | None) -> SearchState:
    """Expansion, credit and backup of a step of S > 1 descents a tree, in
    closed form over [B, S] (reference: Tree::expand with duplicate
    expansions, Tree.cpp:257-298; Tree::backup, Tree.cpp:299-351):

    - a descent that reaches an edge an EARLIER descent of the step
      expands links to that descent's new node (a duplicate); hits in the
      pre-step transposition table take the existing node;
    - descent s owns node slot `frontier + s` in every tree; a descent
      that expands nothing leaves its slot in the init state;
    - visit and value statistics of all S paths land at once; the
      proven-score minimax reads the tree as it stands before it, for all
      paths (`score_backup_paths`: a sibling descent's new proof reaches
      the tree one step later, the relaxation the reference package
      states against the reference's strictly sequential tasks)."""
    tree = state.tree
    bsz = tree.batch
    cap = tree.capacity
    NSIM = len(subs)
    K, D = cfg.max_edges, cfg.max_depth
    dev = board_f.device
    b = torch.arange(bsz, device=dev)
    analysis = leaves.analysis

    def to_bs(x):
        """[S * B, ...] (sub-major) -> [B, S, ...]"""
        return x.reshape((NSIM, bsz) + x.shape[1:]).transpose(0, 1)

    with record_function("mcts.expand"):
        hash_f = zobrist.full_hash(board_f, stm_f)  # [S * B, 2]
        actions_f, priors_f, complete_f = _topk_edges(
            leaves.policy, analysis.restrict, K, cfg.policy_expansion_temperature)
        actions_f = torch.where(leaves.terminal[:, None], NULL, actions_f)
        escore0_f = _edge_scores_from_analysis(board_f, analysis, actions_f)
        best_edge_f = torch.where(actions_f != NULL, escore0_f, S.MINUS_INF).amax(-1)
        nsn_f = torch.where(
            leaves.terminal, leaves.term_score,
            torch.where(S.is_win(best_edge_f), best_edge_f, analysis.node_score))

        actions_bs, priors_bs, escore0_bs = to_bs(actions_f), to_bs(priors_f), to_bs(escore0_f)
        complete_bs, nsn_bs, term_bs = to_bs(complete_f), to_bs(nsn_f), to_bs(leaves.terminal)
        tsc_bs, hash_bs = to_bs(leaves.term_score), to_bs(hash_f)
        ml_bs, value_bs = to_bs(leaves.moves_left), to_bs(leaves.value)
        need_bs = torch.stack([s.need for s in subs], 1)  # [B, S]
        steps_bs = torch.stack([s.steps for s in subs], 1)
        leaf_bs = torch.stack([s.leaf for s in subs], 1)
        last_node_bs = torch.stack([s.last_node for s in subs], 1)
        last_slot_bs = torch.stack([s.last_slot for s in subs], 1)

        # backup seeds: proven revisits
        leaf_score_bs = tree.node_score.gather(1, leaf_bs)
        revisit_bs = ~need_bs & S.is_proven(leaf_score_bs)
        start_value_bs = torch.where(revisit_bs[..., None], S.convert_to_value(leaf_score_bs),
                                     value_bs)
        start_score_bs = torch.where(need_bs, tsc_bs,
                                     torch.where(revisit_bs, leaf_score_bs, S.zero()))

        # transposition probe over the pre-step nodes: a descent's verdict
        # does not depend on the earlier descents (duplicates share the
        # position hash, so a whole group hits the table or none of it)
        frontier = state.frontier
        if cfg.use_transpositions:
            in_use = torch.arange(frontier, device=dev)[None, :] < tree.node_count[:, None]
            hm = ((tree.node_hash[:, None, :frontier] == hash_bs[:, :, None]).all(-1)
                  & in_use[:, None])  # [B, S, F]
            found_bs = hm.any(-1) & need_bs & ~term_bs
            found_idx_bs = torch.argmax(hm.int(), dim=-1)
            # the score read sums every matching node's, modulo 2^16, as the
            # reference package's one-hot read does (a position expanded by
            # two descents of one step has two nodes)
            found_score_bs = (hm.int() * tree.node_score[:, None, :frontier]).sum(-1) & 0xFFFF
        else:
            found_bs = torch.zeros_like(need_bs)
            found_idx_bs = torch.zeros_like(leaf_bs)
            found_score_bs = torch.zeros_like(leaf_score_bs)

        # dedup on the target edge, and the allocation
        s_iota = torch.arange(NSIM, device=dev)
        key_bs = last_node_bs * K + last_slot_bs
        cand = need_bs & ~found_bs
        same_ss = key_bs[:, :, None] == key_bs[:, None, :]  # [B, S, S]
        earlier = (s_iota[None, :] < s_iota[:, None])[None]
        first = cand & ~(same_ss & cand[:, None, :] & earlier).any(-1)
        start = min(frontier, cap - NSIM)
        slot_ids = start + s_iota
        do_exp_bs = first & (slot_ids >= frontier)[None, :]
        new_idx_bs = slot_ids[None, :].expand(bsz, NSIM)
        alloc = max(frontier, start + NSIM)
        first_exp = same_ss & do_exp_bs[:, None, :]  # [B, S, S']
        dup_bs = cand & ~first & first_exp.any(-1)
        dup_child_bs = (first_exp.long() * new_idx_bs[:, None, :]).sum(-1)

        # refresh the seeds with the new or transposed node's score
        start_score_bs = torch.where(need_bs, nsn_bs, start_score_bs)
        start_value_bs = torch.where((need_bs & S.is_proven(nsn_bs))[..., None],
                                     S.convert_to_value(nsn_bs), start_value_bs)
        start_score_bs = torch.where(found_bs, found_score_bs, start_score_bs)
        start_value_bs = torch.where((found_bs & S.is_proven(found_score_bs))[..., None],
                                     S.convert_to_value(found_score_bs), start_value_bs)
        link_flag_bs = do_exp_bs | found_bs
        link_target_bs = torch.where(found_bs, found_idx_bs, new_idx_bs)
        touch_flag_bs = (~need_bs & (steps_bs > 0)) | found_bs | dup_bs
        touch_node_bs = torch.where(found_bs, found_idx_bs,
                                    torch.where(dup_bs, dup_child_bs, leaf_bs))

        # the new nodes' rows, one block at the frontier
        rows = slice(start, start + NSIM)

        def put(arr, new):
            m = do_exp_bs.reshape(do_exp_bs.shape + (1,) * (new.dim() - 2))
            arr[:, rows] = torch.where(m, new.to(arr.dtype), arr[:, rows])

        put(tree.edge_action, actions_bs)
        put(tree.edge_prior, priors_bs)
        put(tree.edge_score, escore0_bs)
        if needs_q_init(cfg):
            put(tree.edge_q_init, to_bs(_q_init_rows(leaves.q_expect, actions_f)))
        tree.node_count.fill_(alloc)
        put(tree.node_visits, torch.ones_like(steps_bs))
        put(tree.node_value_sum, start_value_bs)
        put(tree.node_score, nsn_bs)
        put(tree.node_moves_left_sum, ml_bs)
        put(tree.node_complete, complete_bs & ~term_bs)
        put(tree.node_hash, hash_bs)

        # parent links: only each edge's first linker counts, and it lands
        # as new minus old, unique per (node, slot)
        linkers = link_flag_bs & ~(same_ss & link_flag_bs[:, None, :] & earlier).any(-1)
        bb = b[:, None].expand(bsz, NSIM)
        ln = last_node_bs.clamp(min=0)
        old = tree.edge_child[bb, ln, last_slot_bs]
        tree.edge_child.index_put_(
            (bb, ln, last_slot_bs), torch.where(linkers, link_target_bs.int() - old, 0),
            accumulate=True)
        if profile_cutoff == "expand":
            return state._replace(sims_done=state.sims_done + NSIM, frontier=alloc)

        # credit reached-but-not-created nodes: proven revisits, depth
        # cutoffs, duplicate expansions, transposition hits (the sums over
        # the descents first, then added, as one-hot sums are)
        tree.node_visits.index_put_((bb, touch_node_bs), touch_flag_bs.int(), accumulate=True)
        tree.node_value_sum.add_(torch.zeros_like(tree.node_value_sum).index_put_(
            (bb, touch_node_bs), torch.where(touch_flag_bs[..., None], start_value_bs, 0.0),
            accumulate=True))
        tree.node_moves_left_sum.add_(torch.zeros_like(tree.node_moves_left_sum).index_put_(
            (bb, touch_node_bs), torch.where(touch_flag_bs, ml_bs, 0.0), accumulate=True))
        if profile_cutoff == "credit":
            return state._replace(sims_done=state.sims_done + NSIM, frontier=alloc)

    with record_function("mcts.backup"):
        # -- BACKUP A: the statistics of all S * D path entries ---------
        P = NSIM * D
        pn_sd = torch.stack([s.pn for s in subs], 1)  # [B, S, D]
        ps_sd = torch.stack([s.ps for s in subs], 1)
        valid = (pn_sd != NULL).reshape(bsz, P)
        nd = torch.where(valid, pn_sd.reshape(bsz, P), 0)
        bbp = b[:, None].expand(bsz, P)
        flips = steps_bs[..., None] - torch.arange(D, device=dev, dtype=torch.int32)
        odd = ((flips & 1) == 1)[..., None]
        val = torch.where(odd, S.value_invert(start_value_bs)[:, :, None],
                          start_value_bs[:, :, None]).reshape(bsz, P, 2)
        ml = (ml_bs[..., None] + flips.float()).reshape(bsz, P)
        tree.node_visits.index_put_((bbp, nd), valid.int(), accumulate=True)
        tree.node_value_sum.add_(torch.zeros_like(tree.node_value_sum).index_put_(
            (bbp, nd), torch.where(valid[..., None], val, 0.0), accumulate=True))
        tree.node_moves_left_sum.add_(torch.zeros_like(tree.node_moves_left_sum).index_put_(
            (bbp, nd), torch.where(valid, ml, 0.0), accumulate=True))
        if profile_cutoff == "backupA":
            return state._replace(sims_done=state.sims_done + NSIM, frontier=alloc)

        # -- BACKUP B: the proven-score minimax of all paths ------------
        score_backup_paths(
            tree.edge_score, tree.edge_action, tree.node_complete, tree.node_score, pn_sd, ps_sd,
            start_score_bs.to(torch.int32))

    st = state.stats
    solver_win = to_bs(leaves.solver_win).int().sum(1, dtype=torch.int32)
    solver_loss = (torch.zeros_like(solver_win) if leaves.solver_loss is None
                   else to_bs(leaves.solver_loss).int().sum(1, dtype=torch.int32))
    count = lambda x: x.int().sum(1, dtype=torch.int32)
    stats = SearchStats(
        depth_sum=st.depth_sum + steps_bs.sum(1, dtype=torch.int32),
        expansions=st.expansions + count(do_exp_bs),
        transpositions=st.transpositions + count(found_bs),
        duplicates=st.duplicates + count(dup_bs),
        proven_revisits=st.proven_revisits + count(revisit_bs),
        terminals=st.terminals + count(term_bs & need_bs),
        solver_wins=st.solver_wins + solver_win,
        solver_losses=st.solver_losses + solver_loss,
    )
    return state._replace(sims_done=state.sims_done + NSIM, stats=stats, frontier=alloc)


# ---------------------------------------------------------------------------
# Root initialization + search driver
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_root(
    net_apply: Callable, variables: Any, tables: V.RuleTables, cfg: MCTSConfig,
    board, stm, raw_input: bool = True, device="cuda", noise: torch.Tensor | None = None,
    root_move_mask=None,
) -> SearchState:
    """Fresh trees with the root (node 0) expanded.  `board` [B, H, W] and
    `stm` [B] (arrays or tensors) are moved to `device`.  `noise` [B, K],
    drawn by `sample_root_noise`, perturbs the root priors when
    `cfg.noise_weight > 0` (`apply_root_noise`).  `root_move_mask`
    [B, H, W] bool (`search/generators.py`) is ANDed into the roots' move
    restriction, where it leaves a move.  Runs under no_grad whatever the
    calling thread's grad mode."""
    check_config(cfg)
    dev = torch.device(device)
    board = torch.as_tensor(board).to(device=dev, dtype=torch.int8)
    stm = torch.as_tensor(stm).to(device=dev, dtype=torch.int8)
    bsz, h, w = board.shape
    tree = init_tree(bsz, cfg, dev)
    policy, value, q_expect, moves_left, legal, packed = _evaluate(
        net_apply, variables, tables, board, stm, raw_input
    )
    draw_after = cfg.draw_after if cfg.draw_after > 0 else h * w
    dtd_root = draw_after - (board != 0).sum((1, 2)).int()
    analysis = static_solver.analyze(packed, legal, dtd_root)
    if cfg.leaf_solver != "none":
        # solve the roots too (with 4x the leaves' budget): roots never
        # appear as leaves, and a root-proven win makes the proven edge
        # dominate selection at once (reference: AlphaBetaSearch also
        # solves root tasks)
        with record_function("mcts.solve"):
            win, best, dist = _win_solve(tables, cfg, board, stm, 4 * cfg.leaf_solver_steps)
            win = win & (dist <= dtd_root)
            analysis, policy = _apply_proofs(analysis, policy, win, best,
                                             S.win_in(dist.clamp(1, 512)))
            if cfg.loss_prover:
                # prove lost roots over their complete defensive option
                # sets, which need not fit the K edge slots (reference: the
                # fail-low alpha-beta leg, AlphaBetaSearch.cpp:91-135)
                cand = _opp_threats(packed) & ~win
                sel = V.first_k(cand, max(1, min(int(cfg.loss_cap), bsz)))
                lres = vct_batched.solve_loss(
                    tables, board[sel], stm[sel], max_options=cfg.loss_options,
                    max_depth=cfg.leaf_solver_depth, max_steps=4 * cfg.leaf_solver_steps,
                    max_threes=cfg.leaf_solver_threes,
                )
                lost, loss_sc = _scatter_losses(lres, cand, sel, dtd_root)
                analysis = analysis._replace(
                    node_score=torch.where(lost, loss_sc, analysis.node_score))
    restrict = analysis.restrict
    if root_move_mask is not None:
        # opening generators restrict the root move set (reference:
        # Center/Symmetrical-excluding EdgeGenerators), never to nothing
        masked = restrict & torch.as_tensor(root_move_mask, device=dev).bool()
        restrict = torch.where(masked.flatten(1).any(-1)[:, None, None], masked, restrict)
    actions, priors, complete = _topk_edges(
        policy, restrict, cfg.max_edges, cfg.policy_expansion_temperature
    )
    safe = actions.long().clamp(0, h * w - 1)
    q_init = torch.where(actions != NULL, q_expect.reshape(bsz, -1).gather(1, safe), 0.0)
    edge_scores0 = _edge_scores_from_analysis(board, analysis, actions)
    best_edge = torch.where(actions != NULL, edge_scores0, S.MINUS_INF).amax(-1)
    root_score = torch.where(S.is_win(best_edge), best_edge, analysis.node_score)
    tree.node_visits[:, 0] = 1
    tree.node_value_sum[:, 0] = value
    tree.node_score[:, 0] = root_score
    tree.node_moves_left_sum[:, 0] = moves_left
    tree.node_complete[:, 0] = complete
    tree.edge_action[:, 0] = actions
    tree.edge_prior[:, 0] = priors.to(torch.bfloat16)
    tree.edge_score[:, 0] = edge_scores0
    tree.edge_q_init[:, 0] = q_init.to(torch.bfloat16)
    tree.node_hash[:, 0] = zobrist.full_hash(board, stm)
    tree.node_count.fill_(1)
    return SearchState(
        tree=tree,
        root_board=board,
        root_stm=stm,
        root_node=torch.zeros(bsz, dtype=torch.int64, device=dev),
        noisy_prior=apply_root_noise(cfg, priors, actions, noise),
        sims_done=torch.zeros(bsz, dtype=torch.int32, device=dev),
        stats=SearchStats.zeros(bsz, dev),
        frontier=1,
    )


def sample_gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws in f32 on the generator's device, as
    `jax.random.gumbel` makes them: -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def sample_log_gamma(alpha: float, shape, generator: torch.Generator) -> torch.Tensor:
    """log of Gamma(alpha, 1) draws in f32 (Marsaglia-Tsang, with the
    alpha < 1 boost taken in log space: log G(alpha + 1) + log(u) / alpha,
    which a small alpha would underflow outside it).  Rejection rounds
    repeat until every element is accepted (one host sync a round; about
    1 in 20 elements is rejected in a round)."""
    dev = generator.device
    boost = alpha < 1.0
    d = (alpha + 1.0 if boost else alpha) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, device=dev)
    todo = torch.ones(shape, dtype=torch.bool, device=dev)
    while True:
        x = torch.randn(shape, generator=generator, device=dev)
        v = (1.0 + c * x) ** 3
        u = torch.rand(shape, generator=generator, device=dev)
        logv = torch.log(v.clamp(min=1e-30))
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * logv)
        out = torch.where(todo & ok, math.log(d) + logv, out)
        todo &= ~ok
        if not bool(todo.any()):
            break
    if boost:
        u = torch.rand(shape, generator=generator, device=dev)
        out = out + torch.log1p(-u) / alpha
    return out


def custom_noise(u: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The custom root noise [B, K] from uniform draws `u` [B, K] and a
    permutation of the K slots per row `perm` [B, K]: stick-breaking
    r_i = u_i^4 * (1 - the sum so far), then shuffled (reference:
    createCustomNoise, src/utils/random.cpp:89-100)."""
    u4 = u ** 4
    rem = torch.cumprod(1.0 - u4, dim=-1) / (1.0 - u4).clamp(min=1e-9)
    return (u4 * rem).gather(-1, perm.long())


def sample_root_noise(cfg: MCTSConfig, batch: int, generator: torch.Generator) -> torch.Tensor:
    """The root noise [B, K] of `cfg.noise_type` drawn from `generator` on
    its device: Gumbel draws for "gumbel", `custom_noise` for "custom",
    else Dirichlet(noise_alpha) rows, sampled as `jax.random.dirichlet`
    does (softmax of log-gamma draws)."""
    shape = (batch, cfg.max_edges)
    if cfg.noise_type == "gumbel":
        return sample_gumbel(shape, generator)
    if cfg.noise_type == "custom":
        u = torch.rand(shape, generator=generator, device=generator.device)
        keys = torch.rand(shape, generator=generator, device=generator.device)
        return custom_noise(u, torch.argsort(keys, dim=-1))
    return torch.softmax(sample_log_gamma(cfg.noise_alpha, shape, generator), dim=-1)


def apply_root_noise(
    cfg: MCTSConfig, priors: torch.Tensor, actions: torch.Tensor, noise: torch.Tensor | None
) -> torch.Tensor:
    """Root exploration noise over the K edge priors [B, K] f32, per
    `cfg.noise_type` (reference: applyDirichlet/Gumbel/CustomNoise,
    EdgeSelector.cpp:602-625): gumbel perturbs the log priors by
    `noise_weight * noise` and renormalizes by softmax; dirichlet and
    custom mix `(1 - w) * prior + w * noise`.  Empty slots get 0 and rows
    are renormalized.  Without `noise`, or at `noise_weight` 0, the
    priors are returned as they are."""
    if noise is None or cfg.noise_weight <= 0.0:
        return priors
    valid = actions != NULL
    if cfg.noise_type == "gumbel":
        logits = torch.log(priors.clamp(min=1e-9)) + cfg.noise_weight * noise
        noisy = torch.where(valid, torch.softmax(torch.where(valid, logits, float("-inf")), -1),
                            0.0)
    else:
        noisy = torch.where(valid, (1.0 - cfg.noise_weight) * priors + cfg.noise_weight * noise,
                            0.0)
    # the row sum added left to right, as the reference package's XLA adds
    # it on the CPU: PUCT's argmax at the root turns on an ulp of a prior,
    # so another order can change a self-play game
    total = noisy[:, :1]
    for k in range(1, noisy.shape[1]):
        total = total + noisy[:, k:k + 1]
    return noisy / total.clamp(min=1e-12)


def reuse_or_init_root(
    net_apply: Callable, variables: Any, tables: V.RuleTables, cfg: MCTSConfig,
    prev_state: SearchState, prev_move: torch.Tensor, board, stm, reserve: int,
    raw_input: bool = True, noise: torch.Tensor | None = None,
) -> SearchState:
    """Between-move subtree carry-over: point the root at the played child
    and keep the accumulated statistics, re-initializing only the lanes that
    cannot reuse (reference: Tree::setBoard + NodeCache::cleanup subtree
    carry-over, Tree.cpp:128-151).

    `prev_move` [B] is the flat action just played from `prev_state`'s root
    (-1 disables reuse for that lane).  `reserve` is the node budget the
    next search needs: lanes whose tree cannot fit it restart fresh.  A
    lane reuses when `prev_move` is a root edge whose child was expanded
    and the tree fits; its root is then that child (never node 0), so
    `root_node > 0` marks the reused lanes.

    The combined tree is new tensors, built from `prev_state.tree` and a
    fresh `init_root`; `prev_state` is not modified.  The same `noise`
    perturbs the fresh roots' f32 priors and the reused children's bf16
    ones.  The allocation frontier is the largest node count of the
    combined trees (one host sync)."""
    fresh = init_root(net_apply, variables, tables, cfg, board, stm, raw_input,
                      prev_state.root_board.device, noise)
    bsz = fresh.tree.batch
    b = torch.arange(bsz, device=fresh.root_board.device)
    tree = prev_state.tree
    prev_move = prev_move.to(b.device)
    actions = tree.edge_action[b, prev_state.root_node]  # [B, K]
    hit = actions == prev_move[:, None]
    has_slot = hit.any(-1) & (prev_move >= 0)
    slot = torch.argmax(hit.int(), dim=-1)
    child = tree.edge_child[b, prev_state.root_node, slot].long()
    fits = tree.node_count + reserve <= tree.capacity
    reuse = has_slot & (child != NULL) & fits
    child_safe = torch.where(reuse, child, 0)

    def comb(carried, fresh_arr):
        m = reuse.reshape((bsz,) + (1,) * (carried.dim() - 1))
        return torch.where(m, carried, fresh_arr)

    tree_c = Tree(*[comb(c, f) for c, f in zip(tree, fresh.tree)])
    child_actions = tree.edge_action[b, child_safe]
    child_prior = torch.where(child_actions != NULL, tree.edge_prior[b, child_safe].float(), 0.0)
    noisy_child = apply_root_noise(cfg, child_prior, child_actions, noise)
    return fresh._replace(
        tree=tree_c,
        root_node=torch.where(reuse, child, fresh.root_node),
        noisy_prior=torch.where(reuse[:, None], noisy_child, fresh.noisy_prior),
        frontier=int(tree_c.node_count.max()),
    )


def run_search(
    net_apply: Callable, variables: Any, tables: V.RuleTables, cfg: MCTSConfig,
    board, stm, num_simulations: int, raw_input: bool = True, device="cuda",
    noise: torch.Tensor | None = None, root_move_mask=None, tp_params: Any = None,
    nnue: Any = None,
) -> SearchState:
    """Full search: init the roots (with the root `noise` and
    `root_move_mask`, see `init_root`), then ceil(num_simulations /
    leaf_batch) lockstep steps.  `net_apply(variables, planes)` maps NHWC
    planes to a `NetOutput` (e.g. `ops.convnext_fused.fused_apply` with its
    `FusedWeights`); `tp_params` and `nnue` go to `make_simulate_fn`."""
    state = init_root(net_apply, variables, tables, cfg, board, stm, raw_input, device, noise,
                      root_move_mask)
    return simulate_n(net_apply, variables, tables, cfg, state, num_simulations, raw_input,
                      tp_params, nnue)


def simulate_n(
    net_apply: Callable, variables: Any, tables: V.RuleTables, cfg: MCTSConfig,
    state: SearchState, num_simulations: int, raw_input: bool = True, tp_params: Any = None,
    nnue: Any = None,
) -> SearchState:
    """`num_simulations` simulations from `state`: ceil(num_simulations /
    leaf_batch) lockstep steps."""
    simulate = make_simulate_fn(net_apply, tables, cfg, raw_input, tp_params=tp_params,
                                nnue=nnue)
    steps = -(-num_simulations // max(1, cfg.leaf_batch))
    with torch.no_grad():
        for _ in range(steps):
            state = simulate(variables, state)
    return state


# ---------------------------------------------------------------------------
# Extracting results
# ---------------------------------------------------------------------------


def root_visit_distribution(state: SearchState) -> torch.Tensor:
    """Normalized root visit counts as a [B, H, W] policy target
    (reference: SearchDataPack built from root, data_packs.cpp:24-43)."""
    tree = state.tree
    bsz = tree.batch
    h, w = state.root_board.shape[1], state.root_board.shape[2]
    rb = torch.arange(bsz, device=state.root_board.device)
    visits = edge_stats(tree, rb, state.root_node).visits.float()
    actions = tree.edge_action[rb, state.root_node]
    visits = torch.where(actions != NULL, visits, 0.0)
    dist = torch.zeros((bsz, h * w), dtype=torch.float32, device=visits.device)
    dist.scatter_add_(1, actions.long().clamp(0, h * w - 1), visits)
    dist = dist / dist.sum(-1, keepdim=True).clamp(min=1e-12)
    return dist.reshape(bsz, h, w)


def root_value(state: SearchState) -> torch.Tensor:
    """Root (win, draw) estimate [B, 2]."""
    tree = state.tree
    rb = torch.arange(tree.batch, device=state.root_board.device)
    n = tree.node_visits[rb, state.root_node].float().clamp(min=1.0)
    return tree.node_value_sum[rb, state.root_node] / n[:, None]


def select_move(
    state: SearchState, generator: torch.Generator | None = None, temperature: float = 0.0,
    gumbel: torch.Tensor | None = None,
) -> torch.Tensor:
    """Final move [B] (flat action index): the reference's BestEdge
    ordering (EdgeSelector.cpp:515-536: WIN -> +1e8 - distance, LOSS ->
    -1e8 + distance, else visits + expectation * parent visits + 0.001 *
    prior), or, with `temperature` > 0 and a Gumbel draw [B, K] (`gumbel`,
    else drawn from `generator`), visit-count sampling by the Gumbel-max
    trick: argmax(gumbel + log(visits) / temperature), as
    `jax.random.categorical` samples (the first maximum on ties)."""
    tree = state.tree
    rb = torch.arange(tree.batch, device=state.root_board.device)
    es = edge_stats(tree, rb, state.root_node)
    visits = es.visits.float()
    actions = tree.edge_action[rb, state.root_node]
    valid = actions != NULL
    h, w = state.root_board.shape[1], state.root_board.shape[2]
    if temperature > 0.0 and (gumbel is not None or generator is not None):
        if gumbel is None:
            gumbel = sample_gumbel(actions.shape, generator)
        logits = torch.where(valid, torch.log(visits.clamp(min=1e-9)) / temperature, float("-inf"))
        slot = torch.argmax(gumbel + logits, dim=-1)
    else:
        q = es.q_win + 0.5 * es.q_draw
        parent_n = tree.node_visits[rb, state.root_node].float()
        prior = tree.edge_prior[rb, state.root_node].float()
        util = visits + q * parent_n[:, None] + 0.001 * prior
        dist = S.get_distance(es.score).float()
        util = torch.where(S.is_win(es.score), 1e8 - dist, util)
        util = torch.where(S.is_loss(es.score), -1e8 + dist, util)
        util = torch.where(valid, util, float("-inf"))
        slot = torch.argmax(util, dim=-1)
    return actions[rb, slot].long().clamp(0, h * w - 1)
