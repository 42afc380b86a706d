"""Batched MCTS: fixed-capacity array trees, one tree per board, advanced
in lockstep by one simulation per tree per step.

Port of the reference package's `search/mcts.py` at its defaults:
`policy="puct"`, `init_to="parent"`, `leaf_batch=1`, no root noise, no
symmetry averaging, no NNUE; transpositions on (or off); the leaf solver
off or `leaf_solver="vct"` (the engine default, `search/vct_batched.py`)
without the loss prover.  Other configuration values raise
NotImplementedError (`check_config`).

Mapping to the reference (src/search/monte_carlo/{Tree,Search,Node,Edge,
EdgeSelector,EdgeGenerator}.cpp), as in the reference package:
- nodes and edges are struct-of-arrays `[B, N]` and `[B, N, K]` tensors;
  K = max_edges mirrors the reference's max_children pruning and a per-node
  `complete` flag records whether pruning dropped legal moves;
- PUCT selection is a masked argmax over the K edge slots, with proven
  edges pinned (EdgeSelector.cpp:389-424);
- edge visits and values are derived from the child node (graph-MCTS
  statistics through transpositions); edge scores are stored and
  minimax-updated in the backup (`ops/score_scan.py:score_backup`);
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
reference package's early-exit loop without a host sync per level), and
the allocation frontier is a host int that follows the step count.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.profiler import record_function

from ..game.types import CROSS, CIRCLE, GameOutcome
from ..game import vectorized as V
from ..models.networks import postprocess
from ..patterns import features as F
from ..ops.score_scan import score_backup
from . import score as S
from . import static_solver
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


_NOT_PORTED = "(ROADMAP.md, 'Modules to port', item {}: not ported yet)"


def check_config(cfg: MCTSConfig) -> None:
    """Raise NotImplementedError for configuration values outside the
    ported slice."""
    checks = [
        (cfg.policy == "puct", f"policy={cfg.policy!r}", 10),
        (cfg.init_to == "parent", f"init_to={cfg.init_to!r}", 10),
        (cfg.leaf_batch == 1, f"leaf_batch={cfg.leaf_batch}", 10),
        (cfg.noise_weight == 0.0, f"noise_weight={cfg.noise_weight}", 10),
        (not cfg.symmetry_averaging, "symmetry_averaging", 10),
        (cfg.leaf_solver in ("none", "vct"), f"leaf_solver={cfg.leaf_solver!r}", "9a"),
        (not cfg.loss_prover, "loss_prover", "9b"),
    ]
    for ok, what, item in checks:
        if not ok:
            raise NotImplementedError(f"MCTSConfig {what} " + _NOT_PORTED.format(item))
    if cfg.max_nodes < 2 or cfg.max_edges < 1 or cfg.max_depth < 1:
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


def _edge_utility(
    tree: Tree, cfg: MCTSConfig, node: torch.Tensor, prior: torch.Tensor,
    packed: torch.Tensor,
) -> torch.Tensor:
    """PUCT utility [B, K] of the edges of `node` [B] (reference:
    EdgeSelector.cpp:389-424), unvisited edges at the parent's value."""
    b = torch.arange(tree.batch, device=node.device)
    es = edge_stats(tree, b, node, packed)
    valid = tree.edge_action[b, node] != NULL
    prow = packed[b, node]
    n_parent = prow[:, 0]
    pv_sum = prow[:, 1:3]
    c_puct = cfg.exploration_constant + cfg.exploration_scaling * torch.log(
        n_parent.clamp(min=1.0)
    )
    nf = es.visits.float()
    expectation = es.q_win + 0.5 * es.q_draw
    pn = n_parent.clamp(min=1.0)
    parent_q = ((pv_sum[:, 0] + 0.5 * pv_sum[:, 1]) / pn)[:, None]
    q = torch.where(es.visits > 0, expectation, parent_q)
    u = prior * (c_puct * torch.sqrt(n_parent))[:, None] / (1.0 + nf)
    util = q + u
    # proven edges pin the utility (reference: EdgeSelector.cpp:400-410)
    escore = es.score
    dist = S.get_distance(escore).float()
    util = torch.where(S.is_win(escore), 1000.0 - dist, util)
    util = torch.where(S.is_loss(escore), -1000.0 + dist, util)
    util = torch.where(S.is_draw(escore) & S.is_finite(escore), 0.5, util)
    return torch.where(valid, util, float("-inf"))


def select_edge(
    tree: Tree, cfg: MCTSConfig, node: torch.Tensor, prior: torch.Tensor,
    packed: torch.Tensor,
) -> torch.Tensor:
    """Best edge slot [B] of `node` [B] (first maximum on ties)."""
    return torch.argmax(_edge_utility(tree, cfg, node, prior, packed), dim=-1)


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
        flat = flat ** (1.0 / temperature)
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


def _solve(
    tables: V.RuleTables, cfg: MCTSConfig, board: torch.Tensor, stm: torch.Tensor,
    active: torch.Tensor, dtd: torch.Tensor, max_steps: int, cap: int = 0,
    packed: torch.Tensor | None = None,
):
    """The VCT leaf solver on the positions [B, H, W] (reference: the
    alpha-beta leg run on every leaf batch, Search.cpp:159-183).

    With `0 < cap < B`, only `cap` positions are solved: the `active` ones
    with any threat cell of the side to move (own pattern-group bits of the
    encoded features `packed`) first, then the lowest-indexed others, as
    `lax.top_k` picks them from a 0/1 mask (a stable descending sort).
    Returns (win [B], best_move [B], win score [B]): `win` holds only for
    `active` positions whose mate fits the draw horizon `dtd`."""
    bsz = board.shape[0]
    if cap and cap < bsz:
        interest = ((packed >> 8) & 0xFFF).ne(0).flatten(1).any(-1) & active
        sel = torch.sort(interest.int(), descending=True, stable=True).indices[:cap]
        sres = vct_batched.solve(
            tables, board[sel], stm[sel], max_depth=cfg.leaf_solver_depth,
            max_steps=max_steps, max_threes=cfg.leaf_solver_threes,
        )
        # scatter the compacted proofs back (top-k indices are distinct)
        win = torch.zeros(bsz, dtype=torch.bool, device=board.device).index_copy(0, sel, sres.win)
        best = torch.full((bsz,), -1, dtype=torch.int32, device=board.device)
        best = best.index_copy(0, sel, sres.best_move)
        dist = torch.zeros(bsz, dtype=torch.int32, device=board.device)
        dist = dist.index_copy(0, sel, sres.distance)
    else:
        win, best, dist = vct_batched.solve(
            tables, board, stm, max_depth=cfg.leaf_solver_depth, max_steps=max_steps,
            max_threes=cfg.leaf_solver_threes,
        )
    # a mate longer than the draw horizon is a draw, not a win
    win = win & active & (dist <= dtd)
    return win, best, S.win_in(dist.clamp(1, 512))


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
    net_apply: Callable, variables: Any, tables: V.RuleTables, board, stm, raw_input: bool
):
    """NN forward on [B, H, W] boards: (policy [B, H, W] masked probs, value
    (win, draw) [B, 2], q_expect [B, H, W], moves_left [B], legal mask,
    packed features)."""
    packed = F.encode(tables, board, stm)
    planes = F.unpack_raw_planes(packed) if raw_input else F.unpack_planes(packed)
    out = net_apply(variables, planes)
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


def make_simulate_fn(
    net_apply: Callable, tables: V.RuleTables, cfg: MCTSConfig, raw_input: bool = True
):
    """Build the one-step simulation `(variables, state) -> state` that
    advances every tree by one simulation: a PUCT descent, one network
    evaluation over the B reached positions, expansion with the
    transposition probe, statistics credit and the two-phase backup."""
    check_config(cfg)
    V.check_rules(tables)
    D = cfg.max_depth
    K = cfg.max_edges

    def simulate(variables: Any, state: SearchState) -> SearchState:
        tree = state.tree
        bsz = tree.batch
        cap = tree.capacity
        h, w = state.root_board.shape[1], state.root_board.shape[2]
        dev = state.root_board.device
        b = torch.arange(bsz, device=dev)
        packed_stats = pack_node_stats(tree)  # the tree is frozen during select

        with record_function("mcts.select"):
            # -- SELECT (reference: Tree::select, Tree.cpp:226-251) ---------
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
            for d in range(D):
                at_root = (cur == state.root_node)[:, None]
                prior = torch.where(at_root, state.noisy_prior, tree.edge_prior[b, cur].float())
                slot = select_edge(tree, cfg, cur, prior, packed_stats)
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
            leaf = cur
            last_i = (steps.long() - 1).clamp(0, D - 1)
            last_node = torch.where(steps > 0, pn[b, last_i], NULL)
            last_slot = torch.where(steps > 0, ps[b, last_i], 0)

        with record_function("mcts.evaluate"):
            # -- TERMINAL CHECK + EVALUATE ----------------------------------
            mover = torch.where(stm == CROSS, CIRCLE, CROSS).to(torch.int8)
            stones = (boardc != 0).sum((1, 2)).int()
            draw_after = cfg.draw_after if cfg.draw_after > 0 else h * w
            dtd = draw_after - stones
            outcome = V.outcome_after(tables, boardc, move_r, move_c, mover, stones, draw_after)
            outcome = torch.where(need, outcome, int(GameOutcome.UNKNOWN))
            terminal = outcome != int(GameOutcome.UNKNOWN)
            term_score = S.from_outcome(outcome, stm)  # the leaf's own view
            policy, value, _, moves_left, legal, packed = _evaluate(
                net_apply, variables, tables, boardc, stm, raw_input
            )
            value = torch.where(terminal[:, None], S.convert_to_value(term_score), value)
            analysis = static_solver.analyze(packed, legal, dtd)

        solver_win = torch.zeros_like(need)
        if cfg.leaf_solver == "vct":
            with record_function("mcts.solve"):
                solver_win, best, win_sc = _solve(
                    tables, cfg, boardc, stm, need & ~terminal, dtd, cfg.leaf_solver_steps,
                    cfg.leaf_solver_cap, packed,
                )
                analysis, policy = _apply_proofs(analysis, policy, solver_win, best, win_sc)

        with record_function("mcts.expand"):
            # -- EXPAND (reference: Tree::expand, Tree.cpp:257-298) ---------
            hash_f = zobrist.full_hash(boardc, stm)  # [B, 2]
            actions, priors, complete = _topk_edges(
                policy, analysis.restrict, K, cfg.policy_expansion_temperature
            )
            actions = torch.where(terminal[:, None], NULL, actions)
            escore0 = _edge_scores_from_analysis(boardc, analysis, actions)
            best_edge = torch.where(actions != NULL, escore0, S.MINUS_INF).amax(-1)
            new_score = torch.where(
                terminal, term_score,
                torch.where(S.is_win(best_edge), best_edge, analysis.node_score),
            )

            # backup seeds: proven revisits
            leaf_score = tree.node_score[b, leaf]
            revisit = ~need & S.is_proven(leaf_score)
            start_value = torch.where(revisit[:, None], S.convert_to_value(leaf_score), value)
            start_score = torch.where(need, term_score, torch.where(revisit, leaf_score, S.zero()))

            # transposition probe over the pre-step nodes (reference:
            # NodeCache::seek, NodeCache.hpp:51-120)
            frontier = state.frontier
            if cfg.use_transpositions:
                hm = (tree.node_hash[:, :frontier] == hash_f[:, None, :]).all(-1)
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
            ln, ls = last_node.clamp(min=0), last_slot
            tree.edge_child[b, ln, ls] = torch.where(link, target.int(), tree.edge_child[b, ln, ls])

            # credit reached-but-not-created nodes: proven revisits, depth
            # cutoffs, transposition hits
            touch = ((~need) & (steps > 0)) | found
            tn = torch.where(found, found_idx, leaf)
            tree.node_visits[b, tn] += touch.int()
            tree.node_value_sum[b, tn] += torch.where(touch[:, None], start_value, 0.0)
            tree.node_moves_left_sum[b, tn] += torch.where(touch, moves_left, 0.0)

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

            # -- BACKUP B: proven-score minimax along the path, in place ---
            score_backup(
                tree.edge_score, tree.edge_action, tree.node_complete, tree.node_score, pn, ps,
                start_score.to(torch.int32),
            )

        st = state.stats
        zero = torch.zeros_like(steps)
        stats = SearchStats(
            depth_sum=st.depth_sum + steps,
            expansions=st.expansions + do_exp.int(),
            transpositions=st.transpositions + found.int(),
            duplicates=st.duplicates + zero,
            proven_revisits=st.proven_revisits + revisit.int(),
            terminals=st.terminals + (terminal & need).int(),
            solver_wins=st.solver_wins + solver_win.int(),
            solver_losses=st.solver_losses + zero,
        )
        return state._replace(sims_done=state.sims_done + 1, stats=stats, frontier=alloc)

    return simulate


# ---------------------------------------------------------------------------
# Root initialization + search driver
# ---------------------------------------------------------------------------


def init_root(
    net_apply: Callable, variables: Any, tables: V.RuleTables, cfg: MCTSConfig,
    board, stm, raw_input: bool = True, device="cuda",
) -> SearchState:
    """Fresh trees with the root (node 0) expanded.  `board` [B, H, W] and
    `stm` [B] (arrays or tensors) are moved to `device`."""
    check_config(cfg)
    V.check_rules(tables)
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
    if cfg.leaf_solver == "vct":
        # solve the roots too (with 4x the leaves' budget): roots never
        # appear as leaves, and a root-proven win makes the proven edge
        # dominate selection at once (reference: AlphaBetaSearch also
        # solves root tasks)
        with record_function("mcts.solve"):
            win, best, win_sc = _solve(
                tables, cfg, board, stm, torch.ones_like(dtd_root, dtype=torch.bool), dtd_root,
                4 * cfg.leaf_solver_steps,
            )
            analysis, policy = _apply_proofs(analysis, policy, win, best, win_sc)
    actions, priors, complete = _topk_edges(
        policy, analysis.restrict, cfg.max_edges, cfg.policy_expansion_temperature
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
        noisy_prior=priors,
        sims_done=torch.zeros(bsz, dtype=torch.int32, device=dev),
        stats=SearchStats.zeros(bsz, dev),
        frontier=1,
    )


def run_search(
    net_apply: Callable, variables: Any, tables: V.RuleTables, cfg: MCTSConfig,
    board, stm, num_simulations: int, raw_input: bool = True, device="cuda",
) -> SearchState:
    """Full search: init the roots, then `num_simulations` lockstep
    simulations.  `net_apply(variables, planes)` maps NHWC planes to a
    `NetOutput` (e.g. `ops.convnext_fused.fused_apply` with its
    `FusedWeights`)."""
    state = init_root(net_apply, variables, tables, cfg, board, stm, raw_input, device)
    simulate = make_simulate_fn(net_apply, tables, cfg, raw_input)
    with torch.no_grad():
        for _ in range(num_simulations):
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
    state: SearchState, generator: torch.Generator | None = None, temperature: float = 0.0
) -> torch.Tensor:
    """Final move [B] (flat action index): the reference's BestEdge
    ordering (EdgeSelector.cpp:515-536: WIN -> +1e8 - distance, LOSS ->
    -1e8 + distance, else visits + expectation * parent visits + 0.001 *
    prior), or visit-count sampling with `temperature` from `generator`."""
    tree = state.tree
    rb = torch.arange(tree.batch, device=state.root_board.device)
    es = edge_stats(tree, rb, state.root_node)
    visits = es.visits.float()
    actions = tree.edge_action[rb, state.root_node]
    valid = actions != NULL
    h, w = state.root_board.shape[1], state.root_board.shape[2]
    if generator is not None and temperature > 0.0:
        logits = torch.where(valid, torch.log(visits.clamp(min=1e-9)) / temperature, float("-inf"))
        slot = torch.multinomial(torch.softmax(logits, -1), 1, generator=generator)[:, 0]
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
