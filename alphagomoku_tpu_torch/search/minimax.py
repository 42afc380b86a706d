"""Host validation minimax / alpha-beta over the staged move generator.

Counterpart of the reference's MinimaxSearch
(reference: src/search/alpha_beta/MinimaxSearch.cpp — the reference ships
the class with its algorithm COMMENTED OUT, as a validation scaffold; this
module implements the documented algorithm so it can actually be used to
validate the batched solvers in tests: depth-limited negamax where each
node's move list comes from MoveGenerator.generate and statically proven
scores cut off immediately, MinimaxSearch.cpp:80-113).

`solve_ab` adds the reference AlphaBetaSearch shape on top: alpha-beta
windows, move ordering by the generator's scores, the threat-histogram
static evaluation at depth 0 (exact constants of
AlphaBetaSearch::evaluate, AlphaBetaSearch.cpp:345-365), and the
iterative-deepening loop stepping depth by 4 until a proven score
(AlphaBetaSearch::solve, :91-135).

Host-side NumPy (a test oracle, not a hot path).  Scores are the packed
16-bit host ints of search/move_generator.py.  A copy of the reference
package's `search/minimax.py`.
"""

from __future__ import annotations

import numpy as np

from ..game.types import GameRules, NONE, invert_sign
from ..patterns import host as PH
from ..patterns import tables as PT
from . import move_generator as MG

# threat-histogram evaluation constants (parity data:
# AlphaBetaSearch::evaluate, AlphaBetaSearch.cpp:356-357)
_EVAL_OWN = (0, 0, 19, 49, 76, 170, 33, 159, 252, 0)
_EVAL_OPP = (0, 0, -1, -50, -45, -135, -14, -154, -496, 0)


def evaluate(board: np.ndarray, stm: int, rules: GameRules) -> int:
    """Static threat-histogram evaluation, clipped to +/-1000 (reference:
    AlphaBetaSearch::evaluate over ThreatType OPEN_3..FIVE counts)."""
    ana = PH.analyze(np.asarray(board, np.int8), rules)
    opp = invert_sign(stm)
    empty = board == NONE
    result = 12
    for tt in range(PT.TT_OPEN_3, PT.TT_FIVE + 1):
        result += _EVAL_OWN[tt] * int(((ana.tt[stm] == tt) & empty).sum())
        result += _EVAL_OPP[tt] * int(((ana.tt[opp] == tt) & empty).sum())
    return MG.score(max(-1000, min(1000, result)))


def invert_up(s: int) -> int:
    """Child score -> parent view: negate + one ply farther
    (reference: Score::invert_up = -score with increased distance)."""
    pv = s >> 13
    ev = (s & 8191) - 4000
    if s in (0, 0xFFFF):
        return 0xFFFF if s == 0 else 0
    if pv == MG._PV_WIN:
        return MG.loss_in(-ev + 1)
    if pv == MG._PV_LOSS:
        return MG.win_in(ev + 1)
    if pv == MG._PV_DRAW:
        return MG.draw_in(ev + 1)
    return MG.score(-ev)


def solve(
    board: np.ndarray,
    stm: int,
    rules: GameRules,
    depth: int = 4,
    mode: str | None = None,
    draw_after: int | None = None,
    node_budget: int = 200000,
) -> tuple[int, dict]:
    """Negamax to `depth` plies; returns (packed score from `stm`'s view,
    {(row, col): packed score} for the root actions).

    UNKNOWN propagates as the reference's evaluate() stub does (Score()),
    so a non-proven subtree yields UNKNOWN — only PROVEN results are
    meaningful, which is exactly what a validation oracle needs."""
    board = np.asarray(board, np.int8).copy()
    state = {"nodes": 0}

    def rec(sign: int, d: int, root: bool = False) -> tuple[int, dict | None]:
        state["nodes"] += 1
        # reference: OPTIMAL at the root (full list for the caller), the
        # tactical THREATS mode below (AlphaBetaSearch.cpp:236 mode pick)
        gen_mode = mode if mode is not None else ("optimal" if root else "threats")
        actions, static_score = MG.generate(
            board, sign, rules, mode=gen_mode, draw_after=draw_after
        )
        if MG.is_proven(static_score):
            return static_score, dict(actions.moves)
        if d <= 0 or state["nodes"] >= node_budget:
            return MG.UNKNOWN, dict(actions.moves)
        best = MG.MIN_VALUE
        out = {}
        for rc in actions.locations():
            s0 = actions.moves[rc]
            if MG.is_proven(s0):
                sc = s0
            else:
                board[rc] = sign
                child, _ = rec(invert_sign(sign), d - 1)
                board[rc] = NONE
                sc = invert_up(child)
            out[rc] = sc
            best = max(best, sc)
            if MG.is_win(sc):
                break
        if best == MG.MIN_VALUE:
            best = MG.UNKNOWN
        # a fail-low LOSS (or DRAW) is only proven over a complete move set
        if not actions.is_fully_expanded and not MG.is_win(best) and (
            MG.is_proven(best)
        ):
            best = MG.UNKNOWN
        return best, out

    score, root_actions = rec(int(stm), int(depth), root=True)
    return score, (root_actions or {})


def invert_down(s: int) -> int:
    """Parent bound -> child view (inverse of invert_up: negate + one ply
    closer; reference: Score::invert_down)."""
    pv = s >> 13
    ev = (s & 8191) - 4000
    if s in (0, 0xFFFF):
        return 0xFFFF if s == 0 else 0
    if pv == MG._PV_WIN:
        return MG.loss_in(-ev - 1)
    if pv == MG._PV_LOSS:
        return MG.win_in(ev - 1)
    if pv == MG._PV_DRAW:
        return MG.draw_in(ev - 1)
    return MG.score(-ev)


MINUS_INF = 0
PLUS_INF = 0xFFFF


def solve_ab(
    board: np.ndarray,
    stm: int,
    rules: GameRules,
    max_depth: int = 8,
    draw_after: int | None = None,
    node_budget: int = 100000,
) -> tuple[int, dict]:
    """Eval-bounded iterative-deepening alpha-beta (the host twin of
    AlphaBetaSearch::solve/recursive_solve, AlphaBetaSearch.cpp:91-135,
    185-343): depth steps by 4; within a depth, negamax with alpha-beta
    windows (bounds inverted per ply like the reference), actions ordered
    by the generator's scores, the threat-histogram evaluation at depth 0,
    and the reference's fail-low guard (a LOSS over an incomplete move set
    is overridden by the evaluation).  Returns (packed score, root action
    scores)."""
    board = np.asarray(board, np.int8).copy()
    state = {"nodes": 0}

    def rec(sign: int, d: int, alpha: int, beta: int, root: bool) -> tuple[int, dict]:
        state["nodes"] += 1
        gen_mode = "optimal" if root else "threats"
        actions, static_score = MG.generate(
            board, sign, rules, mode=gen_mode, draw_after=draw_after
        )
        if MG.is_proven(static_score):
            return static_score, dict(actions.moves)
        if d <= 0 or state["nodes"] >= node_budget:
            return evaluate(board, sign, rules), dict(actions.moves)
        # move ordering: strongest generated score first (reference sorts
        # the remaining actions each pick, recursive_solve:270-277)
        order = sorted(actions.moves, key=lambda rc: -actions.moves[rc])
        best = MINUS_INF
        out = dict(actions.moves)
        for rc in order:
            s0 = actions.moves[rc]
            if MG.is_proven(s0):
                sc = s0
            else:
                board[rc] = sign
                child, _ = rec(
                    invert_sign(sign), d - 1,
                    invert_down(beta), invert_down(alpha), False,
                )
                board[rc] = NONE
                sc = invert_up(child)
            out[rc] = sc
            best = max(best, sc)
            alpha = max(alpha, sc)
            if sc >= beta or MG.is_win(sc):
                break
        # reference: all-losing over an incomplete set (or nothing searched)
        # falls back to the evaluation (recursive_solve:318-321)
        low = best == MINUS_INF or (
            (best >> 13) == MG._PV_LOSS and not actions.is_fully_expanded
        )
        if low:
            best = evaluate(board, sign, rules)
        return best, out

    # deepening starts at 4, NOT 0: a depth-0 root always visits exactly one
    # node (static-proven return or leaf evaluation), which would trip the
    # no-new-nodes break before any recursion happened (advisor r4 finding)
    result, root_actions = MG.UNKNOWN, {}
    for depth in range(4, max(max_depth, 4) + 1, 4):
        before = state["nodes"]
        result, root_actions = rec(int(stm), depth, MINUS_INF, PLUS_INF, True)
        if (
            MG.is_proven(result)
            or state["nodes"] >= node_budget
            or state["nodes"] == before + 1  # root-only: all actions static
        ):
            break
    return result, root_actions
