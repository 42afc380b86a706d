"""Paired-game match evaluation: engines play the same openings, colors swapped.

Port of the reference package's `eval/match.py` (reference:
src/evaluation/{EvaluationManager,EvaluationThread,EvaluationGame,
TwoMatch}.cpp): a lockstep batch of games laid out so that at every ply
one contiguous half per opponent block is to move for each engine; each
ply is one batched search for the candidate across ALL opponent blocks
and one per opponent, then `select_move` at temperature 0 and `env_step`.

Game pair i: game i has engine A as cross, game G+i has engine B as cross,
both replay the same opening (reference: TwoMatch.hpp:16-26).  Scoring is
pentanomial over pairs (0, 1, 2, 3, 4 points) feeding Elo and GSPRT
(reference: src/tuning/GSPRT.cpp convert_match_results).

Multi-opponent rating (reference: EvaluationManager with a different second
player per thread, EvaluationManager.hpp:29-52) is `play_multi_match`: one
candidate against K opponents in one lockstep run.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..game.types import CROSS, CIRCLE, GameOutcome
from ..game import vectorized as V
from ..search import mcts


class MatchResult(NamedTuple):
    outcomes: np.ndarray  # [2G] int8 GameOutcome
    pentanomial: np.ndarray  # [5] counts of pair points {0..4}
    score_a: float  # A's match score in [0, 1]
    elo_a: float  # Elo of A vs B
    game_lengths: np.ndarray  # [2G]
    truncated: int = 0  # games cut at max_moves (value-adjudicated)


class Opponent(NamedTuple):
    """One second player in a multi-opponent rating run (reference:
    EvaluationManager::setSecondPlayer per evaluator thread)."""

    net_apply: Callable
    variables: Any
    raw_input: bool = True
    mcfg: mcts.MCTSConfig | None = None
    name: str = ""
    # False for opponents without a calibrated value head (e.g. an anchor
    # with a uniform value): agree-or-draw adjudication would be vacuous,
    # so such blocks EXCLUDE truncated pairs from the score instead
    calibrated_value: bool = True


def random_openings(
    rng: np.random.Generator, games: int, rows: int, cols: int, stones: int = 4
) -> np.ndarray:
    """Random central openings with alternating colors [G, H, W] int8
    (stand-in for the reference's balanced OpeningGenerator;
    reference: selfplay/OpeningGenerator.hpp:23-70)."""
    boards = np.zeros((games, rows, cols), np.int8)
    r0, c0 = rows // 2, cols // 2
    span = 3
    for g in range(games):
        cells = set()
        while len(cells) < stones:
            r = int(np.clip(r0 + rng.integers(-span, span + 1), 0, rows - 1))
            c = int(np.clip(c0 + rng.integers(-span, span + 1), 0, cols - 1))
            cells.add((r, c))
        for i, (r, c) in enumerate(sorted(cells)):
            boards[g, r, c] = CROSS if i % 2 == 0 else CIRCLE
    return boards


def _score_pairs(
    outcomes: np.ndarray,
    g: int,
    adjudicated: np.ndarray | None = None,
    exclude: np.ndarray | None = None,
) -> tuple[np.ndarray, float]:
    """Pentanomial pair scores for A over [2G] outcomes (game i: A=cross,
    game G+i: A=circle).  `adjudicated` [2G] optionally replaces UNKNOWN
    outcomes (truncation adjudication); `exclude` [2G] drops the whole
    pair from the score when either of its games is flagged (used when the
    opponent cannot adjudicate).  With no pair left the score is 0.5, as
    in the reference package (ROADMAP.md §3, behaviours kept)."""

    def points(outcome: int, a_sign: int) -> int:
        """A's points in one game (reference: GSPRT.cpp get_points)."""
        if outcome in (int(GameOutcome.DRAW), int(GameOutcome.UNKNOWN)):
            return 1
        won_cross = outcome == int(GameOutcome.CROSS_WIN)
        return 2 if (won_cross == (a_sign == CROSS)) else 0

    eff = outcomes.copy()
    if adjudicated is not None:
        unk = eff == int(GameOutcome.UNKNOWN)
        eff[unk] = adjudicated[unk]
    penta = np.zeros(5, np.int64)
    total = 0
    pairs = 0
    for i in range(g):
        if exclude is not None and (exclude[i] or exclude[g + i]):
            continue
        p = points(int(eff[i]), CROSS) + points(int(eff[g + i]), CIRCLE)
        penta[p] += 1
        total += p
        pairs += 1
    return penta, (total / (4.0 * pairs)) if pairs else 0.5


@torch.no_grad()
def _expectation_cross(
    net_apply: Callable, variables: Any, tables: V.RuleTables, boards: torch.Tensor,
    stm: torch.Tensor, raw_input: bool,
) -> np.ndarray:
    """One net's cross-perspective expectation of each position [N]."""
    _, value, _, _, _, _ = mcts._evaluate(net_apply, variables, tables, boards, stm, raw_input)
    value = value.float().cpu().numpy()
    exp_stm = value[:, 0] + 0.5 * value[:, 1]
    return np.where(stm.cpu().numpy() == CROSS, exp_stm, 1.0 - exp_stm)


def _adjudicate_pair(exp_a: np.ndarray, exp_b: np.ndarray) -> np.ndarray:
    """Value-adjudicate unfinished positions with BOTH engines' nets: a win
    is awarded only when the two evaluations AGREE on the same side at the
    fixed thresholds; any disagreement scores a draw (the reference never
    truncates, so adjudication only triggers when a caller caps
    max_moves)."""
    out = np.full(exp_a.shape, int(GameOutcome.DRAW), np.int8)
    out[(exp_a > 0.6) & (exp_b > 0.6)] = int(GameOutcome.CROSS_WIN)
    out[(exp_a < 0.4) & (exp_b < 0.4)] = int(GameOutcome.CIRCLE_WIN)
    return out


def play_multi_match(
    net_apply_a: Callable,
    variables_a: Any,
    opponents: Sequence[Opponent],
    tables: V.RuleTables,
    mcfg: mcts.MCTSConfig,
    num_simulations: int,
    openings,  # [G, H, W] with an EVEN stone count (cross to move)
    max_moves: int | None = None,
    raw_input_a: bool = True,
    device="cuda",
    on_ply: Callable[[V.EnvState, torch.Tensor], None] | None = None,
) -> list[MatchResult]:
    """One candidate A against K opponents, same openings for every pairing
    (reference: EvaluationManager multi-opponent rating,
    EvaluationManager.hpp:29-52; TrainingManager::evaluate,
    TrainingManager.cpp:277-309), played on `device`.

    Per ply the candidate's to-move boards across ALL opponent blocks are
    searched as ONE batch; each opponent searches its own block.  With
    `max_moves=None` games play to their rule outcome (the reference
    behavior); a finite cap value-adjudicates leftovers instead of
    scoring free draws.  Every 8 plies the host checks whether all games
    have ended.  `on_ply(env, moves)` sees each ply's env before the moves
    [2KG] (flat cell indices) are played.
    """
    dev = torch.device(device)
    openings = np.asarray(openings.cpu() if torch.is_tensor(openings) else openings)
    k_opp = len(opponents)
    g, h, w = openings.shape
    n_stones = int((openings[0] != 0).sum())
    assert n_stones % 2 == 0, "openings must leave cross to move"
    if max_moves is None:
        max_moves = h * w  # play to outcome (draw_after fills the board)

    # block k: games [2kG, 2kG+G) A=cross; [2kG+G, 2kG+2G) opponent k=cross
    n = 2 * k_opp * g
    env = V.EnvState(
        board=torch.from_numpy(np.concatenate([openings, openings] * k_opp, 0)).to(dev),
        to_move=torch.full((n,), CROSS, dtype=torch.int8, device=dev),
        outcome=torch.full((n,), int(GameOutcome.UNKNOWN), dtype=torch.int8, device=dev),
        move_count=torch.full((n,), n_stones, dtype=torch.int32, device=dev),
    )
    opp_cfgs = [op.mcfg if op.mcfg is not None else mcfg for op in opponents]

    def step(env_state: V.EnvState, a_first: bool) -> V.EnvState:
        board, stm = env_state.board, env_state.to_move
        a_lo = [2 * k * g + (0 if a_first else g) for k in range(k_opp)]
        o_lo = [2 * k * g + (g if a_first else 0) for k in range(k_opp)]
        st_a = mcts.run_search(
            net_apply_a, variables_a, tables, mcfg,
            torch.cat([board[lo:lo + g] for lo in a_lo], 0),
            torch.cat([stm[lo:lo + g] for lo in a_lo], 0),
            num_simulations, raw_input=raw_input_a, device=dev,
        )
        mv_a = mcts.select_move(st_a)
        per_block = []
        for k, op in enumerate(opponents):
            st_o = mcts.run_search(
                op.net_apply, op.variables, tables, opp_cfgs[k], board[o_lo[k]:o_lo[k] + g],
                stm[o_lo[k]:o_lo[k] + g], num_simulations, raw_input=op.raw_input, device=dev,
            )
            mv_o = mcts.select_move(st_o)
            mv_ak = mv_a[k * g:(k + 1) * g]
            per_block += [mv_ak, mv_o] if a_first else [mv_o, mv_ak]
        moves = torch.cat(per_block, 0)
        if on_ply is not None:
            on_ply(env_state, moves)
        return V.env_step(tables, env_state, moves // w, moves % w)

    for ply in range(max_moves - n_stones):
        env = step(env, a_first=ply % 2 == 0)
        if ply % 8 == 7 and bool((env.outcome != int(GameOutcome.UNKNOWN)).all()):
            break

    outcomes = env.outcome.cpu().numpy()
    lengths = env.move_count.cpu().numpy()
    unfinished = outcomes == int(GameOutcome.UNKNOWN)
    adjudicated = None
    if unfinished.any():
        logging.getLogger("alphagomoku_tpu_torch.match").warning(
            "%d/%d games truncated at max_moves=%d (value-adjudicated "
            "by both nets, agree-or-draw)", int(unfinished.sum()), n, max_moves,
        )
        exp_a = _expectation_cross(net_apply_a, variables_a, tables, env.board, env.to_move,
                                   raw_input_a)
        # each opponent adjudicates its own block with its own net
        adjudicated = np.full(outcomes.shape, int(GameOutcome.DRAW), np.int8)
        for k, opp in enumerate(opponents):
            if not opp.calibrated_value:
                continue  # block scored with truncated pairs excluded
            blk = slice(2 * k * g, 2 * (k + 1) * g)
            exp_b = _expectation_cross(opp.net_apply, opp.variables, tables, env.board[blk],
                                       env.to_move[blk], opp.raw_input)
            adjudicated[blk] = _adjudicate_pair(exp_a[blk], exp_b)

    results = []
    for k in range(k_opp):
        blk = slice(2 * k * g, 2 * (k + 1) * g)
        calibrated = opponents[k].calibrated_value
        penta, score = _score_pairs(
            outcomes[blk], g,
            None if (adjudicated is None or not calibrated) else adjudicated[blk],
            exclude=None if (adjudicated is None or calibrated) else unfinished[blk],
        )
        results.append(MatchResult(outcomes[blk], penta, score, elo_from_winrate(score),
                                   lengths[blk], int(unfinished[blk].sum())))
    return results


def play_match(
    net_apply_a: Callable,
    variables_a: Any,
    net_apply_b: Callable,
    variables_b: Any,
    tables: V.RuleTables,
    mcfg: mcts.MCTSConfig,
    num_simulations: int,
    openings,  # [G, H, W] with an EVEN stone count (cross to move)
    max_moves: int | None = None,
    raw_input_a: bool = True,
    raw_input_b: bool = True,
    mcfg_b: mcts.MCTSConfig | None = None,
    device="cuda",
    on_ply: Callable[[V.EnvState, torch.Tensor], None] | None = None,
) -> MatchResult:
    """Run one paired match A vs B; returns pentanomial scores and Elo for A.

    `mcfg_b` lets the two engines differ by search configuration alone
    (parameter tuning matches, reference: tuning_launcher)."""
    return play_multi_match(
        net_apply_a, variables_a, [Opponent(net_apply_b, variables_b, raw_input_b, mcfg_b)],
        tables, mcfg, num_simulations, openings, max_moves=max_moves, raw_input_a=raw_input_a,
        device=device, on_ply=on_ply,
    )[0]


def elo_from_winrate(winrate: float) -> float:
    """(reference: src/tuning/GSPRT.cpp:137-142 elo_from_winrate)"""
    eps = np.finfo(np.float64).eps
    wr = min(1.0 - eps, max(eps, winrate))
    return 400.0 * math.log10(wr / (1.0 - wr))
