"""Balanced opening generation for self-play and evaluation matches.

Port of the reference package's `selfplay/openings.py` (reference:
include/alphagomoku/selfplay/OpeningGenerator.hpp:23-70,
src/selfplay/OpeningGenerator.cpp:21-66): propose random short openings,
solver-check the candidates (the batched VCT win solver and the loss
prover over all candidates in lockstep, where the reference runs
alpha-beta with a 1000-node limit), then evaluate the survivors with the
network in one batch and keep the ones whose evaluation is closest to
balanced.

The proposal's random cell offsets come from a `torch.Generator`, or are
given by the caller (`offsets`), as are the candidates themselves
(`proposals`), so that a test can feed both sides the same draws.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..game.types import CROSS, CIRCLE, GameOutcome
from ..game import vectorized as V
from ..search import mcts
from ..search import vct_batched


def propose_random_openings(
    generator: torch.Generator | None, count: int, rows: int, cols: int, stones: int,
    span: int = 4, offsets: torch.Tensor | None = None,
) -> torch.Tensor:
    """[count, H, W] int8 boards with `stones` alternating stones placed near
    the center.  Stone i sits at the center plus `offsets[i]` = (row,
    column) offsets [stones, 2, count] in [-span, span], drawn from
    `generator` on its device if not given; a stone that lands on an
    occupied cell shifts by (1, 3), then by (2, 5), modulo the board."""
    if offsets is None:
        offsets = torch.randint(-span, span + 1, (stones, 2, count), generator=generator,
                                device=generator.device)
    dev = offsets.device
    r0, c0 = rows // 2, cols // 2
    boards = torch.zeros((count, rows, cols), dtype=torch.int8, device=dev)
    b = torch.arange(count, device=dev)
    for i in range(stones):
        r = (r0 + offsets[i, 0].long()).clamp(0, rows - 1)
        c = (c0 + offsets[i, 1].long()).clamp(0, cols - 1)
        occupied = boards[b, r, c] != V.NONE
        r = torch.where(occupied, (r + 1) % rows, r)
        c = torch.where(occupied, (c + 3) % cols, c)
        occupied = boards[b, r, c] != V.NONE
        r = torch.where(occupied, (r + 2) % rows, r)
        c = torch.where(occupied, (c + 5) % cols, c)
        sign = CROSS if i % 2 == 0 else CIRCLE
        cell = boards[b, r, c]
        boards[b, r, c] = torch.where(cell == V.NONE, sign, cell)
    return boards


def generate_balanced_openings(
    net_apply: Callable, variables: Any, tables: V.RuleTables,
    generator: torch.Generator | None, count: int, rows: int, cols: int, stones: int = 4,
    oversample: int = 4, raw_input: bool = True, solver_check: bool = True,
    solver_steps: int = 48, proposals: torch.Tensor | None = None,
) -> torch.Tensor:
    """Keep the `count` most balanced of `count * oversample` random
    openings (`proposals` [count * oversample, H, W] if given, else
    `propose_random_openings` from `generator`), judged by the network's
    value head.  With `solver_check`, candidates the batched solver proves
    (a VCT win for the mover or a proven loss) are discarded first: a
    provably decided opening can never be balanced (reference:
    OpeningGenerator.cpp:21-66).  The kept boards come most balanced
    first, the lower index first among equals, as `lax.top_k` orders
    them."""
    n = count * oversample
    cand = (proposals if proposals is not None
            else propose_random_openings(generator, n, rows, cols, stones))
    stm = torch.full((n,), CROSS if stones % 2 == 0 else CIRCLE, dtype=torch.int8,
                     device=cand.device)
    with torch.no_grad():
        _, value, _, _, _, _ = mcts._evaluate(net_apply, variables, tables, cand, stm, raw_input)
    imbalance = (value[:, 0] + 0.5 * value[:, 1] - 0.5).abs()
    if solver_check:
        sres = vct_batched.solve(tables, cand, stm, max_depth=6, max_steps=solver_steps)
        lres = vct_batched.solve_loss(tables, cand, stm, max_options=8, max_depth=6,
                                      max_steps=solver_steps)
        imbalance = torch.where(sres.win | lres.loss, float("inf"), imbalance)
    idx = torch.sort(-imbalance, descending=True, stable=True).indices[:count]
    return cand[idx]


def opening_env(boards: torch.Tensor, stones: int) -> V.EnvState:
    """The env of games started from opening `boards` of `stones` stones,
    as the reference package's training manager builds it
    (`alphagomoku_tpu/training/manager.py:343-356`): the side to move
    after `stones` alternating stones, no outcome, the stones counted."""
    bsz = boards.shape[0]
    dev = boards.device
    return V.EnvState(
        board=boards,
        to_move=torch.full((bsz,), CROSS if stones % 2 == 0 else CIRCLE, dtype=torch.int8,
                           device=dev),
        outcome=torch.full((bsz,), int(GameOutcome.UNKNOWN), dtype=torch.int8, device=dev),
        move_count=(boards != 0).sum((1, 2)).int(),
    )
