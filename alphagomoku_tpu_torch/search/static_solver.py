"""Static threat solver: forced-win / forced-loss detection from the packed
feature map, as tensor bit arithmetic.

Port of the reference package's `search/static_solver.py` (the sound core
of the reference's staged tactical move generator, reference:
src/search/alpha_beta/MoveGenerator.cpp stages win_in_1, draw_in_1,
defend loss_in_2, win_in_3):
  1. win_in_1:   own five-completion cells -> win_in(1).
  2. loss_in_2:  with an opponent five threat only blocks (or own wins)
     are playable; two or more completion cells lose in 2.
  3. win_in_3:   open four / double four / 4x4 fork cells with no opponent
     five threat -> win_in(3).
  4. draw_in_1:  one move from the draw horizon, every legal non-winning
     cell draws; deeper stages are gated by the same distance arithmetic
     (MoveGenerator.cpp:162-186).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import score as S

# feature bit offsets (patterns.features; reference NNInputFeatures layout)
_OWN = 8
_OPP = 20
_HO4_SHIFT = 4  # within a player group: bits 4-7 half-open four per direction
_OPEN4_BIT = 8
_DOUBLE4_BIT = 9
_FIVE_BIT = 10


class StaticAnalysis(NamedTuple):
    """Per-cell tactical scores + playable-move restriction."""

    action_scores: torch.Tensor  # [B, H, W] int32 packed Score (mover's view)
    restrict: torch.Tensor  # [B, H, W] bool: moves worth generating
    node_score: torch.Tensor  # [B] int32: statically proven position score


def _popcount4(x: torch.Tensor) -> torch.Tensor:
    return (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1) + ((x >> 3) & 1)


def analyze(
    packed: torch.Tensor, legal: torch.Tensor, dist_to_draw: torch.Tensor | None = None
) -> StaticAnalysis:
    """Run the static stages on a packed feature map [B, H, W].

    `legal` excludes occupied cells.  Scores and the restriction mask are
    from the side-to-move's perspective.  `dist_to_draw` [B] = draw_after -
    stones enables draw proving and the distance gating; None means an
    unreachable horizon."""
    own = (packed >> _OWN) & 0xFFF
    opp = (packed >> _OPP) & 0xFFF

    own5 = legal & (((own >> _FIVE_BIT) & 1) == 1)
    opp5 = legal & (((opp >> _FIVE_BIT) & 1) == 1)

    own_ho4 = _popcount4((own >> _HO4_SHIFT) & 0xF)
    own_open4 = ((own >> _OPEN4_BIT) & 1) == 1
    own_d4 = ((own >> _DOUBLE4_BIT) & 1) == 1
    own_win3 = legal & (own_open4 | own_d4 | (own_ho4 + own_open4.long() >= 2))

    any_own5 = own5.any(dim=(1, 2))
    n_opp5 = opp5.sum(dim=(1, 2))
    any_opp5 = n_opp5 > 0
    lost2 = (~any_own5) & (n_opp5 >= 2)

    bsz = packed.shape[0]
    if dist_to_draw is None:
        dtd3 = dtd2 = torch.ones(bsz, dtype=torch.bool, device=packed.device)
        draw1 = torch.zeros(bsz, dtype=torch.bool, device=packed.device)
    else:
        dtd3 = dist_to_draw >= 3
        dtd2 = dist_to_draw >= 2
        draw1 = dist_to_draw == 1

    # per-cell scores, later stages never overwrite earlier ones
    scores = torch.full(packed.shape, S.zero(), dtype=torch.int32, device=packed.device)
    win3_ok = own_win3 & (~any_opp5 & dtd3)[:, None, None]
    scores = torch.where(win3_ok, S.win_in(3), scores)
    blockers = own5 | opp5  # playing the opponent's completion cell blocks it
    loses2 = ((any_opp5 & dtd2)[:, None, None] & ~blockers) | (lost2 & dtd2)[:, None, None]
    scores = torch.where(legal & loses2, S.loss_in(2), scores)
    scores = torch.where(draw1[:, None, None] & legal & ~own5, S.draw_in(1), scores)
    scores = torch.where(own5, S.win_in(1), scores)
    scores = torch.where(legal, scores, S.zero())

    # with an opponent five on the board only wins/blocks are worth
    # generating (reference: must_defend edges); never restrict to nothing
    restrict = torch.where(
        (any_opp5 & ~any_own5 & dtd2)[:, None, None], blockers & legal, legal
    )
    restrict = torch.where(restrict.any(dim=(1, 2), keepdim=True), restrict, legal)

    node_score = torch.where(
        any_own5, S.win_in(1), torch.where(lost2 & dtd2, S.loss_in(2), S.zero())
    )
    if dist_to_draw is not None:
        any_legal = legal.any(dim=(1, 2))
        node_score = torch.where(
            draw1 & ~any_own5,
            torch.where(any_legal, S.draw_in(1), S.loss_in(1)),
            node_score,
        )
    return StaticAnalysis(scores, restrict, node_score.to(torch.int32))
