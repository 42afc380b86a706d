"""Exact rules engine (host side, NumPy): outcomes and renju forbidden moves.

This module is the framework's in-process golden model: single-position,
exact-recursion implementations used for parity tests, data validation, and
protocol-level queries (SHOWFORBID).  The batched tensor paths live in
`game.vectorized`.  A copy of the reference package's `game/rules.py`; its
pattern and threat tables come from the port's `patterns.tables.get_tables`.

Semantics replicate the reference exactly:
- outcome from the last move via 11-cell pattern window lookups
  (reference: src/game/rules.cpp:110-133)
- renju forbidden moves with recursive fake-open-three resolution
  (reference: src/game/rules.cpp:134-173)
"""

from __future__ import annotations

import numpy as np

from .types import (
    NONE,
    CROSS,
    CIRCLE,
    ILLEGAL,
    DIRECTION_STEPS,
    GameRules,
    GameOutcome,
    Move,
)
from ..patterns.tables import (
    PT_FIVE,
    PT_OPEN_3,
    TT_FORK_3x3,
    TT_FORK_4x4,
    TT_OVERLINE,
    CENTER,
    PATTERN_LENGTH,
    get_tables,
    narrow_down,
    open_three_promotion_moves,
)

_PAD = CENTER  # 5 cells on each side of the center


def get_window(board: np.ndarray, row: int, col: int, direction: int) -> int:
    """22-bit packed 11-cell window around (row, col) in `direction`.

    Out-of-board cells read ILLEGAL; the center cell is masked to NONE if
    occupied, because pattern keys require an empty center
    (reference: RawPatternCalculator::getPatternsAt,
    include/.../patterns/RawPatternCalculator.hpp:113-141).
    """
    h, w = board.shape
    dr, dc = DIRECTION_STEPS[direction]
    window = 0
    for i in range(-_PAD, _PAD + 1):
        r, c = row + i * dr, col + i * dc
        cell = int(board[r, c]) if (0 <= r < h and 0 <= c < w) else ILLEGAL
        window |= cell << (2 * (i + _PAD))
    window &= ~(3 << (2 * CENTER))
    return window


def pattern_types_at(
    rules: GameRules, board: np.ndarray, row: int, col: int, sign: int
) -> list[int]:
    """PatternType per direction for a stone of `sign` at (row, col)."""
    pattern_table = get_tables(rules)[0]
    shift = 0 if sign == CROSS else 4
    out = []
    for direction in range(4):
        key = narrow_down(get_window(board, row, col, direction))
        out.append((int(pattern_table[key]) >> shift) & 15)
    return out


def threat_type_at(
    rules: GameRules, board: np.ndarray, row: int, col: int, sign: int
) -> int:
    """ThreatType for a stone of `sign` at (row, col) (naive, no renju
    fake-three resolution)."""
    pts = pattern_types_at(rules, board, row, col, sign)
    return _threat_lookup(rules, pts, sign)


def _threat_lookup(rules: GameRules, pts: list[int], sign: int) -> int:
    threat_table = get_tables(rules)[1]
    idx = pts[0] | (pts[1] << 3) | (pts[2] << 6) | (pts[3] << 9)
    shift = 0 if sign == CROSS else 4
    return (int(threat_table[idx]) >> shift) & 15


def is_straight_four_at(board: np.ndarray, row: int, col: int, direction: int) -> bool:
    """After placing a cross at (row, col), does `direction` contain four
    crosses in a row? (reference: RawPatternCalculator::isStraightFourAt,
    RawPatternCalculator.hpp:142-177 — intentionally just a 4-in-a-row scan;
    candidates come pre-filtered from the promotion-move table)."""
    assert board[row, col] == NONE
    window = get_window(board, row, col, direction)
    window |= CROSS << (2 * CENTER)
    for start in range(PATTERN_LENGTH - 4 + 1):
        if (window >> (2 * start)) & 255 == 0b01010101:  # four CROSS cells
            return True
    return False


def is_forbidden(board: np.ndarray, move: Move) -> bool:
    """Renju forbidden-move check with exact recursive fake-three resolution
    (reference: src/game/rules.cpp:134-173)."""
    if move.sign == CIRCLE:
        return False  # white has no forbidden moves

    raw_windows = [get_window(board, move.row, move.col, d) for d in range(4)]
    pattern_table = get_tables(GameRules.RENJU)[0]
    pts = [int(pattern_table[narrow_down(w)]) & 15 for w in raw_windows]
    threat = _threat_lookup(GameRules.RENJU, pts, CROSS)

    if threat == TT_FORK_3x3:
        tmp = board.copy()
        tmp[move.row, move.col] = NONE  # in case the spot is already occupied
        for direction in range(4):
            if pts[direction] != PT_OPEN_3:
                continue
            tmp[move.row, move.col] = CROSS
            promo = open_three_promotion_moves(raw_windows[direction])
            dr, dc = DIRECTION_STEPS[direction]
            really_open3 = False
            for i in range(-_PAD, _PAD + 1):
                if i == 0 or not (promo >> (_PAD + i)) & 1:
                    continue
                r, c = move.row + i * dr, move.col + i * dc
                if tmp[r, c] != NONE:  # promotion spot never outside board
                    continue
                if is_straight_four_at(tmp, r, c, direction) and not is_forbidden(
                    tmp, Move(r, c, CROSS)
                ):
                    really_open3 = True
                    break
            tmp[move.row, move.col] = NONE
            if not really_open3:
                pts[direction] = 0  # fake three
        threat = _threat_lookup(GameRules.RENJU, pts, CROSS)

    return threat in (TT_OVERLINE, TT_FORK_4x4, TT_FORK_3x3)


def get_outcome(
    rules: GameRules,
    board: np.ndarray,
    last_move: Move,
    number_of_moves_for_draw: int = 0,
) -> GameOutcome:
    """Outcome after `last_move` (reference: src/game/rules.cpp:110-133).

    The move may or may not already be placed on `board`; the pattern window
    masks the center, exactly like the reference.
    """
    h, w = board.shape
    if not (0 <= last_move.row < h and 0 <= last_move.col < w):
        return GameOutcome.UNKNOWN
    assert last_move.sign != NONE
    pts = pattern_types_at(rules, board, last_move.row, last_move.col, last_move.sign)
    if PT_FIVE in pts:
        return GameOutcome.CROSS_WIN if last_move.sign == CROSS else GameOutcome.CIRCLE_WIN
    if rules == GameRules.RENJU and is_forbidden(board, last_move):
        return GameOutcome.CIRCLE_WIN

    moves = int((board != NONE).sum())
    if number_of_moves_for_draw > 0:
        is_draw = moves >= number_of_moves_for_draw
    else:
        is_draw = moves >= h * w
    return GameOutcome.DRAW if is_draw else GameOutcome.UNKNOWN
