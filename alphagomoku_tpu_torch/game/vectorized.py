"""Batched game rules on `[B, H, W]` int8 boards: the search path's subset.

Port of the reference package's `game/vectorized.py` for freestyle,
standard, caro5 and caro6: line-window extraction and the outcome check
after a move.  Windows are packed 22-bit values (2 bits per cell over 11
cells, the center masked to NONE) carried in int64.

Renju's forbidden-move recursion (`is_forbidden_u`, `forbidden_plane_u` in
the reference package) is not ported yet; every entry point that would
need it raises NotImplementedError (see `RENJU_NOT_PORTED`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .types import CIRCLE, ILLEGAL, DIRECTION_STEPS, GameRules, GameOutcome
from ..patterns import bitwise
from ..patterns import tables as T

PAD = T.CENTER  # 5

RENJU_NOT_PORTED = (
    "renju forbidden moves are not ported yet (ROADMAP.md, 'Modules to "
    "port', item 3b: the renju forbidden-move recursion)"
)

# window cell offsets along a direction, center excluded
_OFFSETS = [i for i in range(-PAD, PAD + 1) if i != 0]


class RuleTables(NamedTuple):
    """The rule variant the batched functions run under.  The port
    classifies with bit math, so no lookup tables ride along."""

    rules: int  # GameRules


def device_tables(rules: GameRules) -> RuleTables:
    rules = GameRules(rules)
    if rules == GameRules.RENJU:
        raise NotImplementedError(RENJU_NOT_PORTED)
    return RuleTables(rules=int(rules))


def check_rules(tables: RuleTables) -> None:
    if tables.rules == GameRules.RENJU:
        raise NotImplementedError(RENJU_NOT_PORTED)


def pad_board(board: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H+10, W+10] padded with ILLEGAL."""
    bsz, h, w = board.shape
    out = torch.full(
        (bsz, h + 2 * PAD, w + 2 * PAD), ILLEGAL, dtype=board.dtype, device=board.device
    )
    out[:, PAD : PAD + h, PAD : PAD + w] = board
    return out


def windows_all(board: torch.Tensor) -> torch.Tensor:
    """Packed 22-bit windows for EVERY cell: [B, H, W] -> [B, 4, H, W] int64."""
    bsz, h, w = board.shape
    p = pad_board(board).to(torch.int64)
    out = []
    for dr, dc in DIRECTION_STEPS:
        acc = torch.zeros((bsz, h, w), dtype=torch.int64, device=board.device)
        for i in _OFFSETS:
            sl = p[:, PAD + i * dr : PAD + i * dr + h, PAD + i * dc : PAD + i * dc + w]
            acc = acc | (sl << (2 * (i + PAD)))
        out.append(acc)
    return torch.stack(out, dim=1)


def windows_at_one(
    board: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    """Packed windows for ONE in-bounds query cell per board:
    [B, H, W] + [B] -> [B, 4] int64 (one gather of the 40 window cells)."""
    p = pad_board(board).to(torch.int64)
    dr, dc, shifts = _window_geometry(board.device)
    r = rows.long()[:, None, None] + PAD + dr
    c = cols.long()[:, None, None] + PAD + dc
    b = torch.arange(board.shape[0], device=board.device)[:, None, None]
    cells = p[b, r, c]  # [B, 4, 10]
    return (cells << shifts).sum(-1)  # disjoint bit fields: sum == OR


@functools.lru_cache(maxsize=None)
def _window_geometry(device: torch.device):
    """Row/column steps [4, 10] of the window cells and their bit shifts
    [10], built once per device (no host copies inside the search step)."""
    steps = torch.tensor(DIRECTION_STEPS)
    offs = torch.tensor(_OFFSETS)
    dr = steps[:, 0, None] * offs[None, :]
    dc = steps[:, 1, None] * offs[None, :]
    return dr.to(device), dc.to(device), (2 * (offs + PAD)).to(device)


def outcome_after(
    tables: RuleTables,
    board: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    signs: torch.Tensor,
    move_count: torch.Tensor,
    draw_after: int,
) -> torch.Tensor:
    """GameOutcome [B] int8 after `signs` played at (rows, cols); `board`
    must already contain the move.  `move_count` counts stones including
    this move (reference: src/game/rules.cpp:110-133)."""
    check_rules(tables)
    is_circle = signs == CIRCLE
    fx, fo = bitwise.five_mask(windows_at_one(board, rows, cols), GameRules(tables.rules))
    five = torch.where(is_circle[:, None], fo, fx).any(-1)
    win = torch.where(
        is_circle, int(GameOutcome.CIRCLE_WIN), int(GameOutcome.CROSS_WIN)
    ).to(torch.int8)
    out = torch.full_like(signs, int(GameOutcome.UNKNOWN), dtype=torch.int8)
    out = torch.where(move_count >= draw_after, int(GameOutcome.DRAW), out).to(torch.int8)
    return torch.where(five, win, out)
