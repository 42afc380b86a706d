"""Batched game rules on `[B, H, W]` int8 boards: the search path's subset.

Port of the reference package's `game/vectorized.py` for freestyle,
standard, caro5 and caro6: line-window extraction, the outcome check after
a move, and the ThreatType lookup.  Windows are packed 22-bit values (2
bits per cell over 11 cells, the center masked to NONE) carried in int64.

Renju's forbidden-move recursion (`is_forbidden_u`, `forbidden_plane_u` in
the reference package) is not ported yet; every entry point that would
need it raises NotImplementedError (see `RENJU_NOT_PORTED`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
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
    """Packed 22-bit windows for EVERY cell: [B, H, W] -> [B, 4, H, W] int64
    (one gather of the 40 window cells of every cell from the padded
    board)."""
    bsz, h, w = board.shape
    idx, shifts = _all_window_index(h, w, board.device)
    cells = pad_board(board).reshape(bsz, -1).to(torch.int64)[:, idx]  # [B, 4, 10, HW]
    return (cells << shifts[:, None]).sum(2).reshape(bsz, 4, h, w)  # disjoint fields: sum == OR


@functools.lru_cache(maxsize=None)
def _all_window_index(h: int, w: int, device: torch.device):
    """Flat indices [4, 10, H*W] into the padded board of the window cells
    of every cell, and the cells' bit shifts [10]."""
    pw = w + 2 * PAD
    r = torch.arange(h)[:, None] + PAD
    c = torch.arange(w)[None, :] + PAD
    idx = torch.stack([
        torch.stack([((r + i * dr) * pw + c + i * dc).reshape(-1) for i in _OFFSETS])
        for dr, dc in DIRECTION_STEPS
    ])
    shifts = 2 * (torch.tensor(_OFFSETS) + PAD)
    return idx.to(device), shifts.to(device)


def windows_at_one(
    board: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    """Packed windows for ONE in-bounds query cell per board:
    [B, H, W] + [B] -> [B, 4] int64 (one gather of the 40 window cells)."""
    bsz, h, w = board.shape
    idx, shifts = _all_window_index(h, w, board.device)
    cell = rows.long() * w + cols.long()
    sel = idx[:, :, cell].permute(2, 0, 1).reshape(bsz, -1)  # [B, 40]
    cells = pad_board(board).reshape(bsz, -1).to(torch.int64).gather(1, sel)
    return (cells.reshape(bsz, 4, -1) << shifts).sum(-1)  # disjoint bit fields: sum == OR


def threat_type(tables: RuleTables, pts: torch.Tensor, sign_is_circle) -> torch.Tensor:
    """Combine 4 directional PatternTypes (last axis) into a ThreatType;
    `sign_is_circle` is a bool broadcastable to `pts.shape[:-1]`."""
    pts = pts.long()
    idx = pts[..., 0] | (pts[..., 1] << 3) | (pts[..., 2] << 6) | (pts[..., 3] << 9)
    enc = _threat_table(GameRules(tables.rules), pts.device)[idx]
    circle = torch.as_tensor(sign_is_circle, device=enc.device)
    return (enc >> torch.where(circle, 4, 0)) & 15


@functools.lru_cache(maxsize=None)
def _threat_table(rules: GameRules, device: torch.device) -> torch.Tensor:
    """int32 [8^4]: ThreatType nibbles (cross | circle << 4), on `device`
    at its first use there."""
    return torch.from_numpy(T._build_threat_table(rules).astype(np.int32)).to(device)


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
