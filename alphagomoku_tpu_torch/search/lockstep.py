"""Primitives of the lockstep batched solvers.

Port of the reference package's `search/lockstep.py`.  The VCT and VCF
solvers (`search/vct_batched.py`, `search/vcf.py`) advance a
struct-of-arrays state one transition at a time over a batch of boards;
these are their board mutations, their fixed-stack frame reads and
writes, their position hash and their threat planes.  The reference package writes every read and write as a one-hot
masked select or reduce (per-row gathers serialize on a TPU); here they
are gathers and functional index writes with the same results.  Reads and
writes at an index outside the array (a move of -1, a ply outside the
stack) read 0 / False and write nothing, as the one-hot versions do.

Reference roles: the threat planes mirror the per-node threat histogram
the reference maintains incrementally (src/search/alpha_beta/
ThreatSpaceSearch.cpp SearchTask setup); `hash_boards` mirrors the
solver's Zobrist keys feeding SharedHashTable
(include/alphagomoku/search/ZobristHashing.hpp).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..game.types import CROSS, CIRCLE, NONE, GameRules
from ..game import vectorized as V
from ..patterns import bitwise
from ..patterns import tables as T


def _rows(x: torch.Tensor) -> torch.Tensor:
    """arange over the batch of `x` (cached: the solver reads it often)."""
    return _arange(x.shape[0], x.device)


@lru_cache(maxsize=64)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device)


# ---------------------------------------------------------------------------
# board mutation (mask-gated)
# ---------------------------------------------------------------------------

def place(board: torch.Tensor, mask_b: torch.Tensor, move_b: torch.Tensor, sign) -> torch.Tensor:
    """A copy of `board` [B, H, W] with `sign` (scalar or [B]) at flat cell
    `move_b` [B] of the boards in `mask_b` [B]."""
    bsz, h, w = board.shape
    move = move_b.long()
    ok = mask_b & (move >= 0) & (move < h * w)
    idx = move.clamp(0, h * w - 1)
    sign_b = torch.as_tensor(sign, dtype=board.dtype, device=board.device).expand(bsz)
    out = board.reshape(bsz, h * w).clone()
    b = _rows(board)
    out[b, idx] = torch.where(ok, sign_b, out[b, idx])
    return out.reshape(bsz, h, w)


def unplace(board: torch.Tensor, mask_b: torch.Tensor, move_b: torch.Tensor) -> torch.Tensor:
    """A copy of `board` with flat cell `move_b` emptied on masked boards."""
    return place(board, mask_b, move_b, NONE)


# ---------------------------------------------------------------------------
# fixed-stack frame access
# ---------------------------------------------------------------------------

def plane_at(arr_bdx: torch.Tensor, ply: torch.Tensor) -> torch.Tensor:
    """The [B, X] row of a [B, D, X] array at per-board ply."""
    d = arr_bdx.shape[1]
    ok = (ply >= 0) & (ply < d)
    row = arr_bdx[_rows(arr_bdx), ply.long().clamp(0, d - 1)]
    return row & ok[:, None] if row.dtype == torch.bool else torch.where(ok[:, None], row, 0)


def set_plane(arr_bdx: torch.Tensor, ply: torch.Tensor, mask_b: torch.Tensor,
              new_bx: torch.Tensor) -> None:
    """In place: arr[b, ply[b]] = new[b] where mask_b[b]."""
    d = arr_bdx.shape[1]
    ok = mask_b & (ply >= 0) & (ply < d)
    b, p = _rows(arr_bdx), ply.long().clamp(0, d - 1)
    arr_bdx[b, p] = torch.where(ok[:, None], new_bx.to(arr_bdx.dtype), arr_bdx[b, p])


def col_at(arr_bd: torch.Tensor, ply: torch.Tensor) -> torch.Tensor:
    """arr[b, ply[b]] of a [B, D] array (0 where ply is outside [0, D))."""
    d = arr_bd.shape[1]
    ok = (ply >= 0) & (ply < d)
    return torch.where(ok, arr_bd[_rows(arr_bd), ply.long().clamp(0, d - 1)], 0).to(arr_bd.dtype)


def set_col(arr_bd: torch.Tensor, ply: torch.Tensor, mask_b: torch.Tensor, val_b) -> None:
    """In place: arr[b, ply[b]] = val[b] where mask_b[b]."""
    d = arr_bd.shape[1]
    ok = mask_b & (ply >= 0) & (ply < d)
    b, p = _rows(arr_bd), ply.long().clamp(0, d - 1)
    val = torch.as_tensor(val_b, dtype=arr_bd.dtype, device=arr_bd.device).expand(ok.shape)
    arr_bd[b, p] = torch.where(ok, val, arr_bd[b, p])


# ---------------------------------------------------------------------------
# position hashing
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _zobrist_keys(hw: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-cell uint32 keys for CROSS/CIRCLE stones, two independent
    tables: the reference package's generator, seed and draw order."""
    rng = np.random.RandomState(0xC0FFEE)
    k1 = rng.randint(0, 1 << 32, size=(hw, 3), dtype=np.uint64).astype(np.uint32)
    k2 = rng.randint(0, 1 << 32, size=(hw, 3), dtype=np.uint64).astype(np.uint32)
    return k1[:, CROSS], k1[:, CIRCLE], k2[:, CROSS], k2[:, CIRCLE]


@lru_cache(maxsize=None)
def _device_keys(hw: int, device: torch.device) -> torch.Tensor:
    """[4, HW, 2] int64: the keys of a cell by its value (0 for an empty
    or ILLEGAL cell), for the two hash lanes."""
    k1x, k1o, k2x, k2o = _zobrist_keys(hw)
    keys = np.zeros((4, hw, 2), np.int64)
    keys[CROSS] = np.stack([k1x, k2x], -1)
    keys[CIRCLE] = np.stack([k1o, k2o], -1)
    return torch.from_numpy(keys).to(device)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over dim 1 by pairwise folding (torch has no XOR reduction)."""
    while x.shape[1] > 1:
        n = x.shape[1]
        half = n // 2
        folded = x[:, :half] ^ x[:, half:2 * half]
        x = torch.cat([folded, x[:, 2 * half:]], 1) if n % 2 else folded
    return x[:, 0]


def hash_boards(board: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Position hashes [B] x2 (u32 values in int64): the XOR of per-cell
    keys selected by stone value."""
    bsz, h, w = board.shape
    keys = _device_keys(h * w, board.device)
    flat = board.reshape(bsz, h * w).long()
    sel = keys[flat, _arange(h * w, board.device)[None, :]]  # [B, HW, 2]
    hsh = _xor_reduce(sel)
    return hsh[:, 0], hsh[:, 1]


# ---------------------------------------------------------------------------
# threat classification (full-plane, rule-exact)
# ---------------------------------------------------------------------------

def classify(board: torch.Tensor, rules: GameRules,
             kinds: tuple[str, ...] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(pt_cross, pt_circle) PatternType planes [B, H, W, 4] for every cell
    (only `kinds`, as `bitwise.classify` takes them).  Looked up in the
    pattern table: a transition classifies every cell, and the lookup takes
    a few kernel launches where the bit math takes hundreds."""
    wins4 = V.windows_all(board).movedim(1, -1)
    return bitwise.classify_by_table(wins4, rules, kinds)


def five_plane_of(board: torch.Tensor, rules: GameRules,
                  sign_is_circle: torch.Tensor) -> torch.Tensor:
    """Empty cells completing a five for the per-board sign: [B, H, W]
    (PT_FIVE of the pattern table, which is `bitwise.five_mask`)."""
    px, po = classify(board, rules, ("five",))
    five = torch.where(sign_is_circle[:, None, None, None], po, px) == T.PT_FIVE
    return five.any(-1) & (board == NONE)


def five_plane(pts: torch.Tensor, empty: torch.Tensor) -> torch.Tensor:
    """Empty cells completing a five for the classified actor: [B, H, W]."""
    return (pts == T.PT_FIVE).any(-1) & empty


def actor_planes(pts: torch.Tensor, empty: torch.Tensor, is_cross_actor=False,
                 renju: bool = False) -> dict:
    """Threat planes for one actor from its PatternType planes [B,H,W,4]
    (reference: MoveGenerator threat staging); under renju black is
    restricted (rules.cpp forbidden classes), `is_cross_actor` a bool
    broadcastable to [B, H, W].  All entries are [B, H, W] (n3 counts);
    renju adds `certain_forb` (overline, a double-four line or fours in
    two directions: forbidden without the 3x3 recursion) and
    `maybe_forb` (those and the naive 3x3 forks)."""
    five = (pts == T.PT_FIVE).any(-1) & empty
    n4 = ((pts == T.PT_HALF_OPEN_4) | (pts == T.PT_OPEN_4) | (pts == T.PT_DOUBLE_4)).sum(-1)
    any_d4 = (pts == T.PT_DOUBLE_4).any(-1)
    any_o4 = (pts == T.PT_OPEN_4).any(-1)
    n3 = (pts == T.PT_OPEN_3).sum(-1)
    four = (n4 >= 1) & empty
    win3 = (any_o4 | any_d4 | (n4 + any_o4.to(n4.dtype) >= 2)) & empty
    three = (n3 >= 1) & empty
    if not renju:
        return dict(five=five, four=four, win3=win3, three=three, n3=n3)
    certain = ((pts == T.PT_OVERLINE).any(-1) | any_d4 | (n4 >= 2)) & is_cross_actor
    maybe = certain | ((n3 >= 2) & is_cross_actor)
    # black's double-four and 4x4 forks are forbidden, not wins
    win3 = torch.where(torch.as_tensor(is_cross_actor, device=pts.device), any_o4 & empty, win3)
    return dict(five=five, four=four & ~certain, win3=win3, three=three & ~maybe, n3=n3,
                certain_forb=certain, maybe_forb=maybe)


def pts_at_cell(pts: torch.Tensor, move_b: torch.Tensor) -> torch.Tensor:
    """PatternTypes of one flat cell per board: [B,H,W,4] + [B] -> [B,4]
    (zeros where the cell is outside the board)."""
    bsz, h, w, _ = pts.shape
    move = move_b.long()
    ok = (move >= 0) & (move < h * w)
    row = pts.reshape(bsz, h * w, 4)[_rows(pts), move.clamp(0, h * w - 1)]
    return torch.where(ok[:, None], row, 0)
