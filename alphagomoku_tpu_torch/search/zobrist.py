"""Zobrist position hashing (reference: include/alphagomoku/search/
ZobristHashing.hpp:101-127, src/search/ZobristHashing.cpp).

Port of the reference package's `search/zobrist.py`.  Two flavors, as in
the reference:
- full_hash: 64-bit hash of (board, side to move) that keys the search's
  transposition probe (reference: FullZobristHashing, used by NodeCache).
- incremental 128-bit hash with O(1) per-move XOR updates (reference:
  FastZobristHashing + SharedHashTable).

The keys come from the same numpy generator and seed, so hashes are equal
to the reference package's.  A wide hash is independent uint32 lanes (XOR
mixes no bits across lanes), carried here in int64: full hashes
`[..., 2]`, incremental hashes `[..., 4]`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..game.types import CROSS, CIRCLE

FULL_LANES = 2  # 64-bit
INCR_LANES = 4  # 128-bit


class ZobristTable(NamedTuple):
    cell_keys: np.ndarray  # [H*W, 2, FULL_LANES] uint32 per (cell, sign-1)
    stm_keys: np.ndarray  # [2, FULL_LANES] uint32 side-to-move keys
    cell_keys_incr: np.ndarray  # [H*W, 2, INCR_LANES] uint32


@functools.lru_cache(maxsize=None)
def make_table(rows: int, cols: int, seed: int = 0x5EED) -> ZobristTable:
    """The reference package's keys for a rows x cols board: the same
    generator, seed and draw order."""
    rng = np.random.default_rng(seed + rows * 1000 + cols)
    n = rows * cols

    def keys(shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    return ZobristTable(
        cell_keys=keys((n, 2, FULL_LANES)),
        stm_keys=keys((2, FULL_LANES)),
        cell_keys_incr=keys((n, 2, INCR_LANES)),
    )


@functools.lru_cache(maxsize=None)
def _device_keys(rows: int, cols: int, device: torch.device):
    """(cell_keys [HW, 2, 2], stm_keys [2, 2], cell_keys_incr [HW, 2, 4])
    int64 on `device`, built once so the search step makes no host-to-device
    copies."""
    t = make_table(rows, cols)
    return tuple(torch.from_numpy(k.astype(np.int64)).to(device) for k in t)


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR over `dim` by pairwise folding (torch has no XOR reduction)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    while n > 1:
        half = n // 2
        folded = x[:half] ^ x[half : 2 * half]
        x = torch.cat([folded, x[2 * half :]]) if n % 2 else folded
        n = x.shape[0]
    return x[0]


def full_hash(board: torch.Tensor, stm: torch.Tensor) -> torch.Tensor:
    """64-bit position hash [B, 2] int64 (two u32 lanes) from int8 boards
    [B, H, W] + side to move [B] (reference: FullZobristHashing::getHash)."""
    bsz, h, w = board.shape
    cell_keys, stm_keys, _ = _device_keys(h, w, board.device)
    hsh = _xor_reduce_cells(board.reshape(bsz, -1), cell_keys)
    return hsh ^ torch.where((stm == CROSS)[:, None], stm_keys[0], stm_keys[1])


def _xor_reduce_cells(flat: torch.Tensor, keyset: torch.Tensor) -> torch.Tensor:
    """XOR the keys of all placed stones: [B, HW] board + [HW, 2, L] keys ->
    [B, L]."""
    flat = flat[..., None]
    kx = torch.where(flat == CROSS, keyset[None, :, 0, :], 0)
    ko = torch.where(flat == CIRCLE, keyset[None, :, 1, :], 0)
    return _xor_reduce(kx ^ ko, 1)


def incremental_hash(board: torch.Tensor) -> torch.Tensor:
    """128-bit board hash [B, 4] int64 (four u32 lanes) from int8 boards
    [B, H, W] (reference: FastZobristHashing::getHash)."""
    bsz, h, w = board.shape
    return _xor_reduce_cells(board.reshape(bsz, -1), _device_keys(h, w, board.device)[2])


def update_hash(h: torch.Tensor, action: torch.Tensor, sign: torch.Tensor,
                rows: int, cols: int) -> torch.Tensor:
    """O(1) per-move update of the 128-bit hash [B, 4] of a rows x cols
    board: flat `action` [B], `sign` [B] in {CROSS, CIRCLE} (reference:
    FastZobristHashing::updateHash; XOR is its own inverse, so the same
    call undoes a move).  Actions outside the board are clipped to it, as
    the reference package clips them."""
    keys = _device_keys(rows, cols, h.device)[2]
    idx = action.long().clamp(0, keys.shape[0] - 1)
    col = torch.where(sign == CROSS, 0, 1)
    return h ^ keys[idx, col]
