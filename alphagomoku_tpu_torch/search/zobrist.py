"""Zobrist position hashing (reference: include/alphagomoku/search/
ZobristHashing.hpp:101-127, src/search/ZobristHashing.cpp).

Port of the reference package's `search/zobrist.py`, the full 64-bit hash
of (board, side to move) that keys the search's transposition probe.  The
keys come from the same numpy generator and seed, so hashes are equal to
the reference package's.  A 64-bit hash is two independent uint32 lanes
(XOR mixes no bits across lanes), carried here in int64 as `[..., 2]`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..game.types import CROSS, CIRCLE

FULL_LANES = 2  # 64-bit


class ZobristTable(NamedTuple):
    cell_keys: np.ndarray  # [H*W, 2, FULL_LANES] uint32 per (cell, sign-1)
    stm_keys: np.ndarray  # [2, FULL_LANES] uint32 side-to-move keys


@functools.lru_cache(maxsize=None)
def make_table(rows: int, cols: int, seed: int = 0x5EED) -> ZobristTable:
    """The reference package's keys for a rows x cols board: the same
    generator, seed and draw order (its 128-bit incremental keys, drawn
    after these, are left out)."""
    rng = np.random.default_rng(seed + rows * 1000 + cols)
    n = rows * cols

    def keys(shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    return ZobristTable(
        cell_keys=keys((n, 2, FULL_LANES)),
        stm_keys=keys((2, FULL_LANES)),
    )


@functools.lru_cache(maxsize=None)
def _device_keys(rows: int, cols: int, device: torch.device):
    """(cell_keys [HW, 2, 2], stm_keys [2, 2]) int64 on `device`, built once
    so the search step makes no host-to-device copies."""
    t = make_table(rows, cols)
    return (
        torch.from_numpy(t.cell_keys.astype(np.int64)).to(device),
        torch.from_numpy(t.stm_keys.astype(np.int64)).to(device),
    )


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
    cell_keys, stm_keys = _device_keys(h, w, board.device)
    flat = board.reshape(bsz, -1, 1)
    kx = torch.where(flat == CROSS, cell_keys[None, :, 0, :], 0)
    ko = torch.where(flat == CIRCLE, cell_keys[None, :, 1, :], 0)
    hsh = _xor_reduce(kx ^ ko, 1)
    return hsh ^ torch.where((stm == CROSS)[:, None], stm_keys[0], stm_keys[1])
