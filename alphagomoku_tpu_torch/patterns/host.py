"""Host-side (numpy) position analysis: per-cell pattern/threat types.

This is the exact, single-position counterpart of the batched feature
encoder (patterns/features.py) — the same pattern/threat tables read with
plain numpy indexing.  It backs the exact solvers (search/move_generator.py,
search/vct.py) and the golden-fixture replays, mirroring the role of the
reference's PatternCalculator (reference:
src/patterns/PatternCalculator.cpp:279+ incremental state; here a stateless
recompute, which is fine at host call rates).

A numpy copy of the reference package's `patterns/host.py` over the
port's `patterns/tables.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..game.types import CROSS, CIRCLE, NONE, GameRules, DIRECTION_STEPS
from . import tables as T

PAD = 5  # normal pattern radius (11-cell window)


def window_keys(board: np.ndarray) -> np.ndarray:
    """20-bit center-free window keys for every cell/direction [4, H, W]
    (numpy mirror of game.vectorized.windows_all + tables.narrow_down)."""
    h, w = board.shape
    p = np.full((h + 2 * PAD, w + 2 * PAD), 3, np.uint32)
    p[PAD : PAD + h, PAD : PAD + w] = board
    out = np.zeros((4, h, w), np.uint32)
    for d, (dr, dc) in enumerate(DIRECTION_STEPS):
        acc = np.zeros((h, w), np.uint32)
        for i in range(-PAD, PAD + 1):
            if i == 0:
                continue
            sl = p[PAD + i * dr : PAD + i * dr + h, PAD + i * dc : PAD + i * dc + w]
            acc |= sl << np.uint32(2 * (i + PAD))
        out[d] = acc
    return (out & np.uint32(1023)) | ((out & np.uint32(4190208)) >> np.uint32(2))


class HostAnalysis(NamedTuple):
    """Pattern/threat classification of one position.

    pt[sign][d, r, c]: PatternType the empty cell (r, c) would form for
    `sign` along direction d (garbage on occupied cells — mask with `empty`).
    tt[sign][r, c]: combined ThreatType (reference: ThreatTable::getThreat).
    """

    pt: dict
    tt: dict
    empty: np.ndarray  # [H, W] bool


def analyze(board: np.ndarray, rules: GameRules) -> HostAnalysis:
    pattern_table = T.get_pattern_table(rules)
    threat_table = T.get_threat_table(rules)
    enc = pattern_table[window_keys(board)]  # [4, H, W] nibble-packed
    empty = board == NONE
    pt, tt = {}, {}
    for sign, shift in ((CROSS, 0), (CIRCLE, 4)):
        p = ((enc >> shift) & 15).astype(np.uint32)  # [4, H, W]
        idx = p[0] | (p[1] << 3) | (p[2] << 6) | (p[3] << 9)
        t = threat_table[idx]
        pt[sign] = p.astype(np.uint8)
        tt[sign] = ((t if sign == CROSS else (t >> 4)) & 15).astype(np.uint8)
        tt[sign][~empty] = T.TT_NONE
    return HostAnalysis(pt=pt, tt=tt, empty=empty)
