"""Defensive-move tables: the complete defender option sets per threat.

Port of the reference package's `patterns/defensive.py` (reference:
src/patterns/DefensiveMoveTable.cpp:15-589).  For every threat variant
(five completions, open fours, double fours) and every 8-bit side context,
a bounded line search finds the defender placements that keep the line
from being lost; open-three (and half-open-four) defences are derived from
the five / open-four tables at lookup time with positional shifts.  Every
mask is COMPLETE: a defender reply outside it loses the local line, which
is what makes refuting only the masked replies a proof in the VCT solver's
AND nodes.

`DefensiveTables` builds the three `[variants, 256, 2]` tables in numpy,
once per rule and process (`get_tables`, cached in memory, never on disk).
The line search is the reference package's; the port memoizes it per
table, which gives the same masks in a fraction of the time.
`get_moves_batched` is the tensor lookup the solver calls: the same
dispatch as the reference package's, with plain indexing into the tables
(the reference package's one-hot byte-split einsum reads are a TPU
workaround).  Masks are 13-bit values carried in int32 (torch has no
shifts on uint16).  The host half, `DefensiveTables.get_moves`,
`_extended_window` and `defensive_cells_for_threat`, is the reference
package's, for the exact host VCT (`search/vct.py`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..game.types import CROSS, CIRCLE, NONE, DIRECTION_STEPS, GameRules, invert_sign
from . import tables as T

EXT_LENGTH = 13  # extended pattern (reference: RawPattern.hpp ExtendedPattern)
CENTER = 6  # center cell of the 13-cell pattern (Pattern::length-1)/2 + 1


def _cells(encoded: int, length: int) -> tuple[int, ...]:
    return tuple((encoded >> (2 * i)) & 3 for i in range(length))


def _overline_allowed(rules: GameRules, attacker: int) -> bool:
    # (reference: DefensiveMoveTable.cpp:19-22)
    return (
        rules == GameRules.FREESTYLE
        or (rules == GameRules.RENJU and attacker == CIRCLE)
        or rules == GameRules.CARO6
    )


def _blocked_allowed(rules: GameRules, attacker: int) -> bool:
    # (reference: DefensiveMoveTable.cpp:23-26)
    return rules not in (GameRules.CARO5, GameRules.CARO6)


def _is_five(cells: tuple[int, ...], attacker: int, rules: GameRules) -> bool:
    """(reference: DefendFive::is_five — interior fives only, with the
    rule-dependent overline/blocked side conditions)"""
    defender = invert_sign(attacker)
    allow_ol = _overline_allowed(rules, attacker)
    allow_bl = _blocked_allowed(rules, attacker)
    n = len(cells)
    for i in range(1, n - 5):
        if all(cells[i + k] == attacker for k in range(5)):
            first, last = cells[i - 1], cells[i + 5]
            win_overline = True if allow_ol else (first != attacker and last != attacker)
            win_blocked = True if allow_bl else not (first == defender and last == defender)
            if win_overline and win_blocked:
                return True
    return False


class _LineSearch:
    """The reference's bounded negamax over one line for one (rules,
    attacker), memoized on (cells, sign, depth)."""

    def __init__(self, rules: GameRules, attacker: int):
        self.rules = rules
        self.attacker = attacker
        self.memo: dict = {}
        self.fives: dict = {}

    def five(self, cells) -> bool:
        if cells not in self.fives:
            self.fives[cells] = _is_five(cells, self.attacker, self.rules)
        return self.fives[cells]

    def search(self, cells: tuple[int, ...], sign: int, depth: int) -> int:
        """1 = the attacker reaches a five (reference: DefendFive::search)."""
        key = (cells, sign, depth)
        if key in self.memo:
            return self.memo[key]
        outcome = -1
        for i, c in enumerate(cells):
            if c == NONE:
                nxt = cells[:i] + (sign,) + cells[i + 1:]
                if self.five(nxt):
                    outcome = 1
                    break
                tmp = -self.search(nxt, invert_sign(sign), depth - 1) if depth > 1 else 0
                outcome = max(outcome, tmp)
        self.memo[key] = outcome
        return outcome

    def defend(self, encoded: int, length: int, offset: int, depth: int) -> int:
        """16-bit mask of successful defensive placements, positions
        relative to the extended pattern (reference: DefendFive::operator())."""
        defender = invert_sign(self.attacker)
        cells = _cells(encoded, length)
        if self.five(cells):
            return 0
        if self.search(cells, self.attacker, depth) == 0:
            return 0
        result = 0
        for i, c in enumerate(cells):
            if c == NONE:
                nxt = cells[:i] + (defender,) + cells[i + 1:]
                if self.search(nxt, self.attacker, depth) != 1:
                    pos = offset + i
                    if 0 <= pos < 16:
                        result |= 1 << pos
        return result


# threat variant definitions (reference: DefendFive/DefendOpenFour/
# DefendDoubleFour/DefendHalfOpenFour/DefendOpenThree mask constants)
_FIVE_MASKS = {CROSS: [85, 277, 325, 337, 340], CIRCLE: [170, 554, 650, 674, 680]}
_FIVE_OFFSETS = [2, 3, 4, 5, 6]
_OPEN4_MASKS = {CROSS: [84, 276, 324, 336], CIRCLE: [168, 552, 648, 672]}
_OPEN4_OFFSETS = [2, 3, 4, 5]
_D4_MASKS = {
    CROSS: [4177, 4369, 4417, 20549, 20741, 86037],
    CIRCLE: [8354, 8738, 8834, 41098, 41482, 172074],
}
_D4_LENGTHS = [7, 7, 7, 8, 8, 9]
_D4_OFFSETS = [2, 3, 4, 2, 3, 2]
_HO4_MASKS = {
    CROSS: [21, 69, 81, 84, 21, 261, 273, 276, 69, 261, 321, 324, 81, 273, 321,
            336, 84, 276, 324, 336],
    CIRCLE: [42, 138, 162, 168, 42, 522, 546, 552, 138, 522, 642, 648, 162, 546,
             642, 672, 168, 552, 648, 672],
}
_HO4_OFFSETS = [3, 4, 5, 6, 2, 4, 5, 6, 2, 3, 5, 6, 2, 3, 4, 6, 2, 3, 4, 5]
_OPEN3_MASKS = {
    CROSS: [20, 68, 80, 20, 260, 272, 68, 260, 320, 80, 272, 320],
    CIRCLE: [40, 136, 160, 40, 520, 544, 136, 520, 640, 160, 544, 640],
}
_OPEN3_OFFSETS = [3, 4, 5, 2, 4, 5, 2, 3, 5, 2, 3, 4]


class DefensiveTables:
    """(reference: DefensiveMoveTable five/open_four/double_four tables,
    each [variant, 256 contexts] -> 16-bit masks per defender sign)"""

    def __init__(self, rules: GameRules):
        self.rules = GameRules(rules)
        # tables[variant][context] -> (mask_for_cross, mask_for_circle)
        self.five = self._build(_FIVE_MASKS, [5] * 5, _FIVE_OFFSETS, depth=1)
        self.open_four = self._build(_OPEN4_MASKS, [6] * 4, _OPEN4_OFFSETS, depth=3)
        self.double_four = self._build(_D4_MASKS, _D4_LENGTHS, _D4_OFFSETS, depth=3)

    def _build(self, masks, lengths, offsets, depth):
        out = np.zeros((len(offsets), 256, 2), np.uint16)
        lines = {a: _LineSearch(self.rules, a) for a in (CROSS, CIRCLE)}
        for i in range(len(offsets)):
            length = lengths[i]
            for j in range(256):
                left = j & 0x0F
                right = (j & 0xF0) << (2 * length)
                offset = offsets[i] - 2
                for col, defender in enumerate((CROSS, CIRCLE)):
                    attacker = invert_sign(defender)
                    ext = left | (masks[attacker][i] << 4) | right
                    out[i, j, col] = lines[attacker].defend(ext, length + 4, offset, depth)
        return out

    # -- lookup (reference: DefensiveMoveTable::getMoves dispatch) ---------

    def get_moves(self, pattern: int, defender: int, threat: int) -> int:
        """Defensive cells for the given 13-cell extended `pattern` (2 bits
        per cell), defender sign, and PatternType `threat`, on the host.
        Returns a 16-bit mask over the 13 pattern positions (the reference
        package's `DefensiveTables.get_moves`)."""
        attacker = invert_sign(defender)
        col = 0 if defender == CROSS else 1

        def sub(begin, length):
            return (pattern >> (2 * begin)) & ((1 << (2 * length)) - 1)

        def ctx(begin, end):
            left = (pattern >> (2 * (begin - 2))) & 15
            right = (pattern >> (2 * end)) & 15
            return left | (right << 4)

        if threat == T.PT_FIVE:
            for i, begin in enumerate(_FIVE_OFFSETS):
                if sub(begin, 5) == _FIVE_MASKS[attacker][i]:
                    return int(self.five[i, ctx(begin, begin + 5), col])
            return 0
        if threat == T.PT_OPEN_4:
            for i, begin in enumerate(_OPEN4_OFFSETS):
                if sub(begin, 6) == _OPEN4_MASKS[attacker][i]:
                    return int(self.open_four[i, ctx(begin, begin + 6), col])
            return 0
        if threat == T.PT_DOUBLE_4:
            for i, begin in enumerate(_D4_OFFSETS):
                length = _D4_LENGTHS[i]
                if sub(begin, length) == _D4_MASKS[attacker][i]:
                    return int(self.double_four[i, ctx(begin, begin + length), col])
            return 0
        if threat == T.PT_HALF_OPEN_4:
            # derived from the five tables with positional shifts
            # (reference: getMoves HALF_OPEN_4 branch incl. the caro
            # multi-threat accumulation)
            allow_ol = _overline_allowed(self.rules, attacker)
            allow_bl = _blocked_allowed(self.rules, attacker)
            result = 1 << CENTER
            for i, begin in enumerate(_HO4_OFFSETS):
                if sub(begin, 5) != _HO4_MASKS[attacker][i]:
                    continue
                first = (pattern >> (2 * (begin - 1))) & 3
                last = (pattern >> (2 * (begin + 5))) & 3
                if not allow_ol and (first == attacker or last == attacker):
                    continue
                if not allow_bl and (first == defender and last == defender):
                    continue
                tmp = int(self.five[i // 4, ctx(begin, begin + 5), col])
                shift = begin - _FIVE_OFFSETS[i // 4]
                tmp = (tmp << shift) if shift >= 0 else (tmp >> -shift)
                result |= tmp & 0xFFFF
                if self.rules not in (GameRules.CARO5, GameRules.CARO6):
                    return result
            return result
        if threat == T.PT_OPEN_3:
            for i, begin in enumerate(_OPEN3_OFFSETS):
                if sub(begin, 6) == _OPEN3_MASKS[attacker][i]:
                    result = int(self.open_four[i // 3, ctx(begin, begin + 6), col])
                    shift = begin - _OPEN4_OFFSETS[i // 3]
                    result = (result << shift) if shift >= 0 else (result >> -shift)
                    result |= 1 << CENTER
                    return result & 0xFFFF
            return 0
        return 0


@functools.lru_cache(maxsize=None)
def get_tables(rules: GameRules) -> DefensiveTables:
    return DefensiveTables(GameRules(rules))


@functools.lru_cache(maxsize=None)
def _device_tables(rules: GameRules, device: torch.device):
    """(five, open_four, double_four) as int32 [variants, 256, 2] tensors."""
    tabs = get_tables(rules)
    return tuple(
        torch.from_numpy(t.astype(np.int32)).to(device)
        for t in (tabs.five, tabs.open_four, tabs.double_four)
    )


# the table-read threats: PatternType -> (masks, offsets, lengths, variant of
# each entry, offsets the table was built at (None: no shift))
_DISPATCH = {
    T.PT_FIVE: (_FIVE_MASKS, _FIVE_OFFSETS, [5] * 5, list(range(5)), None),
    T.PT_OPEN_4: (_OPEN4_MASKS, _OPEN4_OFFSETS, [6] * 4, list(range(4)), None),
    T.PT_DOUBLE_4: (_D4_MASKS, _D4_OFFSETS, _D4_LENGTHS, list(range(6)), None),
    T.PT_OPEN_3: (_OPEN3_MASKS, _OPEN3_OFFSETS, [6] * 12, [i // 3 for i in range(12)],
                  _OPEN4_OFFSETS),
}


@functools.lru_cache(maxsize=None)
def _dispatch_constants(threat: int, device: torch.device):
    """int64 [entries] tensors of one threat's dispatch: the attacker masks
    (cross, circle), begin offsets, lengths, variants, and the shift from
    the offset the variant's table was built at."""
    masks, offsets, lengths, variants, base = _DISPATCH[threat]
    shift = [b - base[v] for b, v in zip(offsets, variants)] if base else [0] * len(offsets)
    rows = (masks[CROSS], masks[CIRCLE], offsets, lengths, variants, shift)
    return tuple(torch.tensor(r, dtype=torch.int64, device=device) for r in rows)


def get_moves_batched(
    rules: GameRules, patterns: torch.Tensor, defender_is_circle: torch.Tensor, threat: int
) -> torch.Tensor:
    """Defensive lookup on tensors: 26-bit extended patterns [...] (2 bits
    per cell over 13 cells, int64) + defender sign mask [...] -> 16-bit
    defence masks [...] int32 (reference package: `get_moves_batched`;
    `threat` is a PatternType code).

    Five, open-four, double-four and open-three threats take the first
    matching entry of the reference's dispatch order, all entries compared
    at once; half-open fours accumulate over their entries (caro) in a
    loop, as the reference does."""
    rules = GameRules(rules)
    five, open_four, double_four = _device_tables(rules, patterns.device)
    patterns = patterns.long()
    is_circle = defender_is_circle.to(torch.bool)
    col = is_circle.long()

    def ctx_of(begin, end):
        return ((patterns >> (2 * (begin - 2))) & 15) | (((patterns >> (2 * end)) & 15) << 4)

    if threat in _DISPATCH:
        table = {T.PT_FIVE: five, T.PT_DOUBLE_4: double_four}.get(threat, open_four)
        m_cross, m_circle, begin, length, variant, shift = _dispatch_constants(
            threat, patterns.device)
        # the attacker is cross where the defender is circle
        attacker_mask = torch.where(is_circle[..., None], m_cross, m_circle)
        window = (patterns[..., None] >> (2 * begin)) & ((1 << (2 * length)) - 1)
        hit = window == attacker_mask  # [..., entries]
        first = torch.argmax(hit.int(), -1)
        b, ln, sh = begin[first], length[first], shift[first]
        val = table[variant[first], ctx_of(b, b + ln), col].long()
        val = torch.where(sh >= 0, val << sh.clamp(min=0), val >> (-sh).clamp(min=0)) & 0xFFFF
        if threat == T.PT_OPEN_3:
            val = val | (1 << CENTER)
        return torch.where(hit.any(-1), val, 0).to(torch.int32)
    if threat != T.PT_HALF_OPEN_4:
        return torch.zeros(patterns.shape, dtype=torch.int32, device=patterns.device)

    # half-open fours: derived from the five tables with positional shifts
    attacker = torch.where(is_circle, CROSS, CIRCLE)
    defender = torch.where(is_circle, CIRCLE, CROSS)
    allow_ol = torch.where(
        is_circle, _overline_allowed(rules, CROSS), _overline_allowed(rules, CIRCLE)
    )
    allow_bl = _blocked_allowed(rules, CROSS)  # sign-independent
    open_rules = rules in (GameRules.CARO5, GameRules.CARO6)
    acc = torch.full(patterns.shape, 1 << CENTER, dtype=torch.int64, device=patterns.device)
    decided = torch.zeros(patterns.shape, dtype=torch.bool, device=patterns.device)
    for i, begin in enumerate(_HO4_OFFSETS):
        first = (patterns >> (2 * (begin - 1))) & 3
        last = (patterns >> (2 * (begin + 5))) & 3
        side_ok = allow_ol | ((first != attacker) & (last != attacker))
        if not allow_bl:
            side_ok = side_ok & ~((first == defender) & (last == defender))
        am = torch.where(is_circle, _HO4_MASKS[CROSS][i], _HO4_MASKS[CIRCLE][i])
        hit = (((patterns >> (2 * begin)) & 1023) == am) & side_ok & ~decided
        val = five[i // 4][ctx_of(begin, begin + 5), col].long()
        shift = begin - _FIVE_OFFSETS[i // 4]
        val = (val << shift) if shift >= 0 else (val >> -shift)
        acc = torch.where(hit, acc | (val & 0xFFFF), acc)
        if not open_rules:
            decided = decided | hit
    return acc.to(torch.int32)


# ---------------------------------------------------------------------------
# Board-level lookup on the host (the defender option sets of the exact
# VCT, search/vct.py)
# ---------------------------------------------------------------------------


def _extended_window(board: np.ndarray, row: int, col: int, d: int) -> int:
    """13-cell extended pattern along direction `d` centered on (row, col),
    encoded 2 bits/cell with off-board cells ILLEGAL (3)
    (reference: RawPatternCalculator extended window extraction)."""
    h, w = board.shape
    dr, dc = DIRECTION_STEPS[d]
    out = 0
    for i in range(-CENTER, EXT_LENGTH - CENTER):
        r, c = row + i * dr, col + i * dc
        cell = 3 if not (0 <= r < h and 0 <= c < w) else int(board[r, c])
        out |= cell << (2 * (i + CENTER))
    return out


def defensive_cells_for_threat(
    board: np.ndarray,
    row: int,
    col: int,
    defender: int,
    threat: int,
    rules: GameRules,
) -> list[tuple[int, int]]:
    """Board cells that defend against the attacker threat the cell
    (row, col) represents (the attacker's potential move there), unioned
    over the directions in which the threat exists.

    This is the complete defender option set for VCT AND-nodes
    (reference: MoveGenerator querying DefensiveMoveTable per opponent
    threat cell)."""
    tabs = get_tables(rules)
    h, w = board.shape
    out: set[tuple[int, int]] = set()
    for d, (dr, dc) in enumerate(DIRECTION_STEPS):
        pattern = _extended_window(board, row, col, d)
        mask = tabs.get_moves(pattern, defender, threat)
        for i in range(EXT_LENGTH):
            if (mask >> i) & 1:
                r = row + (i - CENTER) * dr
                c = col + (i - CENTER) * dc
                if 0 <= r < h and 0 <= c < w and board[r, c] == NONE:
                    out.add((r, c))
    return sorted(out)
