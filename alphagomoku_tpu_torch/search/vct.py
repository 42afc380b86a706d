"""Host-side VCT solver: victory by continuous threats (fours AND open
threes), exact recursive AND-OR search for single positions.

Counterpart of the reference's threat-space search / VCT layer
(reference: src/search/alpha_beta/{ThreatSpaceSearch,ThreatGenerator}.cpp):
the attacker plays only forcing moves (four-makers, and open-three-makers
when unchecked); the defender's complete option set comes from the
defensive-move tables (patterns/defensive.py) plus counter-fours, so every
claimed WIN is a proof.  This is the engine-side ("exact host") variant,
mirroring how game/rules.py complements the batched env; the lockstep
batched VCT is `search/vct_batched.py`.  A copy of the reference package's
`search/vct.py` (numpy; `Engine.search` runs it before the tree search).

Soundness invariants:
- attack nodes (OR): a win needs ONE winning attacker move;
- defense nodes (AND): a win needs EVERY defender option refuted, and the
  option set is a superset of all non-losing replies (defensive table
  completeness + counter-fours; quiet replies lose to the forced
  four -> five continuation);
- option sets that exceed the cap abandon the line (never unsound).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..game.types import CROSS, CIRCLE, NONE, GameRules, Move, invert_sign
from ..game.rules import is_forbidden
from ..patterns import defensive as DEF
from ..patterns import tables as T


class VCTResult(NamedTuple):
    win: bool
    best_move: tuple[int, int] | None
    nodes: int


def _window_keys(board: np.ndarray) -> np.ndarray:
    """20-bit center-free window keys for every cell/direction [4, H, W]
    (numpy mirror of game.vectorized.windows_all + narrow_down)."""
    h, w = board.shape
    pad = 5
    p = np.full((h + 2 * pad, w + 2 * pad), 3, np.uint32)
    p[pad : pad + h, pad : pad + w] = board
    steps = ((0, 1), (1, 0), (1, 1), (1, -1))
    out = np.zeros((4, h, w), np.uint32)
    for d, (dr, dc) in enumerate(steps):
        acc = np.zeros((h, w), np.uint32)
        for i in range(-pad, pad + 1):
            if i == 0:
                continue
            sl = p[
                pad + i * dr : pad + i * dr + h, pad + i * dc : pad + i * dc + w
            ]
            acc |= sl << np.uint32(2 * (i + pad))
        out[d] = acc
    return (out & np.uint32(1023)) | ((out & np.uint32(4190208)) >> np.uint32(2))


class _Analyzer:
    """Per-position threat planes from the pattern tables (host numpy)."""

    def __init__(self, rules: GameRules):
        self.rules = GameRules(rules)
        self.pattern_table, _ = T.get_tables(rules)

    def planes(self, board: np.ndarray):
        keys = _window_keys(board)
        enc = self.pattern_table[keys]  # [4, H, W] nibble-packed
        empty = board == NONE
        out = {}
        for sign, shift in ((CROSS, 0), (CIRCLE, 4)):
            pt = (enc >> shift) & 15  # [4, H, W]
            five = (pt == T.PT_FIVE).any(0) & empty
            four = (
                (pt == T.PT_HALF_OPEN_4)
                | (pt == T.PT_OPEN_4)
                | (pt == T.PT_DOUBLE_4)
            ).any(0) & empty
            win3 = (
                ((pt == T.PT_OPEN_4) | (pt == T.PT_DOUBLE_4)).any(0)
                | (((pt == T.PT_HALF_OPEN_4) | (pt == T.PT_OPEN_4)).sum(0) >= 2)
            ) & empty
            three = (pt == T.PT_OPEN_3).any(0) & empty
            n_three = (pt == T.PT_OPEN_3).sum(0)
            out[sign] = {
                "five": five,
                "four": four,
                "win3": win3,
                "three": three,
                "n_three": n_three,
                "pt": pt,
            }
        return out


def solve(
    board: np.ndarray,
    sign_to_move: int,
    rules: GameRules,
    max_depth: int = 8,
    node_budget: int = 30000,
    max_defenses: int = 12,
    max_threes: int = 2,
) -> VCTResult:
    """Prove (or fail to prove) a forced win for `sign_to_move`."""
    rules = GameRules(rules)
    board = board.copy()
    attacker = sign_to_move
    defender = invert_sign(attacker)
    ana = _Analyzer(rules)
    state = {"nodes": 0}
    renju_black = rules == GameRules.RENJU

    def forbidden(b, r, c, sign) -> bool:
        return (
            renju_black
            and sign == CROSS
            and is_forbidden(b, Move(row=int(r), col=int(c), sign=CROSS))
        )

    def legal_cells(plane, b, sign):
        cells = list(zip(*np.nonzero(plane)))
        if renju_black and sign == CROSS:
            cells = [rc for rc in cells if not forbidden(b, rc[0], rc[1], CROSS)]
        return cells

    def _candidates(b, mine, opp5, threes_left):
        """Ordered forcing moves: immediate open-four makers first, then
        multi-direction threes (fork potential), then plain fours/threes
        (reference: staged generation order, ThreatGenerator.hpp:78-88)."""
        win3 = legal_cells(mine["win3"], b, attacker)
        if opp5:
            fours = [
                m for m in legal_cells(mine["four"], b, attacker) if m in opp5
            ]
            return fours
        fours = legal_cells(mine["four"] & ~mine["win3"], b, attacker)
        threes = []
        if threes_left > 0:
            threes = legal_cells(mine["three"] & ~mine["four"], b, attacker)
            threes.sort(key=lambda rc: -int(mine["n_three"][rc[0], rc[1]]))
        return win3 + fours + threes

    def attack(b: np.ndarray, depth: int, threes_left: int) -> bool:
        state["nodes"] += 1
        if state["nodes"] > node_budget or depth <= 0:
            return False
        planes = ana.planes(b)
        mine, theirs = planes[attacker], planes[defender]

        if legal_cells(mine["five"], b, attacker):
            return True  # win in 1

        opp5 = legal_cells(theirs["five"], b, defender)
        if len(opp5) >= 2:
            return False  # cannot block two five threats

        for r, c in _candidates(b, mine, opp5, threes_left):
            is_three = not mine["four"][r, c]
            b[r, c] = attacker
            won = _after_attack(
                b, r, c, depth, threes_left - (1 if is_three else 0)
            )
            b[r, c] = NONE
            if won:
                return True
        return False

    def _after_attack(b, r, c, depth, threes_left) -> bool:
        planes = ana.planes(b)
        mine, theirs = planes[attacker], planes[defender]
        my5 = legal_cells(mine["five"], b, attacker)

        if len(my5) >= 2:
            return True  # double four: unstoppable
        if len(my5) == 1:
            # forced block (counter-fours cannot outrace a five threat)
            br, bc = my5[0]
            if forbidden(b, br, bc, defender):
                return True
            b[br, bc] = defender
            won = attack(b, depth - 1, threes_left)
            b[br, bc] = NONE
            return won

        # open-three move: complete defender option set = table defenses
        # (queried on the pre-move pattern at (r, c)) + counter-fours
        b[r, c] = NONE
        defs = set(
            DEF.defensive_cells_for_threat(b, r, c, defender, T.PT_OPEN_3, rules)
        )
        b[r, c] = attacker
        defs |= set(legal_cells(theirs["four"] | theirs["five"], b, defender))
        defs.discard((r, c))
        defs = [
            rc for rc in defs
            if b[rc[0], rc[1]] == NONE and not forbidden(b, rc[0], rc[1], defender)
        ]
        if not defs:
            return True  # no legal defense
        if len(defs) > max_defenses:
            return False  # too wide to verify: abandon (sound)
        for dr_, dc_ in defs:
            b[dr_, dc_] = defender
            refuted = attack(b, depth - 1, threes_left)
            b[dr_, dc_] = NONE
            if not refuted:
                return False
        return True

    # root: report the winning move as well
    planes = ana.planes(board)
    mine, theirs = planes[attacker], planes[defender]
    my5 = legal_cells(mine["five"], board, attacker)
    if my5:
        return VCTResult(True, my5[0], state["nodes"])
    opp5 = legal_cells(theirs["five"], board, defender)
    if len(opp5) >= 2:
        return VCTResult(False, None, state["nodes"])
    for r, c in _candidates(board, mine, opp5, max_threes):
        is_three = not mine["four"][r, c]
        board[r, c] = attacker
        won = _after_attack(
            board, r, c, max_depth, max_threes - (1 if is_three else 0)
        )
        board[r, c] = NONE
        if won:
            return VCTResult(True, (int(r), int(c)), state["nodes"])
    return VCTResult(False, None, state["nodes"])
