"""Staged tactical move generation, exact host implementation.

This is the single-position counterpart of the reference's MoveGenerator
(reference: src/search/alpha_beta/MoveGenerator.cpp:159-231 `generate` and
the stage functions :310-1010): a cascade of sound tactical stages —
win_in_1, draw_in_1, defend_loss_in_2, win_in_3, defend_loss_in_4,
win_in_5, defend_loss_in_6 — over the threat classification of the
position, falling back to neighborhood/legal fill for quiet positions.
The golden suite from the reference's test_move_generator.cpp replays
against this module (tests/test_move_generator.py); it also supplies the
engine-side move ordering and the defender option sets used by the exact
VCT (search/vct.py).

The batched lockstep equivalents of the sound stages live in
search/static_solver.py (win_in_1/loss_in_2/win_in_3) and search/vct_batched
(deeper lines); this host module is the reference point they are tested
against.

Scores are the packed 16-bit values of search/score.py, handled as plain
Python ints here (host code; the packing is ordered so max() works).

A numpy copy of the reference package's `search/move_generator.py` over
the port's host `game/rules.py`, `patterns/defensive.py`,
`patterns/host.py` and `patterns/tables.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..game.types import (
    CROSS, CIRCLE, NONE, DIRECTION_STEPS, GameRules, Move, invert_sign,
)

DIRS = DIRECTION_STEPS
from ..game.rules import is_forbidden as _board_is_forbidden
from ..patterns import defensive as DEF
from ..patterns import host as H
from ..patterns import tables as T

# host-int score packing (reference: Score.hpp:47-68; see search/score.py)
_PV_LOSS, _PV_DRAW, _PV_UNKNOWN, _PV_WIN = 0, 1, 2, 3


def score(ev: int = 0, pv: int = _PV_UNKNOWN) -> int:
    return (pv << 13) | (4000 + ev)


def win_in(plys: int) -> int:
    return score(-plys, _PV_WIN)


def loss_in(plys: int) -> int:
    return score(plys, _PV_LOSS)


def draw_in(plys: int) -> int:
    return score(plys, _PV_DRAW)


UNKNOWN = score()
MIN_VALUE = 0  # Score::min_value() packs below every real score


def is_win(s: int) -> bool:
    return (s >> 13) == _PV_WIN and s != 0xFFFF


def is_proven(s: int) -> bool:
    return (s >> 13) != _PV_UNKNOWN and s not in (0, 0xFFFF)


# generation modes (reference: MoveGeneratorMode, MoveGenerator.hpp:29-36)
BASIC, THREATS, OPTIMAL, REDUCED, LEGAL = range(5)
_MODES = {"basic": BASIC, "threats": THREATS, "optimal": OPTIMAL,
          "reduced": REDUCED, "legal": LEGAL}


@dataclass
class ActionList:
    """Generated moves + position flags (reference: ActionList.hpp)."""

    moves: dict = field(default_factory=dict)  # (row, col) -> packed score
    must_defend: bool = False
    has_initiative: bool = False
    is_fully_expanded: bool = False
    baseline_score: int = UNKNOWN

    def __len__(self) -> int:
        return len(self.moves)

    def contains(self, rc) -> bool:
        return tuple(rc) in self.moves

    def score_of(self, rc) -> int:
        return self.moves[tuple(rc)]

    def locations(self) -> list:
        return sorted(self.moves)


class _Generator:
    def __init__(self, board: np.ndarray, stm: int, rules: GameRules,
                 draw_after: int | None):
        self.board = board
        self.h, self.w = board.shape
        self.stm = int(stm)
        self.opp = invert_sign(self.stm)
        self.rules = GameRules(rules)
        self.draw_after = self.h * self.w if draw_after is None else draw_after
        self.depth = int((board != NONE).sum())
        self.ana = H.analyze(board, rules)
        self.def_tables = DEF.get_tables(rules)
        self.actions = ActionList()
        self._forbidden_cache: dict = {}

    # -- small queries ------------------------------------------------------

    def threats_of(self, sign: int, tt: int) -> list:
        return [tuple(rc) for rc in np.argwhere(self.ana.tt[sign] == tt)]

    def own_threats(self, tt: int) -> list:
        return self.threats_of(self.stm, tt)

    def opp_threats(self, tt: int) -> list:
        return self.threats_of(self.opp, tt)

    def anything_forbidden_for(self, sign: int) -> bool:
        return self.rules == GameRules.RENJU and sign == CROSS

    def is_forbidden(self, sign: int, rc) -> bool:
        if not self.anything_forbidden_for(sign):
            return False
        rc = tuple(rc)
        if rc not in self._forbidden_cache:
            self._forbidden_cache[rc] = _board_is_forbidden(
                self.board, Move(row=rc[0], col=rc[1], sign=CROSS)
            )
        return self._forbidden_cache[rc]

    def n_available_fours(self, sign: int) -> int:
        """(reference: MoveGenerator::number_of_available_fours_for)"""
        tt = self.ana.tt[sign]
        n = int(((tt == T.TT_OPEN_4) | (tt == T.TT_FORK_4x3)
                 | (tt == T.TT_HALF_OPEN_4)).sum())
        if not self.anything_forbidden_for(sign):
            n += int((tt == T.TT_FORK_4x4).sum())
        return n

    def is_half_open_three_at(self, rc, d: int, sign: int) -> bool:
        return self.ana.pt[sign][d, rc[0], rc[1]] == T.PT_HALF_OPEN_3

    # -- adding moves --------------------------------------------------------

    def add(self, rc, s: int = UNKNOWN, override: bool = False) -> None:
        rc = tuple(int(x) for x in rc)
        if rc in self.actions.moves:
            if override:
                self.actions.moves[rc] = s
        else:
            self.actions.moves[rc] = s

    def add_all(self, rcs, s: int = UNKNOWN, override: bool = False) -> None:
        for rc in rcs:
            self.add(rc, s, override)

    # -- defensive moves -----------------------------------------------------

    def raw_defensive_moves(self, defender: int, rc, d: int) -> list:
        """Table lookup without forbidden filtering (reference:
        PatternCalculator::getDefensiveMoves, PatternCalculator.hpp:162-172)."""
        ext = DEF._extended_window(self.board, rc[0], rc[1], d)
        threat = int(self.ana.pt[invert_sign(defender)][d, rc[0], rc[1]])
        mask = self.def_tables.get_moves(ext, defender, threat)
        dr, dc = DIRS[d]
        out = []
        for i in range(DEF.EXT_LENGTH):
            if (mask >> i) & 1:
                out.append((rc[0] + (i - DEF.CENTER) * dr,
                            rc[1] + (i - DEF.CENTER) * dc))
        return out

    def get_defensive_moves(self, rc, d: int) -> list:
        """Own-side defensive moves vs the opponent threat at `rc` along `d`,
        with the renju special cases (reference: MoveGenerator::
        get_defensive_moves, MoveGenerator.cpp:262-305)."""
        result = self.raw_defensive_moves(self.stm, rc, d)
        if self.anything_forbidden_for(self.stm):
            kept = []
            for m in result:
                if self.is_forbidden(self.stm, m):
                    # forbidden defense: record as an immediate loss instead
                    self.add(m, loss_in(1), override=True)
                else:
                    kept.append(m)
            return kept
        if self.anything_forbidden_for(self.opp):
            # defending (as white) a black open four whose straight-four end
            # is forbidden adds one more defensive spot
            # (reference: MoveGenerator.cpp:280-300)
            if self.ana.pt[self.opp][d, rc[0], rc[1]] == T.PT_OPEN_4:
                raw = self._normal_window(rc, d)
                kind = 0
                if (raw & 65520) == 1344:
                    kind = -1  # '_XXX!_'
                elif (raw & 4193280) == 344064:
                    kind = +1  # '_!XXX_'
                if kind != 0:
                    dr, dc = DIRS[d]
                    far = (rc[0] + 4 * kind * dr, rc[1] + 4 * kind * dc)
                    if self._in_bounds(far) and self.is_forbidden(self.opp, far):
                        result.append((rc[0] - kind * dr, rc[1] - kind * dc))
        return result

    def _normal_window(self, rc, d: int) -> int:
        """11-cell window (2 bits/cell, center included) along direction d
        matching the reference's extended-pattern literal comparisons."""
        dr, dc = DIRS[d]
        out = 0
        for i in range(-5, 6):
            r, c = rc[0] + i * dr, rc[1] + i * dc
            cell = 3 if not self._in_bounds((r, c)) else int(self.board[r, c])
            out |= cell << (2 * (i + 5))
        return out

    def _in_bounds(self, rc) -> bool:
        return 0 <= rc[0] < self.h and 0 <= rc[1] < self.w

    # -- stages (reference: MoveGenerator.cpp:310-1010) ----------------------

    def try_win_in_1(self):
        own_fives = self.own_threats(T.TT_FIVE)
        if own_fives:
            self.actions.has_initiative = True
            self.add_all(own_fives, win_in(1))
            return win_in(1)
        return None

    def try_draw_in_1(self):
        self.actions.baseline_score = draw_in(1)
        if self.anything_forbidden_for(self.stm):
            found = False
            for rc in map(tuple, np.argwhere(self.ana.empty)):
                tt = self.ana.tt[self.stm][rc]
                if tt in (T.TT_FORK_4x4, T.TT_OVERLINE):
                    self.add(rc, loss_in(1))
                elif tt == T.TT_FORK_3x3:
                    if self.is_forbidden(self.stm, rc):
                        self.add(rc, loss_in(1))
                    else:
                        self.add(rc, draw_in(1))
                        found = True
                else:
                    self.add(rc, draw_in(1))
                    found = True
            return draw_in(1) if found else loss_in(1)
        self.create_remaining_moves(self.ana.empty, draw_in(1))
        return draw_in(1)

    def defend_loss_in_2(self):
        opp_fives = self.opp_threats(T.TT_FIVE)
        if not opp_fives:
            return None
        self.actions.must_defend = True
        self.actions.baseline_score = loss_in(2)

        defensive: set | None = None  # None = universal
        for rc in opp_fives:
            d = int(np.argmax(self.ana.pt[self.opp][:, rc[0], rc[1]] == T.PT_FIVE))
            tmp = set(self.get_defensive_moves(rc, d))
            defensive = tmp if defensive is None else (defensive & tmp)
            if not defensive:
                # irrefutable: still produce moves (reference behavior)
                self.add_all(opp_fives, loss_in(2))
                return loss_in(2)

        best = MIN_VALUE
        for m in sorted(defensive or ()):
            response = UNKNOWN
            tt = self.ana.tt[self.stm][m]
            group = self.ana.pt[self.stm][:, m[0], m[1]]
            if tt == T.TT_FORK_3x3:
                if self.anything_forbidden_for(self.stm):
                    if (group == T.PT_OPEN_4).any():
                        response = win_in(3)  # open four inside a legal fork
                elif self.n_available_fours(self.opp) == 0:
                    response = win_in(5)
            elif tt == T.TT_FORK_4x3:
                solution = self.try_solve_own_fork_4x3(m)
                response = solution if is_proven(solution) else score(15)
            elif tt in (T.TT_FORK_4x4, T.TT_OPEN_4):
                response = win_in(3)
            elif (group == T.PT_HALF_OPEN_4).any():
                self.actions.has_initiative = True
                response = score(14)
            if is_win(response):
                self.actions.has_initiative = True
            self.add(m, response)
            best = max(best, response)
        return best

    def try_win_in_3(self):
        count = 0
        if self.anything_forbidden_for(self.stm):
            # open four hidden inside a LEGAL 3x3 fork (renju black)
            for rc in self.own_threats(T.TT_FORK_3x3):
                group = self.ana.pt[self.stm][:, rc[0], rc[1]]
                if (group == T.PT_OPEN_4).any() and not self.is_forbidden(self.stm, rc):
                    count += 1
                    self.add(rc, win_in(3))

        own_open4 = self.own_threats(T.TT_OPEN_4)
        self.add_all(own_open4, win_in(3))
        count += len(own_open4)

        own_44 = self.own_threats(T.TT_FORK_4x4)
        if own_44 and not self.anything_forbidden_for(self.stm):
            count += len(own_44)
            self.add_all(own_44, win_in(3))

        if self.anything_forbidden_for(self.opp):
            # foul attack: a half-open four whose completion spot is
            # forbidden for the opponent (reference: MoveGenerator.cpp:500-548)
            for rc in self.own_threats(T.TT_HALF_OPEN_4):
                group = self.ana.pt[self.stm][:, rc[0], rc[1]]
                d = int(np.argmax(group == T.PT_HALF_OPEN_4))
                opp_tt = self.ana.tt[self.opp][rc]
                winning = False
                if opp_tt == T.TT_FORK_3x3:
                    if (self.ana.pt[self.opp][d, rc[0], rc[1]] != T.PT_OPEN_3
                            and self.is_forbidden(self.opp, rc)):
                        winning = True
                elif opp_tt in (T.TT_FORK_4x4, T.TT_OVERLINE):
                    winning = True
                if winning:
                    tmp = self.raw_defensive_moves(self.opp, rc, d)
                    others = [m for m in tmp if m != rc]
                    if others:
                        self.add(others[0], win_in(3))
                        return win_in(3)
        if count > 0:
            self.actions.has_initiative = True
            return win_in(3)
        return None

    def defend_loss_in_4(self):
        has_any_four = self.n_available_fours(self.stm) > 0
        self.actions.baseline_score = loss_in(4)

        if self.rules != GameRules.RENJU:
            defensive: set | None = None
            opp_open4 = self.opp_threats(T.TT_OPEN_4)
            for rc in opp_open4:
                self.actions.must_defend = True
                d = int(np.argmax(self.ana.pt[self.opp][:, rc[0], rc[1]] == T.PT_OPEN_4))
                tmp = set(self.get_defensive_moves(rc, d))
                defensive = tmp if defensive is None else (defensive & tmp)
                if not defensive and not has_any_four:
                    self.add_all(opp_open4, loss_in(4))
                    return loss_in(4)

            opp_44 = self.opp_threats(T.TT_FORK_4x4)
            for rc in opp_44:
                self.actions.must_defend = True
                group = self.ana.pt[self.opp][:, rc[0], rc[1]]
                for d in range(4):
                    if group[d] in (T.PT_OPEN_4, T.PT_DOUBLE_4):
                        tmp = set(self.get_defensive_moves(rc, d))
                        defensive = tmp if defensive is None else (defensive & tmp)
                # all-but-one of the half-open fours must be refuted; the
                # union over-approximates, never overlooks (reference comment)
                if (group == T.PT_HALF_OPEN_4).any():
                    union: set = set()
                    for d in range(4):
                        if group[d] == T.PT_HALF_OPEN_4:
                            union |= set(self.get_defensive_moves(rc, d))
                    defensive = union if defensive is None else (defensive & union)
                if not defensive and not has_any_four:
                    self.add_all(opp_44, loss_in(4))
                    return loss_in(4)
            if defensive:
                self.add_all(sorted(defensive))
        else:
            for rc in self.opp_threats(T.TT_OPEN_4):
                self.actions.must_defend = True
                d = int(np.argmax(self.ana.pt[self.opp][:, rc[0], rc[1]] == T.PT_OPEN_4))
                self.add_all(self.get_defensive_moves(rc, d))
            if self.anything_forbidden_for(self.opp):
                # open four hidden inside the opponent's LEGAL 3x3 fork
                for rc in self.opp_threats(T.TT_FORK_3x3):
                    group = self.ana.pt[self.opp][:, rc[0], rc[1]]
                    if (group == T.PT_OPEN_4).any() and not self.is_forbidden(self.opp, rc):
                        self.actions.must_defend = True
                        d = int(np.argmax(group == T.PT_OPEN_4))
                        self.add_all(self.get_defensive_moves(rc, d))
            else:
                for rc in self.opp_threats(T.TT_FORK_4x4):
                    self.actions.must_defend = True
                    group = self.ana.pt[self.opp][:, rc[0], rc[1]]
                    for d in range(4):
                        if group[d] in (T.PT_HALF_OPEN_4, T.PT_OPEN_4, T.PT_DOUBLE_4):
                            self.add_all(self.get_defensive_moves(rc, d))

        if self.actions.must_defend:
            self.actions.has_initiative = has_any_four
            best = self.add_own_4x3_forks()
            self.add_own_half_open_fours()
            return best if is_win(best) else UNKNOWN  # stop either way
        self.actions.baseline_score = UNKNOWN
        return None

    def try_win_in_5(self):
        best = self.add_own_4x3_forks()
        if not self.anything_forbidden_for(self.stm):
            if self.n_available_fours(self.opp) == 0:
                own_33 = self.own_threats(T.TT_FORK_3x3)
                if own_33:
                    self.add_all(own_33, win_in(5))
                    best = max(best, win_in(5))
        if is_win(best):
            self.actions.has_initiative = True
            return best
        return None

    def defend_loss_in_6(self):
        if self.n_available_fours(self.stm) > 0:
            return None
        opp_43 = self.opp_threats(T.TT_FORK_4x3)
        opp_33 = self.opp_threats(T.TT_FORK_3x3)
        if opp_43 or opp_33:
            self.actions.must_defend = True
            self.actions.baseline_score = loss_in(6)

        for rc in opp_43:
            group = self.ana.pt[self.opp][:, rc[0], rc[1]]
            for d in range(4):
                if group[d] == T.PT_OPEN_3:
                    self.add_all(self.get_defensive_moves(rc, d), score(0))
            d4 = int(np.argmax(group == T.PT_HALF_OPEN_4))
            ho4_def = self.get_defensive_moves(rc, d4)
            self.add_all(ho4_def, score(0))
            # moves near those defenses that could regain initiative
            for m in ho4_def:
                for d in range(4):
                    dr, dc = DIRS[d]
                    for i in range(-4, 5):
                        t = (m[0] + i * dr, m[1] + i * dc)
                        if not self._in_bounds(t) or self.board[t] != NONE:
                            continue
                        if (self.ana.pt[self.stm][d, t[0], t[1]] > T.PT_NONE
                                or self.is_half_open_three_at(t, d, self.stm)):
                            self.add(t)

        if opp_33:
            for rc in opp_33:
                group = self.ana.pt[self.opp][:, rc[0], rc[1]]
                for d in range(4):
                    if group[d] == T.PT_OPEN_3:
                        self.add_all(self.get_defensive_moves(rc, d), score(0))
            self.add_all(self.own_threats(T.TT_FORK_3x3), score(13))
            self.add_all(self.own_threats(T.TT_OPEN_3), score(1))
            mask = self._star_like_mask(self.stm)
            for rc in map(tuple, np.argwhere(mask)):
                if rc in self.actions.moves:
                    continue
                for d in range(4):
                    if self.is_half_open_three_at(rc, d, self.stm):
                        self.add(rc, score(1))
                        break

        if self.actions.must_defend:
            self.add_own_half_open_fours()
            return UNKNOWN  # stop
        return None

    # -- helpers (reference: MoveGenerator.cpp:886-1010) ---------------------

    def add_own_4x3_forks(self) -> int:
        best = MIN_VALUE
        for rc in self.own_threats(T.TT_FORK_4x3):
            solution = self.try_solve_own_fork_4x3(rc)
            self.add(rc, solution, override=True)
            if is_proven(solution):
                best = max(best, solution)
        return best

    def add_own_half_open_fours(self) -> None:
        prior = score(14)
        count = 0
        if self.anything_forbidden_for(self.stm):
            for rc in self.own_threats(T.TT_FORK_3x3):
                group = self.ana.pt[self.stm][:, rc[0], rc[1]]
                if (group == T.PT_HALF_OPEN_4).any() and not self.is_forbidden(self.stm, rc):
                    self.add(rc, prior)
                    count += 1
        ho4 = self.own_threats(T.TT_HALF_OPEN_4)
        self.add_all(ho4, prior)
        if count + len(ho4) > 0:
            self.actions.has_initiative = True

    def try_solve_own_fork_4x3(self, rc) -> int:
        prior = score(15)
        if self.anything_forbidden_for(self.stm):
            return prior  # the fork's three may later become forbidden
        group = self.ana.pt[self.stm][:, rc[0], rc[1]]
        d = int(np.argmax(group == T.PT_HALF_OPEN_4))
        defenses = [m for m in self.raw_defensive_moves(self.opp, rc, d) if m != rc]
        best_opp = T.TT_NONE
        for m in defenses:
            tt = int(self.ana.tt[self.opp][m])
            if (tt not in (T.TT_FORK_4x4, T.TT_OVERLINE)
                    or not self.anything_forbidden_for(self.opp)):
                best_opp = max(best_opp, tt)
        if best_opp in (T.TT_NONE, T.TT_HALF_OPEN_3, T.TT_OPEN_3, T.TT_FORK_3x3):
            return win_in(5)
        if best_opp in (T.TT_HALF_OPEN_4, T.TT_FORK_4x3):
            return prior
        if best_opp in (T.TT_FORK_4x4, T.TT_OPEN_4):
            return loss_in(4)
        return loss_in(2)  # FIVE / OVERLINE

    def mark_forbidden_moves(self) -> None:
        self.add_all(self.own_threats(T.TT_OVERLINE), loss_in(1), override=True)
        self.add_all(self.own_threats(T.TT_FORK_4x4), loss_in(1), override=True)
        for rc in self.own_threats(T.TT_FORK_3x3):
            if self.is_forbidden(CROSS, rc):
                self.add(rc, loss_in(1), override=True)

    def _shape_mask(self, seeds: np.ndarray, shape_rows) -> np.ndarray:
        """Union of a 7x7 bit shape stamped at every seed, masked to empty
        cells (reference: mark_neighborhood / mark_star_like_pattern_for)."""
        out = np.zeros((self.h, self.w), bool)
        offs = [
            (i - 3, j - 3)
            for i, bits in enumerate(shape_rows)
            for j in range(7)
            if (bits >> (6 - j)) & 1
        ]
        for rc in map(tuple, np.argwhere(seeds)):
            for di, dj in offs:
                t = (rc[0] + di, rc[1] + dj)
                if self._in_bounds(t):
                    out[t] = True
        return out & self.ana.empty

    _NEIGHBORHOOD = (0b1001001, 0b0111110, 0b0111110, 0b1110111,
                     0b0111110, 0b0111110, 0b1001001)
    _STAR = (0b1001001, 0b0101010, 0b0011100, 0b1110111,
             0b0011100, 0b0101010, 0b1001001)

    def mark_neighborhood(self) -> np.ndarray:
        mask = self._shape_mask(self.board != NONE, self._NEIGHBORHOOD)
        if self.depth == 0:
            mask[self.h // 2, self.w // 2] = True
        return mask

    def _star_like_mask(self, sign: int) -> np.ndarray:
        return self._shape_mask(self.board == sign, self._STAR)

    def create_remaining_moves(self, mask: np.ndarray, s: int = UNKNOWN) -> None:
        for rc in map(tuple, np.argwhere(mask)):
            self.add(rc, s)

    # -- main dispatch (reference: MoveGenerator::generate, :159-231) --------

    def generate(self, mode: int) -> int:
        dtd = self.draw_after - self.depth
        if dtd <= 0:
            return draw_in(0)
        result = None
        if dtd >= 1:
            result = self.try_win_in_1()
        if result is None and dtd == 1:
            result = self.try_draw_in_1()
        if mode in (THREATS, OPTIMAL):
            if result is None and dtd >= 2:
                result = self.defend_loss_in_2()
            if result is None and dtd >= 3:
                result = self.try_win_in_3()
            if result is None and dtd >= 4:
                result = self.defend_loss_in_4()
            if result is None and dtd >= 5:
                result = self.try_win_in_5()
            if result is None and dtd >= 6:
                result = self.defend_loss_in_6()
            if result is None and dtd >= 3:
                self.add_own_half_open_fours()
        if result is None and mode >= OPTIMAL:
            if mode == OPTIMAL:
                if dtd >= 6:
                    self.add_all(self.opp_threats(T.TT_FORK_3x3), score(3))
                    self.add_all(self.opp_threats(T.TT_OPEN_3), score(2))
                if dtd >= 5:
                    self.add_all(self.own_threats(T.TT_FORK_3x3), score(13))
                    self.add_all(self.own_threats(T.TT_OPEN_3), score(1))
                if dtd >= 3:
                    self.add_all(self.opp_threats(T.TT_HALF_OPEN_4), score(4))
            mask = self.mark_neighborhood() if mode <= REDUCED else self.ana.empty
            self.create_remaining_moves(mask)
        if self.anything_forbidden_for(self.stm):
            self.mark_forbidden_moves()
        self.actions.is_fully_expanded = self.actions.must_defend or mode >= OPTIMAL
        return UNKNOWN if result is None else result


def generate(
    board: np.ndarray,
    stm: int,
    rules: GameRules,
    mode: str | int = "optimal",
    draw_after: int | None = None,
) -> tuple[ActionList, int]:
    """Generate the staged tactical move list for `stm` on `board`.

    Returns (actions, packed score) — the score is the statically proven
    position score or UNKNOWN (reference: MoveGenerator::generate return)."""
    if isinstance(mode, str):
        mode = _MODES[mode.lower()]
    g = _Generator(np.asarray(board, np.int8), stm, rules, draw_after)
    s = g.generate(mode)
    return g.actions, s
