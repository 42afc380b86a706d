"""Core game types: cell signs, rule variants, outcomes, move text I/O.

Capability parity with the reference engine's game core
(reference: include/alphagomoku/game/Move.hpp:17-174, game/rules.hpp:18-46),
re-expressed for array-first code: signs are plain int8 codes so boards are
`[B, H, W]` int8 tensors, and moves are `(row, col)` int pairs or a packed
int16.  A copy of the reference package's `game/types.py`.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

# Cell states (2 bits). Must match the reference encoding because the packed
# pattern windows (2 bits/cell) index precomputed tables built on this order
# (reference: game/Move.hpp:17-23).
NONE = 0
CROSS = 1  # black
CIRCLE = 2  # white
ILLEGAL = 3  # outside of board / padding


def invert_sign(sign: int) -> int:
    """Swap CROSS and CIRCLE, leave NONE/ILLEGAL unchanged."""
    if sign == CROSS:
        return CIRCLE
    if sign == CIRCLE:
        return CROSS
    return sign


_SIGN_TEXT = {NONE: "_", CROSS: "X", CIRCLE: "O", ILLEGAL: "|"}
_TEXT_SIGN = {v: k for k, v in _SIGN_TEXT.items()}


def sign_text(sign: int) -> str:
    return _SIGN_TEXT[sign]


def sign_from_text(c: str) -> int:
    return _TEXT_SIGN[c]


class GameRules(enum.IntEnum):
    """The five supported rule variants (reference: game/rules.hpp:18-25)."""

    FREESTYLE = 0
    STANDARD = 1
    RENJU = 2
    CARO5 = 3
    CARO6 = 4

    @staticmethod
    def from_string(s: str) -> "GameRules":
        return GameRules[s.upper()]

    def __str__(self) -> str:  # matches reference toString(GameRules)
        return self.name


class GameOutcome(enum.IntEnum):
    """Outcome codes (reference: game/rules.hpp GameOutcome)."""

    UNKNOWN = 0
    DRAW = 1
    CROSS_WIN = 2
    CIRCLE_WIN = 3

    @staticmethod
    def from_string(s: str) -> "GameOutcome":
        return GameOutcome[s.upper()]

    def __str__(self) -> str:
        return self.name


class Move(NamedTuple):
    """A move: sign + board location.

    Text format is sign letter + column letter + row number, e.g. "Xa0" for a
    cross in the upper-left corner (reference: game/Move.hpp text()/Move(str)).
    """

    row: int
    col: int
    sign: int

    @staticmethod
    def from_text(s: str) -> "Move":
        s = s.strip()
        sign = sign_from_text(s[0])
        col = ord(s[1]) - ord("a")
        row = int(s[2:])
        return Move(row=row, col=col, sign=sign)

    def text(self) -> str:
        return f"{sign_text(self.sign)}{chr(ord('a') + self.col)}{self.row}"

    def to_short(self) -> int:
        """16-bit packed form: 2b sign + 7b row + 7b col
        (reference: game/Move.hpp:144-147)."""
        return (self.sign << 14) | (self.row << 7) | self.col

    @staticmethod
    def from_short(v: int) -> "Move":
        return Move(row=(v >> 7) & 127, col=v & 127, sign=(v >> 14) & 3)


class Location(NamedTuple):
    """Board location with the reference's 16-bit packing
    (reference: game/Move.hpp:60-68: toShort() = (col << 8) | row)."""

    row: int
    col: int

    def to_short(self) -> int:
        return (self.col << 8) | self.row

    @staticmethod
    def from_short(v: int) -> "Location":
        return Location(row=v & 255, col=v >> 8)

    def text(self) -> str:
        return f"{chr(ord('a') + self.col)}{self.row}"


# Directions for 1-D line patterns. Order must match table packing
# (reference: patterns/common.hpp:27-31).
HORIZONTAL = 0
VERTICAL = 1
DIAGONAL = 2  # row+d, col+d
ANTIDIAGONAL = 3  # row+d, col-d

DIRECTION_STEPS = (
    (0, 1),  # HORIZONTAL
    (1, 0),  # VERTICAL
    (1, 1),  # DIAGONAL
    (1, -1),  # ANTIDIAGONAL
)
