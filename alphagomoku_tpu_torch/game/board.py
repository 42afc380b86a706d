"""Board text I/O and stateless board utilities (host side, NumPy).

Boards are `int8[H, W]` arrays with cell codes from `game.types`
(capability parity with reference game/Board.hpp:26-69).  A copy of the
reference package's `game/board.py`.
"""

from __future__ import annotations

import numpy as np

from .types import NONE, CROSS, CIRCLE, Move, sign_text


def from_string(s: str) -> np.ndarray:
    """Parse an ASCII board diagram.

    Recognized cells: '_' empty, 'X' cross, 'O' circle; '!' and '?' are
    treated as empty points of interest, exactly like the reference parser
    (reference: src/game/Board.cpp:118-148).
    """
    rows = [r for r in (line.strip() for line in s.splitlines()) if r]
    parsed = []
    for line in rows:
        cells = []
        for c in line.split():
            if c in ("_", "!", "?"):
                cells.append(NONE)
            elif c == "X":
                cells.append(CROSS)
            elif c == "O":
                cells.append(CIRCLE)
            else:
                raise ValueError(f"invalid board character {c!r}")
        parsed.append(cells)
    width = len(parsed[0])
    if any(len(r) != width for r in parsed):
        raise ValueError("ragged board string")
    return np.array(parsed, dtype=np.int8)


def to_string(board: np.ndarray) -> str:
    return "\n".join(" ".join(sign_text(int(c)) for c in row) for row in board)


def put_move(board: np.ndarray, move: Move) -> None:
    assert board[move.row, move.col] == NONE
    board[move.row, move.col] = move.sign


def undo_move(board: np.ndarray, move: Move) -> None:
    assert board[move.row, move.col] == move.sign
    board[move.row, move.col] = NONE


def is_full(board: np.ndarray) -> bool:
    return bool((board != NONE).all())


def number_of_moves(board: np.ndarray) -> int:
    return int((board != NONE).sum())
