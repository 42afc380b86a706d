"""Game: move-history wrapper with outcome tracking, PGN export and
JSON round-trip (reference: include/alphagomoku/game/Game.hpp:25-64,
src/game/Game.cpp).  Host-side convenience over the NumPy rules engine —
the batched path uses game.vectorized directly.

A copy of the reference package's `game/game.py` over the port's host
`board.py`, `rules.py` and `types.py`: the same PGN text, JSON dict and
files."""

from __future__ import annotations

import json

import numpy as np

from .rules import get_outcome
from .types import CROSS, CIRCLE, NONE, GameOutcome, GameRules, Move, invert_sign


class Game:
    def __init__(
        self,
        rules: GameRules = GameRules.FREESTYLE,
        rows: int = 15,
        cols: int = 15,
        draw_after: int = 0,
    ):
        self.rules = rules
        self.rows, self.cols = rows, cols
        self.draw_after = draw_after if draw_after > 0 else rows * cols
        self.moves: list[Move] = []
        self.outcome = GameOutcome.UNKNOWN
        self.cross_name = ""
        self.circle_name = ""

    # -- state -------------------------------------------------------------

    def board(self) -> np.ndarray:
        b = np.zeros((self.rows, self.cols), np.int8)
        for m in self.moves:
            b[m.row, m.col] = m.sign
        return b

    def sign_to_move(self) -> int:
        if not self.moves:
            return CROSS
        return invert_sign(self.moves[-1].sign)

    def number_of_moves(self) -> int:
        return len(self.moves)

    def is_over(self) -> bool:
        return self.outcome != GameOutcome.UNKNOWN

    # -- moves -------------------------------------------------------------

    def load_opening(self, opening: list[Move]) -> None:
        self.moves = []
        self.outcome = GameOutcome.UNKNOWN
        for m in opening:
            self.make_move(m)

    def make_move(self, move: Move) -> None:
        assert not self.is_over(), "game is over"
        assert move.sign == self.sign_to_move(), "wrong side to move"
        b = self.board()
        assert b[move.row, move.col] == NONE, "occupied"
        self.moves.append(move)
        b[move.row, move.col] = move.sign
        self.outcome = get_outcome(
            self.rules, b, move, number_of_moves_for_draw=self.draw_after
        )

    def undo_move(self) -> Move:
        m = self.moves.pop()
        self.outcome = GameOutcome.UNKNOWN
        return m

    # -- export ------------------------------------------------------------

    def generate_pgn(self) -> str:
        """(reference: Game::generatePGN, src/game/Game.cpp)"""
        result = {
            GameOutcome.CROSS_WIN: "1-0",
            GameOutcome.CIRCLE_WIN: "0-1",
            GameOutcome.DRAW: "1/2-1/2",
            GameOutcome.UNKNOWN: "*",
        }[self.outcome]
        lines = [
            '[Event "AlphaGomokuTPU"]',
            f'[White "{self.cross_name}"]',
            f'[Black "{self.circle_name}"]',
            f'[Result "{result}"]',
            "",
        ]
        body = []
        for i in range(0, len(self.moves), 2):
            num = i // 2 + 1
            pair = f"{num}. {self.moves[i].text()}"
            if i + 1 < len(self.moves):
                pair += f" {self.moves[i + 1].text()}"
            body.append(pair)
        body.append(result)
        lines.append(" ".join(body))
        return "\n".join(lines)

    # -- (de)serialization (reference: Game json+binary save/load) ----------

    def to_json(self) -> dict:
        return {
            "rules": self.rules.name,
            "rows": self.rows,
            "cols": self.cols,
            "draw_after": self.draw_after,
            "outcome": self.outcome.name,
            "cross_name": self.cross_name,
            "circle_name": self.circle_name,
            "moves": [m.text() for m in self.moves],
        }

    @staticmethod
    def from_json(data: dict) -> "Game":
        g = Game(
            rules=GameRules[data["rules"]],
            rows=data["rows"],
            cols=data["cols"],
            draw_after=data["draw_after"],
        )
        g.cross_name = data.get("cross_name", "")
        g.circle_name = data.get("circle_name", "")
        g.moves = [Move.from_text(t) for t in data["moves"]]
        g.outcome = GameOutcome[data["outcome"]]
        return g

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)

    @staticmethod
    def load(path: str) -> "Game":
        with open(path) as fh:
            return Game.from_json(json.load(fh))
