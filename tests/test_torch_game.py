"""The port's `game/game.py` (`Game`: move history, outcome, PGN, JSON
round trip) held against the JAX package's class on the same moves: the
same outcomes, PGN text, `to_json` dict and saved files, for freestyle,
standard, renju (a forbidden black move) and an undo."""

import json

import numpy as np
import pytest
import torch

from alphagomoku_tpu.game.game import Game as JGame
from alphagomoku_tpu.game.types import GameRules, Move

from alphagomoku_tpu_torch.game.game import Game
from alphagomoku_tpu_torch.game.types import (
    CIRCLE, CROSS, GameOutcome, GameRules as TRules, Move as TMove,
)

torch.set_num_threads(1)

# (rules, moves as (row, col), undo after the move of this index or None)
_LINES = [
    (GameRules.FREESTYLE, [(7, 7), (8, 8), (7, 8), (8, 9), (7, 9), (8, 10), (7, 6), (0, 0),
                           (7, 5)], 5),
    (GameRules.STANDARD, [(7, 7), (8, 8), (7, 8), (8, 9)], None),
    # renju: black's (7, 7) makes a double three, forbidden -> CIRCLE_WIN
    (GameRules.RENJU, [(7, 5), (0, 0), (7, 6), (0, 2), (5, 7), (0, 4), (6, 7), (0, 6),
                       (7, 7)], None),
    (GameRules.CARO5, [(3, 3), (4, 4), (3, 4), (5, 5)], 2),
]


def _play(cls, move_cls, rules_cls, rules, moves, undo_at, rows=15, cols=15):
    g = cls(rules_cls(rules), rows, cols)
    g.cross_name, g.circle_name = "alpha", "beta"
    outcomes = []
    for i, (r, c) in enumerate(moves):
        g.make_move(move_cls(row=r, col=c, sign=g.sign_to_move()))
        outcomes.append(int(g.outcome))
        if i == undo_at:
            undone = g.undo_move()
            outcomes.append((undone.row, undone.col, int(undone.sign)))
            g.make_move(move_cls(row=undone.row, col=undone.col, sign=undone.sign))
    return g, outcomes


@pytest.mark.parametrize("rules,moves,undo_at", _LINES, ids=[r.name for r, _, _ in _LINES])
def test_game_equals_jax(tmp_path, rules, moves, undo_at):
    ours, o1 = _play(Game, TMove, TRules, rules, moves, undo_at)
    ref, o2 = _play(JGame, Move, GameRules, rules, moves, undo_at)
    assert o1 == o2
    assert ours.generate_pgn() == ref.generate_pgn()
    assert ours.to_json() == ref.to_json()
    assert json.dumps(ours.to_json()) == json.dumps(ref.to_json())
    assert np.array_equal(ours.board(), ref.board())
    assert (ours.sign_to_move(), ours.number_of_moves(), ours.is_over()) == (
        ref.sign_to_move(), ref.number_of_moves(), ref.is_over())
    ours.save(str(tmp_path / "ours.json"))
    ref.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    # each package loads the other's file to the same game
    back = Game.load(str(tmp_path / "ref.json"))
    assert back.to_json() == ref.to_json() and back.moves == ours.moves
    assert JGame.load(str(tmp_path / "ours.json")).to_json() == ours.to_json()


def test_game_flow():
    g = Game(TRules.FREESTYLE, 15, 15)
    assert g.sign_to_move() == CROSS
    for r, c in [(7, 7), (8, 8), (7, 8), (8, 9), (7, 9), (8, 10)]:
        g.make_move(TMove(row=r, col=c, sign=g.sign_to_move()))
    assert not g.is_over()
    g.undo_move()
    assert g.number_of_moves() == 5
    g.make_move(TMove(row=8, col=10, sign=CIRCLE))
    g.make_move(TMove(row=7, col=6, sign=CROSS))
    g.make_move(TMove(row=0, col=0, sign=CIRCLE))
    g.make_move(TMove(row=7, col=5, sign=CROSS))  # completes 7,5..7,9
    assert g.outcome == GameOutcome.CROSS_WIN
    with pytest.raises(AssertionError):
        g.make_move(TMove(row=1, col=1, sign=CIRCLE))
    pgn = g.generate_pgn()
    assert pgn.endswith("1-0") and "1. Xh7 Oi8" in pgn


def test_draw_after_and_opening():
    ours, ref = Game(TRules.FREESTYLE, 9, 9, draw_after=3), JGame(GameRules.FREESTYLE, 9, 9,
                                                                draw_after=3)
    opening = [(4, 4, CROSS), (0, 0, CIRCLE), (8, 8, CROSS)]
    ours.load_opening([TMove(*m) for m in opening])
    ref.load_opening([Move(*m) for m in opening])
    assert ours.outcome == GameOutcome.DRAW and int(ref.outcome) == int(ours.outcome)
    assert ours.generate_pgn() == ref.generate_pgn() and ours.generate_pgn().endswith("1/2-1/2")
    assert Game.from_json(ref.to_json()).to_json() == ours.to_json()
