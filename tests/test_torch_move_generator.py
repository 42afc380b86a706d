"""The port's staged host move generator (`search/move_generator.py`)
replays the reference's golden suite (tests/fixtures/solver_golden.json,
the asserts of test/search/alpha_beta/test_move_generator.cpp) and gives
the JAX package's `generate` result, action list, flags and score, on the
same boards.  Everything is an integer or a flag and must be equal."""

import json
import os

import numpy as np
import pytest
import torch

from alphagomoku_tpu.game.types import GameRules
from alphagomoku_tpu.search import move_generator as JMG

from alphagomoku_tpu_torch.game.board import from_string
from alphagomoku_tpu_torch.game.types import CIRCLE, CROSS, GameRules as TRules, Move
from alphagomoku_tpu_torch.search import move_generator as MG

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "solver_golden.json")

with open(FIXTURES) as fh:
    _CASES = json.load(fh)

_SIGNS = {"CROSS": CROSS, "CIRCLE": CIRCLE}
_SCORES = {"win_in": MG.win_in, "loss_in": MG.loss_in, "draw_in": MG.draw_in}


def _same(ours, ref):
    """Action lists and scores equal: (actions, score) of both packages."""
    (a, s), (b, t) = ours, ref
    assert s == t
    assert a.moves == b.moves
    assert list(a.moves) == list(b.moves)  # insertion order too
    for flag in ("must_defend", "has_initiative", "is_fully_expanded", "baseline_score"):
        assert getattr(a, flag) == getattr(b, flag), flag


@pytest.mark.parametrize("case", _CASES, ids=[c["name"] for c in _CASES])
def test_golden(case):
    board = from_string(case["board"])
    results = []
    for run in case["runs"]:
        ours = MG.generate(board, _SIGNS[run["stm"]], TRules[run["rules"]], mode=run["mode"])
        _same(ours, JMG.generate(board, _SIGNS[run["stm"]], GameRules[run["rules"]],
                                 mode=run["mode"]))
        actions = ours[0]
        results.append(actions)
        for a in run["asserts"]:
            kind = a[0]
            if kind == "must_defend":
                assert actions.must_defend == a[1]
            elif kind == "has_initiative":
                assert actions.has_initiative == a[1]
            elif kind == "size":
                got = len(actions)
                assert got == a[2] if a[1] == "eq" else got >= a[2]
            elif kind == "contains":
                mv = Move.from_text(a[2])
                assert actions.contains((mv.row, mv.col)) == a[1]
            elif kind == "score_of":
                mv = Move.from_text(a[1])
                assert actions.score_of((mv.row, mv.col)) == _SCORES[a[2]](a[3])
            elif kind == "equals":
                assert actions.moves.keys() == results[a[1]].moves.keys()
            else:  # pragma: no cover
                raise AssertionError(f"unknown assert {a}")


def _tactical_boards(seed: int, n: int, h: int = 15, w: int = 15):
    """Clustered stones of both colours, so that the tactical stages fire."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = np.zeros((h, w), np.int8)
        r0, c0 = rng.integers(3, h - 7), rng.integers(3, w - 7)
        k = int(rng.integers(4, 14))
        rs = r0 + rng.integers(0, 6, size=k)
        cs = c0 + rng.integers(0, 6, size=k)
        b[rs, cs] = rng.integers(1, 3, size=k)
        out.append(b)
    return out


@pytest.mark.parametrize("rules", list(GameRules), ids=lambda r: r.name)
def test_random_boards_equal_jax(rules):
    for i, board in enumerate(_tactical_boards(int(rules), 12)):
        stm = CROSS if i % 2 == 0 else CIRCLE
        for mode in ("basic", "threats", "optimal", "reduced", "legal"):
            _same(MG.generate(board, stm, TRules(rules), mode=mode),
                  JMG.generate(board, stm, rules, mode=mode))
        near_draw = int((board != 0).sum()) + 2
        _same(MG.generate(board, stm, TRules(rules), draw_after=near_draw),
              JMG.generate(board, stm, rules, draw_after=near_draw))
