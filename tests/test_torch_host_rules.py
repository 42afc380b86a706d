"""The port's exact host code (numpy, single positions) held against the
JAX package's: `game.rules` (get_outcome, is_forbidden), the host
defensive lookup and `search.vct.solve`, which `Engine.search` runs
before the tree.  Both sides are numpy, so every result must be equal:
on the reference's game fixtures (tests/fixtures/game_golden.json), on
renju boards, and on forcing positions, those of
tests/fixtures/solver_golden.json among them.  The rules are compared
live; the JAX side of the VCT and the defensive lookup comes from the
golden host_vct (`jax_host_vct`)."""

import json
from pathlib import Path

import numpy as np
import pytest

from alphagomoku_tpu.game import board as JB
from alphagomoku_tpu.game import rules as JR
from alphagomoku_tpu.game.types import GameOutcome, GameRules, Move, CROSS, CIRCLE
from alphagomoku_tpu.patterns import defensive as JD
from alphagomoku_tpu.patterns import tables as JT
from alphagomoku_tpu.search import vct as JVCT

from alphagomoku_tpu_torch.game import board as TB
from alphagomoku_tpu_torch.game import rules as TR
from alphagomoku_tpu_torch.game import types as TTY
from alphagomoku_tpu_torch.patterns import defensive as TD
from alphagomoku_tpu_torch.patterns import tables as TT
from alphagomoku_tpu_torch.search import vct as TVCT
from tests import torch_golden

FIXTURES = Path(__file__).resolve().parent / "fixtures"
GAME = json.loads((FIXTURES / "game_golden.json").read_text())
SOLVER = json.loads((FIXTURES / "solver_golden.json").read_text())
# the engine's host VCT budget (engine/engine.py: Engine.search), and a
# smaller node budget for the many fixture positions (a budget cut ends a
# search at the same node on both sides)
VCT_ARGS = dict(max_depth=8, node_budget=8000)
FIXTURE_VCT_ARGS = dict(max_depth=8, node_budget=500)


def tmove(m: Move) -> TTY.Move:
    return TTY.Move(m.row, m.col, m.sign)


@pytest.mark.parametrize("rules", list(GameRules), ids=lambda r: r.name)
def test_tables_equal(rules):
    """The pattern table built from the port's bit math and the threat
    table equal the JAX package's numpy tables."""
    for ours, ref in zip(TT.get_tables(TTY.GameRules(rules)), JT.get_tables(rules)):
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    windows = np.random.default_rng(0).integers(0, 1 << 22, size=512)
    for wnd in windows:
        assert TT.narrow_down(int(wnd)) == JT.narrow_down(int(wnd))
        assert TT.expand(int(wnd) & 0xFFFFF) == JT.expand(int(wnd) & 0xFFFFF)
        assert TT.open_three_promotion_moves(int(wnd)) == JT.open_three_promotion_moves(int(wnd))


def test_promotion_moves_batch_equals_jax():
    """`promotion_moves_batch` on uint32 windows equals the JAX package's,
    bit for bit, on random 22-bit windows and on each promotion pattern
    with random bits outside its mask (so every pattern is hit)."""
    rng = np.random.default_rng(1)
    hits = [(int(p) | (int(r) & ~int(m) & ((1 << 22) - 1)))
            for p, m in zip(JT._PROMO_PATTERNS, JT._PROMO_MASKS)
            for r in rng.integers(0, 1 << 22, size=8)]
    windows = np.concatenate([rng.integers(0, 1 << 22, size=256),
                              np.asarray(hits)]).astype(np.uint32)
    ours, ref = TT.promotion_moves_batch(windows), JT.promotion_moves_batch(windows)
    assert ours.dtype == ref.dtype == np.uint16 and np.array_equal(ours, ref)
    assert (ours[256:] != 0).all()
    assert [int(v) for v in ours] == [TT.open_three_promotion_moves(int(w)) for w in windows]


@pytest.mark.parametrize("fixture", GAME, ids=[f["name"] for f in GAME])
def test_game_fixture(fixture):
    """Each fixture replayed through both packages: every outcome and
    forbidden verdict equal, and equal to the fixture's."""
    jb = tb = None
    for op in fixture["ops"]:
        kind = op[0]
        if kind == "board":
            jb, tb = JB.from_string(op[1]), TB.from_string(op[1])
            assert np.array_equal(jb, tb)
        elif kind in ("add", "undo"):
            mv = Move.from_text(op[1])
            getattr(JB, f"{'put' if kind == 'add' else 'undo'}_move")(jb, mv)
            getattr(TB, f"{'put' if kind == 'add' else 'undo'}_move")(tb, tmove(mv))
        elif kind == "outcome":
            mv = Move.from_text(op[2])
            ref = JR.get_outcome(GameRules.from_string(op[1]), jb, mv)
            ours = TR.get_outcome(TTY.GameRules.from_string(op[1]), tb, tmove(mv))
            assert ours.name == ref.name == GameOutcome.from_string(op[3]).name, op
        elif kind == "forbidden":
            mv = Move.from_text(op[1])
            assert TR.is_forbidden(tb, tmove(mv)) == JR.is_forbidden(jb, mv) == op[2], op
    assert TB.to_string(tb) == JB.to_string(jb)


def clustered(seed: int, n: int, size: int = 15):
    """Random-walk clusters of black-heavy stones (tests/test_torch_renju.py's
    generator): renju boards with forks, fours and overlines."""
    rng = np.random.default_rng(seed)
    boards = np.zeros((n, size, size), np.int8)
    for i in range(n):
        r = c = size // 2
        for s in range(rng.integers(8, 30)):
            boards[i, r, c] = CROSS if s % 3 != 2 else CIRCLE
            r = int(np.clip(r + rng.integers(-2, 3), 0, size - 1))
            c = int(np.clip(c + rng.integers(-2, 3), 0, size - 1))
    return boards


def test_renju_forbidden_and_outcomes():
    """is_forbidden at every empty cell, and get_outcome of a stone at
    every empty cell for both signs under every rule, on clustered boards."""
    boards = clustered(7, 6)
    n_forbidden = 0
    for board in boards:
        for r, c in zip(*np.nonzero(board == 0)):
            ref = JR.is_forbidden(board, Move(int(r), int(c), CROSS))
            assert TR.is_forbidden(board, TTY.Move(int(r), int(c), CROSS)) == ref
            n_forbidden += ref
        for r, c in list(zip(*np.nonzero(board == 0)))[::7]:
            for rules in GameRules:
                for sign in (CROSS, CIRCLE):
                    ref = JR.get_outcome(rules, board, Move(int(r), int(c), sign))
                    ours = TR.get_outcome(TTY.GameRules(rules), board,
                                          TTY.Move(int(r), int(c), sign))
                    assert ours.name == ref.name
    assert n_forbidden > 0  # the boards hold forbidden cells


DEFENSIVE_RULES = (GameRules.FREESTYLE, GameRules.RENJU, GameRules.CARO5)
THREATS = (JT.PT_FIVE, JT.PT_OPEN_4, JT.PT_DOUBLE_4, JT.PT_HALF_OPEN_4, JT.PT_OPEN_3)


def defensive_queries():
    """(board, [(row, col, defender, threat)]): every threat type at every
    fourth empty cell of a clustered board, for both defenders."""
    board = clustered(3, 1)[0]
    cells = list(zip(*np.nonzero(board == 0)))[::4]
    return board, [(int(r), int(c), d, th) for r, c in cells for d in (CROSS, CIRCLE)
                   for th in THREATS]


def _solver_runs():
    for fx in SOLVER:
        for run in fx["runs"]:
            yield fx["board"], run["rules"], run["stm"]


def forcing_positions():
    """A double open three (only a VCT proves it: no four is on the
    board) for CROSS in freestyle and for CIRCLE in renju, a four chain (a
    VCF), a four for CIRCLE to block, and clustered renju boards with
    either side to move."""
    out = []
    b = np.zeros((15, 15), np.int8)
    for r, c in [(7, 6), (7, 7), (5, 8), (6, 8)]:
        b[r, c] = CROSS
    for r, c in [(0, 0), (0, 2), (14, 14), (14, 12)]:
        b[r, c] = CIRCLE
    out.append((b, CROSS, GameRules.FREESTYLE))
    out.append((np.where(b == 0, 0, 3 - b).astype(np.int8), CIRCLE, GameRules.RENJU))
    b = np.zeros((15, 15), np.int8)
    b[7, 5:8] = CROSS
    b[9, 9] = b[10, 10] = CROSS
    b[7, 4] = b[0, 0] = b[0, 2] = b[14, 14] = b[14, 12] = CIRCLE
    out.append((b, CROSS, GameRules.STANDARD))
    b = np.zeros((15, 15), np.int8)
    b[7, 3:7] = CIRCLE
    b[7, 2] = b[2, 2] = b[3, 3] = b[4, 4] = CROSS
    out.append((b, CROSS, GameRules.FREESTYLE))
    for i, board in enumerate(clustered(11, 4)):
        out.append((board, (CROSS, CIRCLE)[i % 2], GameRules.RENJU))
    return out


def _vct_arrays(results) -> dict:
    return {"win": np.array([r.win for r in results]),
            "best": np.array([r.best_move if r.best_move is not None else (-1, -1)
                              for r in results], np.int64),
            "nodes": np.array([r.nodes for r in results])}


def _cells_mask(lists, shape) -> np.ndarray:
    out = np.zeros((len(lists), shape[0] * shape[1]), bool)
    for i, cells in enumerate(lists):
        for r, c in cells:
            out[i, r * shape[1] + c] = True
    return out


def jax_host_vct() -> dict:
    """The JAX package's host VCT and defensive lookup on this file's
    inputs (the golden host_vct; the JAX side builds its defensive
    tables for minutes without memoization, so the tier-1 tests read it
    from the golden)."""
    out = {}
    fixtures = [JVCT.solve(JB.from_string(b), CROSS if s == "CROSS" else CIRCLE,
                           GameRules.from_string(r), **FIXTURE_VCT_ARGS)
                for b, r, s in _solver_runs()]
    out.update({f"fixtures.{k}": v for k, v in _vct_arrays(fixtures).items()})
    forcing = [JVCT.solve(b, s, r, **(VCT_ARGS if i < 4 else FIXTURE_VCT_ARGS))
               for i, (b, s, r) in enumerate(forcing_positions())]
    out.update({f"forcing.{k}": v for k, v in _vct_arrays(forcing).items()})
    board, queries = defensive_queries()
    for rules in DEFENSIVE_RULES:
        out[f"defensive.{rules.name}"] = _cells_mask(
            [JD.defensive_cells_for_threat(board, r, c, d, th, rules) for r, c, d, th in queries],
            board.shape)
    return out


@pytest.mark.parametrize("rules", DEFENSIVE_RULES, ids=lambda r: r.name)
def test_defensive_cells(rules):
    """The host defensive lookup of the exact VCT's AND nodes: every
    threat type at every fourth empty cell, for both defenders."""
    board, queries = defensive_queries()
    ref = torch_golden.load("host_vct")[f"defensive.{rules.name}"]
    ours = _cells_mask([TD.defensive_cells_for_threat(board, r, c, d, th, TTY.GameRules(rules))
                        for r, c, d, th in queries], board.shape)
    assert np.array_equal(ours, ref)
    assert ref.any()


@pytest.mark.parametrize("i", range(len(list(_solver_runs()))),
                         ids=[f"{fx['name']}-{j}" for fx in SOLVER for j in range(len(fx["runs"]))])
def test_vct_solve_fixtures(i):
    """vct.solve on the reference's move-generator positions (forks,
    fours, defences), equal result for result."""
    board, rules, stm = list(_solver_runs())[i]
    ref = torch_golden.load("host_vct")
    ours = TVCT.solve(JB.from_string(board), CROSS if stm == "CROSS" else CIRCLE,
                      TTY.GameRules.from_string(rules), **FIXTURE_VCT_ARGS)
    got = _vct_arrays([ours])
    for k in ("win", "best", "nodes"):
        assert np.array_equal(got[k][0], ref[f"fixtures.{k}"][i]), k


def test_vct_solve_forcing_positions():
    ref = torch_golden.load("host_vct")
    ours = _vct_arrays([TVCT.solve(b, s, TTY.GameRules(r),
                                   **(VCT_ARGS if i < 4 else FIXTURE_VCT_ARGS))
                        for i, (b, s, r) in enumerate(forcing_positions())])
    for k in ("win", "best", "nodes"):
        assert np.array_equal(ours[k], ref[f"forcing.{k}"]), k
    assert ref["forcing.win"].sum() >= 3
