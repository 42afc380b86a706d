"""The port's lockstep environment (`EnvState`, `env_reset`, `legal_mask`,
`env_step`) held bit-exact against the JAX package's, after every ply of
random games: B = 16 boards under freestyle and renju, moves drawn with
numpy near the center (so that fives and, under renju, forbidden black
moves happen within the game), one move in eight aimed at an occupied
cell, and a draw horizon on two of the three runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.game import vectorized as JV
from alphagomoku_tpu.game.types import GameRules, GameOutcome
from alphagomoku_tpu.patterns import tables as JT

from alphagomoku_tpu_torch.game import vectorized as TV
from tests import torch_golden

torch.set_num_threads(1)

B, H, W = 16, 15, 15
PLIES = 72


def _jax_tables(rules):
    return JV.RuleTables(pattern=None, threat=jnp.asarray(JT._build_threat_table(rules)),
                         rules=int(rules))


def _fields(state, to_np):
    return {f: to_np(getattr(state, f)) for f in ("board", "to_move", "outcome", "move_count")}


def _pick_moves(rng, board, legal):
    """A legal cell in the central 9x9 per board (any legal cell once those
    are full; an arbitrary cell on a finished board), and one move in
    eight aimed at an occupied cell."""
    rows = np.zeros(B, np.int64)
    cols = np.zeros(B, np.int64)
    center = np.zeros((H, W), bool)
    center[3:12, 3:12] = True
    for b in range(B):
        cells = np.flatnonzero(legal[b] & center)
        if cells.size == 0:
            cells = np.flatnonzero(legal[b])
        if cells.size == 0 or rng.random() < 0.125:
            taken = np.flatnonzero(board[b] != 0)
            cells = taken if taken.size else np.arange(H * W)
        rows[b], cols[b] = divmod(int(rng.choice(cells)), W)
    return rows, cols


def jax_env_games(rules, draw_after: int) -> dict:
    """The JAX package's env over PLIES plies of the seeded random games:
    the moves and the state after every ply, stacked [PLIES, ...] (the
    reference side of the test and of the renju golden)."""
    rng = np.random.default_rng(int(rules) * 100 + draw_after)
    jt = _jax_tables(rules)
    jstep = jax.jit(lambda s, r, c: JV.env_step(jt, s, r, c, draw_after=draw_after))
    js = JV.env_reset(B, H, W)
    out = {"rows": [], "cols": [], "legal": []}
    for _ in range(PLIES):
        legal = np.asarray(JV.legal_mask(js))
        rows, cols = _pick_moves(rng, np.asarray(js.board), legal)
        js = jstep(js, jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32))
        for name, value in [("rows", rows), ("cols", cols), ("legal", legal),
                            *_fields(js, np.asarray).items()]:
            out.setdefault(name, []).append(value)
    return {k: np.stack(v) for k, v in out.items()}


RENJU_DRAW_AFTER = 60


@pytest.mark.parametrize("rules, draw_after", [
    (GameRules.FREESTYLE, 0), (GameRules.FREESTYLE, 40), (GameRules.RENJU, RENJU_DRAW_AFTER),
], ids=["freestyle", "freestyle-draw40", "renju-draw60"])
def test_env_step_matches_jax_every_ply(rules, draw_after):
    """Freestyle live; renju against the golden env_renju (the JAX renju
    env_step takes half a minute to compile)."""
    ref = (jax_env_games(rules, draw_after) if rules != GameRules.RENJU
           else torch_golden.load("env_renju"))
    tt = TV.device_tables(rules)
    ts = TV.env_reset(B, H, W, device="cpu")
    seen = set()
    for ply in range(PLIES):
        assert np.array_equal(ref["legal"][ply], TV.legal_mask(ts).numpy()), ply
        ts = TV.env_step(tt, ts, torch.from_numpy(ref["rows"][ply]),
                         torch.from_numpy(ref["cols"][ply]), draw_after=draw_after)
        for name, got in _fields(ts, lambda t: t.numpy()).items():
            assert ref[name].dtype == got.dtype, name
            assert np.array_equal(ref[name][ply], got), (ply, name)
        seen.update(ts.outcome.tolist())
    # the games reach wins of both sides, and the horizon's draws
    assert {int(GameOutcome.CROSS_WIN), int(GameOutcome.CIRCLE_WIN)} <= seen
    assert (int(GameOutcome.DRAW) in seen) == (draw_after > 0)


def test_env_step_freezes_finished_games_and_ignores_occupied_cells():
    tables = TV.device_tables(GameRules.FREESTYLE)
    state = TV.env_reset(2, H, W, device="cpu")
    for c in range(4):  # CROSS builds a four on row 7, CIRCLE answers on row 0
        state = TV.env_step(tables, state, torch.tensor([7, 7]), torch.tensor([c, c]))
        state = TV.env_step(tables, state, torch.tensor([0, 0]), torch.tensor([c, c]))
    state = TV.env_step(tables, state, torch.tensor([7, 0]), torch.tensor([4, 0]))
    assert state.outcome.tolist() == [int(GameOutcome.CROSS_WIN), int(GameOutcome.UNKNOWN)]
    assert state.move_count.tolist() == [9, 8]  # board 1 played onto an occupied cell
    frozen = TV.env_step(tables, state, torch.tensor([10, 10]), torch.tensor([10, 10]))
    assert torch.equal(frozen.board[0], state.board[0])
    assert frozen.move_count.tolist() == [9, 9]
    assert not TV.legal_mask(frozen)[0].any()
