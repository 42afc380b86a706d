"""The last two public functions of the reference's `game/vectorized.py`,
`windows_at_many` and `pattern_types`, against the JAX package on seeded
boards: bit-exact (the port's windows are int64, the reference's uint32).
The card holds them against their CPU results (`chip_smoke.py` phase 24)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.game import vectorized as JV
from alphagomoku_tpu_torch.game import vectorized as V
from alphagomoku_tpu_torch.game.types import GameRules

torch.set_num_threads(1)


def _boards(batch: int, rows: int, cols: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([0, 1, 2], np.int8), size=(batch, rows, cols), p=[0.5, 0.25, 0.25])


def _queries(batch: int, rows: int, cols: int, q: int, seed: int):
    """Query cells on the board, with a column off its row (which aliases
    a cell) and cells off the board (which read 0) among them."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, size=(batch, q)).astype(np.int32)
    c = rng.integers(0, cols, size=(batch, q)).astype(np.int32)
    r[:, 0], c[:, 0] = 1, cols + 2  # off its row: the cell 2 + 2 cols on
    r[:, 1], c[:, 1] = rows, 3  # below the board
    r[:, 2], c[:, 2] = -1, 0  # above it
    return r, c


def test_windows_at_many_matches_jax():
    board = _boards(3, 9, 9, seed=0)
    rows, cols = _queries(3, 9, 9, 7, seed=1)
    want = np.asarray(JV.windows_at_many(jnp.asarray(board), jnp.asarray(rows),
                                         jnp.asarray(cols)))
    got = V.windows_at_many(torch.from_numpy(board), torch.from_numpy(rows),
                            torch.from_numpy(cols))
    assert got.dtype == torch.int64 and got.shape == (3, 7, 4)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert not want[:, 1:3].any() and want[:, 3:].any()


@pytest.mark.parametrize("rules", list(GameRules), ids=lambda r: r.name)
def test_pattern_types_matches_jax(rules):
    board = _boards(4, 9, 9, seed=2)
    rows, cols = np.nonzero(np.ones((9, 9)))
    rows = np.broadcast_to(rows, (4, 81)).astype(np.int32)
    cols = np.broadcast_to(cols, (4, 81)).astype(np.int32)
    windows = V.windows_at_many(torch.from_numpy(board), torch.from_numpy(rows),
                                torch.from_numpy(cols))
    circle = np.array([[False], [True], [False], [True]])  # [B, 1] against [B, Q]
    want = np.asarray(JV.pattern_types(JV.device_tables(rules),
                                       jnp.asarray(windows.numpy().astype(np.uint32)),
                                       jnp.asarray(circle)))
    got = V.pattern_types(V.device_tables(rules), windows, torch.from_numpy(circle))
    assert got.shape == (4, 81, 4)
    assert np.array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2
    one = V.pattern_types(V.device_tables(rules), windows[1], True)  # a plain bool
    assert torch.equal(one, got[1])
