"""The port's host position analysis (`patterns/host.py`: window_keys,
analyze), its table getters, `bitwise.classify_packed` and the 128-bit
incremental zobrist hash, held against the JAX package's on the same
inputs.  Every result is an integer and must be equal."""

import numpy as np
import pytest
import torch

from alphagomoku_tpu.game.types import GameRules
from alphagomoku_tpu.patterns import host as JH

from alphagomoku_tpu_torch.game import types as TTY
from alphagomoku_tpu_torch.patterns import bitwise as TBW
from alphagomoku_tpu_torch.patterns import host as TH
from alphagomoku_tpu_torch.patterns import tables as TT
from alphagomoku_tpu_torch.search import zobrist as TZ

torch.set_num_threads(1)


def _boards(seed: int, n: int, h: int = 15, w: int = 15) -> list[np.ndarray]:
    """Boards from empty to crowded, black and white stones alike."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fill = 0.05 + 0.5 * i / max(1, n - 1)
        cells = rng.random((h, w))
        b = np.where(cells < fill / 2, 1, np.where(cells < fill, 2, 0)).astype(np.int8)
        out.append(b)
    return out


@pytest.mark.parametrize("rules", list(GameRules), ids=lambda r: r.name)
def test_analyze_equals_jax(rules):
    for board in _boards(int(rules), 6) + _boards(10 + int(rules), 2, 9, 12):
        assert np.array_equal(TH.window_keys(board), JH.window_keys(board))
        ours, ref = TH.analyze(board, TTY.GameRules(rules)), JH.analyze(board, rules)
        assert np.array_equal(ours.empty, ref.empty)
        for sign in (1, 2):
            assert ours.pt[sign].dtype == ref.pt[sign].dtype
            assert np.array_equal(ours.pt[sign], ref.pt[sign])
            assert np.array_equal(ours.tt[sign], ref.tt[sign])


def test_table_getters():
    for rules in (TTY.GameRules.FREESTYLE, TTY.GameRules.RENJU):
        pattern, threat = TT.get_tables(rules)
        assert TT.get_pattern_table(rules) is pattern
        assert TT.get_threat_table(rules) is threat


@pytest.mark.parametrize("rules", [GameRules.FREESTYLE, GameRules.RENJU], ids=lambda r: r.name)
def test_classify_packed_equals_jax(rules):
    import jax.numpy as jnp

    from alphagomoku_tpu.patterns import bitwise as JBW

    windows = np.random.default_rng(3).integers(0, 1 << 22, size=2048, dtype=np.int64)
    windows &= ~np.int64(3 << 10)  # the center cell reads empty
    ref = np.asarray(JBW.classify_packed(jnp.asarray(windows, jnp.uint32), rules))
    ours = TBW.classify_packed(torch.from_numpy(windows), TTY.GameRules(rules))
    assert ours.dtype == torch.int64
    assert np.array_equal(ours.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("shape", [(15, 15), (9, 12)])
def test_incremental_hash_equals_jax(shape):
    import jax.numpy as jnp

    from alphagomoku_tpu.search import zobrist as JZ

    h, w = shape
    boards = np.stack(_boards(7, 5, h, w))
    table = JZ.make_table(h, w)
    ours_table = TZ.make_table(h, w)
    assert np.array_equal(ours_table.cell_keys_incr, table.cell_keys_incr)
    assert np.array_equal(ours_table.cell_keys, table.cell_keys)
    ref = np.asarray(JZ.incremental_hash(table, jnp.asarray(boards)))
    ours = TZ.incremental_hash(torch.from_numpy(boards))
    assert ours.shape == (5, 4) and np.array_equal(ours.numpy(), ref.astype(np.int64))

    rng = np.random.default_rng(1)
    action = rng.integers(-2, h * w + 2, size=5).astype(np.int32)  # off-board ones clip
    sign = rng.integers(1, 3, size=5).astype(np.int8)
    ref_u = np.asarray(JZ.update_hash(table, jnp.asarray(ref), jnp.asarray(action),
                                      jnp.asarray(sign)))
    ours_u = TZ.update_hash(ours, torch.from_numpy(action), torch.from_numpy(sign), h, w)
    assert np.array_equal(ours_u.numpy(), ref_u.astype(np.int64))
    # XOR undoes the move
    back = TZ.update_hash(ours_u, torch.from_numpy(action), torch.from_numpy(sign), h, w)
    assert torch.equal(back, ours)
    # placing a stone updates the hash as the full recompute does
    b2 = boards.copy()
    b2[0].reshape(-1)[0] = 0
    h0 = TZ.incremental_hash(torch.from_numpy(b2[:1]))
    b2[0].reshape(-1)[0] = 1
    upd = TZ.update_hash(h0, torch.tensor([0]), torch.tensor([1], dtype=torch.int8), h, w)
    assert torch.equal(upd, TZ.incremental_hash(torch.from_numpy(b2[:1])))
