"""The port's board symmetries held bit for bit against the JAX package's
(live: integer and layout work only), and a search with symmetry
averaging against the JAX package's (golden `stub_search_symmetry`,
array equal as the other stub searches)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.game.types import GameRules
from alphagomoku_tpu.patterns import features as JF
from alphagomoku_tpu.utils import augment as JA

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.patterns import features as TF
from alphagomoku_tpu_torch.utils import augment as TA
from tests.test_torch_mcts import boards_and_stm, check_stub_search, jax_stub_search

torch.set_num_threads(1)

MODES = range(8)


def _x(shape, seed=0):
    return np.random.default_rng(seed).integers(-1000, 1000, size=shape).astype(np.int32)


def test_num_symmetries():
    for rows, cols in ((15, 15), (9, 9), (12, 15)):
        assert TA.num_symmetries(rows, cols) == JA.num_symmetries(rows, cols)
    assert TA.INVERSE == JA.INVERSE and TA.DIRECTION_PERM == JA.DIRECTION_PERM


@pytest.mark.parametrize("mode", MODES)
def test_apply_and_inverse_match_jax(mode):
    x = _x((3, 2, 7, 7))
    for fn in ("apply_symmetry", "inverse_symmetry"):
        want = np.asarray(getattr(JA, fn)(jnp.asarray(x), mode))
        got = getattr(TA, fn)(torch.from_numpy(x), mode).numpy()
        assert np.array_equal(want, got), fn
    want = np.asarray(JA.apply_symmetry_dyn(jnp.asarray(x), jnp.int32(mode)))
    assert np.array_equal(want, TA.apply_symmetry_dyn(torch.from_numpy(x), torch.tensor(mode)))
    want = np.asarray(JA.inverse_symmetry_dyn(jnp.asarray(x), jnp.int32(mode)))
    assert np.array_equal(want, TA.inverse_symmetry_dyn(torch.from_numpy(x), torch.tensor(mode)))
    # inverse undoes apply
    back = TA.inverse_symmetry(TA.apply_symmetry(torch.from_numpy(x), mode), mode)
    assert np.array_equal(back.numpy(), x)


def test_non_square_modes_match_jax():
    x = _x((2, 5, 8))
    for mode in range(4):
        want = np.asarray(JA.apply_symmetry(jnp.asarray(x), mode))
        assert np.array_equal(want, TA.apply_symmetry(torch.from_numpy(x), mode).numpy())


def test_batch_symmetry_matches_jax():
    modes = np.array([0, 1, 2, 3, 4, 5, 6, 7, 6, 3, 4, 0], np.int32)
    x = _x((len(modes), 3, 9, 9), seed=1)
    for fn in ("apply_symmetry_batch", "inverse_symmetry_batch"):
        want = np.asarray(getattr(JA, fn)(jnp.asarray(x), jnp.asarray(modes)))
        got = getattr(TA, fn)(torch.from_numpy(x), torch.from_numpy(modes)).numpy()
        assert np.array_equal(want, got), fn


@pytest.mark.parametrize("mode", MODES)
def test_symmetry_location_matches_jax(mode):
    h = w = 9
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    rows, cols = rows.ravel().astype(np.int32), cols.ravel().astype(np.int32)
    want = JA.symmetry_location(jnp.asarray(rows), jnp.asarray(cols), h, w, mode)
    got = TA.symmetry_location(torch.from_numpy(rows), torch.from_numpy(cols), h, w, mode)
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(want, got))
    want = JA.symmetry_location(jnp.asarray(rows), jnp.asarray(cols), h, w, jnp.int32(mode))
    got = TA.symmetry_location(torch.from_numpy(rows), torch.from_numpy(cols), h, w,
                               torch.tensor(mode))
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(want, got))
    # y[f(r, c)] == x[r, c] for y = apply_symmetry(x, mode)
    x = torch.from_numpy(_x((h, w), seed=2))
    y = TA.apply_symmetry(x, mode)
    r2, c2 = TA.symmetry_location(torch.from_numpy(rows).long(), torch.from_numpy(cols).long(),
                                  h, w, mode)
    assert torch.equal(y[r2, c2], x.flatten())


def _packed(rules=GameRules.FREESTYLE):
    boards, stm = boards_and_stm()
    return TF.encode(TV.device_tables(rules), torch.from_numpy(boards), torch.from_numpy(stm))


@pytest.mark.parametrize("mode", MODES)
def test_augment_features_matches_jax(mode):
    packed = _packed()
    want = np.asarray(JF.augment_features(jnp.asarray(packed.numpy().astype(np.uint32)), mode))
    got = TF.augment_features(packed, mode).numpy()
    assert np.array_equal(want.astype(np.int64), got)
    # the direction bits moved: the threat groups are not all symmetric
    if TA.DIRECTION_PERM[mode] != (0, 1, 2, 3):
        assert not torch.equal(TF.augment_features(packed, mode),
                               TA.apply_symmetry(packed, mode))


def test_augment_features_batch_matches_jax():
    packed = _packed(GameRules.RENJU).repeat(3, 1, 1)  # 12 boards
    modes = np.array([0, 1, 2, 3, 4, 5, 6, 7, 7, 5, 2, 4], np.int32)
    want = np.asarray(JF.augment_features_batch(jnp.asarray(packed.numpy().astype(np.uint32)),
                                                jnp.asarray(modes)))
    got = TF.augment_features_batch(packed, torch.from_numpy(modes)).numpy()
    assert np.array_equal(want.astype(np.int64), got)


SYMMETRY = dict(symmetry_averaging=True)


def jax_symmetry_search() -> dict:
    """The golden stub_search_symmetry: the stub search of
    tests/test_torch_mcts.py with symmetry averaging."""
    return jax_stub_search(GameRules.FREESTYLE, **SYMMETRY)


def test_symmetry_averaging_search_matches_jax():
    """Every evaluation in the step takes the mode (3 r + 5 c + sims) % 8 of
    its last move; the stub's position-dependent policy makes the modes
    give another tree than the search without them."""
    from alphagomoku_tpu_torch.search import mcts as TM
    from tests.test_torch_mcts import SIMS, TORCH_CFG, torch_stub

    ts = check_stub_search(GameRules.FREESTYLE, "stub_search_symmetry", **SYMMETRY)
    boards, stm = boards_and_stm()
    plain = TM.run_search(torch_stub, None, TV.device_tables(GameRules.FREESTYLE), TORCH_CFG,
                          boards, stm, SIMS, device="cpu")
    assert not torch.equal(ts.tree.edge_action, plain.tree.edge_action)
