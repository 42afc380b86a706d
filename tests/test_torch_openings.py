"""The port's balanced openings held against the JAX package's.

`propose_random_openings` is compared live, with the JAX package's own
random offsets (from the keys it splits) injected.  For
`generate_balanced_openings`, the JAX package's proposals (32 boards of 4
stones) with two tactical boards put in their place, a VCT win for the
side to move and a lost position, go through both packages with the exact
stub network of tests/test_torch_selfplay.py (values a one-hot win, draw
or loss, so the imbalances tie and their order is the lower index first):
the boards kept, in order, are equal to JAX's (the golden openings)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphagomoku_tpu.game.types import GameRules, CROSS, CIRCLE
from alphagomoku_tpu.selfplay import openings as JO

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.selfplay import openings as TO
from tests import torch_golden
from tests.test_torch_mcts import jax_tables
from tests.test_torch_selfplay import jax_stub, torch_stub

torch.set_num_threads(1)

H = W = 15
COUNT, OVERSAMPLE, STONES = 8, 4, 4


def jax_offsets(key, count: int, stones: int, span: int = 4) -> np.ndarray:
    """[stones, 2, count] row and column offsets, as the JAX package's
    propose_random_openings draws them from `key`."""
    out = []
    for k in jax.random.split(key, stones):
        kr, kc, _ = jax.random.split(k, 3)
        out.append([np.asarray(jax.random.randint(kr, (count,), -span, span + 1)),
                    np.asarray(jax.random.randint(kc, (count,), -span, span + 1))])
    return np.array(out)


def test_propose_random_openings_matches_jax():
    for seed, count, stones in ((0, 64, 4), (1, 256, 9)):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JO.propose_random_openings(key, count, H, W, stones))
        got = TO.propose_random_openings(None, count, H, W, stones,
                                         offsets=torch.from_numpy(jax_offsets(key, count, stones)))
        assert np.array_equal(got.numpy(), want)
        assert ((want != 0).sum((1, 2)) == stones).all()  # the collision shifts found room
    drawn = TO.propose_random_openings(torch.Generator().manual_seed(0), 512, H, W, 4)
    assert drawn.shape == (512, H, W) and ((drawn != 0).sum((1, 2)) == 4).all()


def candidates() -> np.ndarray:
    """The JAX package's proposals from PRNGKey(0)'s first split, with
    board 3 a VCT win for CROSS (an open three, CROSS to move) and board 5
    lost for CROSS (CIRCLE holds an open four)."""
    k1, _ = jax.random.split(jax.random.PRNGKey(0))
    cand = np.array(JO.propose_random_openings(k1, COUNT * OVERSAMPLE, H, W, STONES))
    cand[3] = 0
    cand[3, 7, 5:8] = CROSS
    cand[3, 0, 0] = cand[3, 14, 14] = CIRCLE
    cand[5] = 0
    cand[5, 7, 5:9] = CIRCLE
    cand[5, 0, 0] = cand[5, 14, 14] = cand[5, 0, 14] = CROSS
    return cand


def jax_openings() -> dict:
    """JAX's generate_balanced_openings on `candidates()` (its proposal
    function returns them)."""
    cand = candidates()
    jt = jax_tables(GameRules.FREESTYLE)
    propose = JO.propose_random_openings
    JO.propose_random_openings = lambda *args, **kw: jnp.asarray(cand)
    try:
        kept = jax.jit(lambda k: JO.generate_balanced_openings(
            jax_stub, None, jt, k, COUNT, H, W, stones=STONES, oversample=OVERSAMPLE))(
            jax.random.PRNGKey(0))
    finally:
        JO.propose_random_openings = propose
    return {"candidates": cand, "kept": np.asarray(kept)}


def test_generate_balanced_openings_matches_jax():
    ref = torch_golden.load("openings")
    kept = TO.generate_balanced_openings(
        torch_stub, None, TV.device_tables(GameRules.FREESTYLE), None, COUNT, H, W,
        stones=STONES, oversample=OVERSAMPLE, proposals=torch.from_numpy(ref["candidates"]))
    assert np.array_equal(kept.numpy(), ref["kept"])
    # the solver check dropped the won and the lost board
    for b in (3, 5):
        assert not (ref["kept"] == ref["candidates"][b]).all((1, 2)).any()


def test_opening_env():
    boards = TO.propose_random_openings(torch.Generator().manual_seed(1), 6, H, W, 5)
    env = TO.opening_env(boards, 5)
    assert env.to_move.tolist() == [CIRCLE] * 6 and env.move_count.tolist() == [5] * 6
    assert (env.outcome == 0).all() and env.board is boards
