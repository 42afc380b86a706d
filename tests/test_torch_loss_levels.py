"""The loss prover's level-2 fail-low recursion in the port, held
bit-exact against the JAX package's `vct_batched.solve_loss` on the
fixture of tests/test_loss_levels.py, which level 1 cannot prove lost and
level 2 proves, at that test's budgets.  The JAX side is the golden
loss_levels (`jax_loss_levels`)."""

import numpy as np
import torch

from alphagomoku_tpu.game.types import GameRules, CROSS

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.search import vct_batched as TVB
from tests import torch_golden
from tests.test_loss_levels import _l2_board

torch.set_num_threads(1)

KW = dict(max_options=8, max_depth=8, max_steps=384)


def jax_loss_levels() -> dict:
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.game import vectorized as JV
    from alphagomoku_tpu.patterns import tables as JT
    from alphagomoku_tpu.search import vct_batched as JVB

    rules = GameRules.FREESTYLE
    tables = JV.RuleTables(pattern=None, threat=jnp.asarray(JT._build_threat_table(rules)),
                           rules=int(rules))
    out = {}
    for lv in (1, 2):
        res = jax.jit(lambda b, s: JVB.solve_loss(tables, b, s, levels=lv, **KW))(
            jnp.asarray(_l2_board()[None]), jnp.asarray([CROSS], jnp.int8))
        for name, v in res._asdict().items():
            out[f"level{lv}.{name}"] = np.asarray(v)
    return out


def test_level2_proves_where_level1_fails_as_jax():
    ref = torch_golden.load("loss_levels")
    tables = TV.device_tables(GameRules.FREESTYLE)
    board = torch.from_numpy(_l2_board()[None])
    stm = torch.tensor([CROSS], dtype=torch.int8)
    for lv in (1, 2):
        res = TVB.solve_loss(tables, board, stm, levels=lv, **KW)
        for name, v in res._asdict().items():
            assert np.array_equal(ref[f"level{lv}.{name}"], v.numpy()), (lv, name)
    assert not ref["level1.loss"][0]
    assert res.loss[0] and res.distance[0] >= 3
