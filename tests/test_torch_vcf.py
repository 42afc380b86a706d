"""The port's batched VCF solver held bit-exact against the JAX package's
`vcf.solve`: win, best_move and distance, on the positions of
tests/test_vcf.py and on seeded boards, in freestyle and in renju (where
a black defender's forbidden block is a win).  The JAX side is the golden
vcf_solve (`jax_vcf_solve`)."""

import numpy as np
import pytest
import torch

from alphagomoku_tpu.game.types import GameRules, CROSS, CIRCLE

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.search import vcf as TVCF
from tests import torch_golden
from tests import test_vcf as jax_vcf_tests
from tests.test_torch_renju import clustered
from tests.test_torch_vct import _board_of, middle_games

torch.set_num_threads(1)

RULES = [GameRules.FREESTYLE, GameRules.RENJU]


def positions():
    """The boards of tests/test_vcf.py, CROSS to move: a five in one, a
    two-step VCF, no VCF, an opponent five that blocks the VCF, and the
    two boards of its batched test (a win and a quiet board)."""
    boards = [_board_of(getattr(jax_vcf_tests, name)) for name in (
        "test_win_in_one", "test_vcf_depth_two", "test_no_vcf", "test_opponent_five_blocks_vcf")]
    win1 = np.zeros((15, 15), np.int8)
    win1[7, 3:7] = CROSS
    win1[9, 3:5] = CIRCLE
    nowin = np.zeros((15, 15), np.int8)
    nowin[7, 3], nowin[8, 3] = CROSS, CIRCLE
    boards = np.stack(boards + [win1, nowin])
    return boards, np.full(len(boards), CROSS, np.int8)


def cases():
    """(key, rules, boards, stm, solve kwargs) of every compared solve:
    the test positions at the JAX test's budgets (depth 8, 128 steps),
    seeded middle games and black-heavy clusters, both sides to move, at
    the search's root budgets (depth 6, 64 steps)."""
    out = []
    alternate = np.where(np.arange(32) % 2 == 0, CROSS, CIRCLE).astype(np.int8)
    for rules in RULES:
        out.append((f"positions.{rules.name}", rules, *positions(),
                    dict(max_depth=8, max_steps=128)))
        out.append((f"middle.{rules.name}", rules, *middle_games(rules),
                    dict(max_depth=6, max_steps=64)))
        out.append((f"clustered.{rules.name}", rules, clustered(), alternate,
                    dict(max_depth=6, max_steps=64)))
    return out


def jax_vcf_solve() -> dict:
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.game import vectorized as JV
    from alphagomoku_tpu.patterns import tables as JT
    from alphagomoku_tpu.search import vcf as JVCF

    out = {}
    for key, rules, boards, stm, kw in cases():
        tables = JV.RuleTables(pattern=None, threat=jnp.asarray(JT._build_threat_table(rules)),
                               rules=int(rules))
        res = jax.jit(lambda b, s: JVCF.solve(tables, b, s, **kw))(jnp.asarray(boards),
                                                                  jnp.asarray(stm))
        for name, v in res._asdict().items():
            out[f"{key}.{name}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_solve_matches_jax(case):
    key, rules, boards, stm, kw = case
    ref = torch_golden.load("vcf_solve")
    res = TVCF.solve(TV.device_tables(rules), torch.from_numpy(boards), torch.from_numpy(stm),
                     **kw)
    for name, v in res._asdict().items():
        assert np.array_equal(ref[f"{key}.{name}"], v.numpy()), name
    if key.startswith("positions"):
        # the five, the VCF and the batched win proven; the others not
        assert res.win.tolist() == [True, True, False, False, True, False]
        assert res.best_move[0] == 7 * 15 + 7 and res.distance[0] == 1
    else:
        assert 0 < int(res.win.sum()) < len(boards)


def test_finished_board_is_a_fixed_point():
    """A board whose search has finished is left exactly as it is by one
    more transition (`solve` checks for searching boards only every few
    transitions)."""
    boards = clustered()
    stm = torch.from_numpy(np.where(np.arange(32) % 2 == 0, CROSS, CIRCLE).astype(np.int8))
    st = TVCF._init_state(torch.from_numpy(boards), max_depth=6)
    step = TVCF._make_transition(TV.device_tables(GameRules.RENJU), stm, max_depth=6)
    seen = set()
    for _ in range(24):
        done = st.status != TVCF._SEARCHING
        before = [t.clone() for t in st]
        st = step(st)
        for old, new in zip(before, st):
            assert torch.equal(old[done], new[done])
        seen |= set(st.status[st.status != TVCF._SEARCHING].tolist())
    assert seen == {TVCF._WIN, TVCF._FAIL}
