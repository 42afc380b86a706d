"""The port's batched VCT solver held bit-exact against the JAX package's
`vct_batched.solve`: win, best_move and distance, on the positions of
tests/test_vct_batched.py and on seeded middle games of the four
non-renju rules, at the MCTS budgets (depth 6, threes 2, steps 16 and
64), and under renju on those positions, renju middle games and
black-heavy clusters.  The JAX sides are the goldens vct_solve
(`jax_vct_solve`; its compiles take minutes) and vct_solve_renju
(`jax_vct_solve_renju`).
"""

import numpy as np
import pytest
import torch

from alphagomoku_tpu.game import board as board_mod
from alphagomoku_tpu.game.types import GameRules, CROSS, CIRCLE

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.search import vct_batched as TVB
from tests import torch_golden
from tests.test_vct import FORK
from tests import test_vct_batched as jax_vct_tests

torch.set_num_threads(1)

NON_RENJU = [GameRules.FREESTYLE, GameRules.STANDARD, GameRules.CARO5, GameRules.CARO6]
MCTS_BUDGETS = [dict(max_depth=6, max_threes=2, max_steps=16),
                dict(max_depth=6, max_threes=2, max_steps=64)]


def _board_of(test) -> np.ndarray:
    """The board diagram a JAX test solves (the first string constant of
    its code)."""
    return board_mod.from_string(next(c for c in test.__code__.co_consts if isinstance(c, str)
                                      and c.count("_") > 100))


def positions():
    """The positions of tests/test_vct_batched.py, CROSS to move: the
    double-three fork (a win), a VCF chain (a win), a three the defender
    refutes with a counter-three, an immediate five, and a quiet board."""
    five = np.zeros((15, 15), np.int8)
    five[0, :4] = CROSS
    boards = np.stack([board_mod.from_string(FORK), _board_of(jax_vct_tests.test_vcf_chain_found),
                       _board_of(jax_vct_tests.test_defender_counter_three_refutes), five,
                       np.zeros((15, 15), np.int8)])
    return boards, np.full(len(boards), CROSS, np.int8)


def middle_games(rules):
    """Seeded center-heavy middle games, both sides to move."""
    rng = np.random.default_rng(100 + int(rules))
    boards = np.zeros((16, 15, 15), np.int8)
    for b in boards:
        for i in range(22):
            r, c = rng.integers(3, 12), rng.integers(3, 12)
            if b[r, c] == 0:
                b[r, c] = CROSS if i % 2 == 0 else CIRCLE
    return boards, np.where(np.arange(16) % 2 == 0, CROSS, CIRCLE).astype(np.int8)


def cases():
    """(key, rules, boards, stm, solve kwargs) of every compared solve."""
    out = []
    for kw in MCTS_BUDGETS:
        out.append((f"positions.{kw['max_steps']}", GameRules.FREESTYLE, *positions(), kw))
    for rules in NON_RENJU:
        for kw in MCTS_BUDGETS:
            out.append((f"{rules.name}.{kw['max_steps']}", rules, *middle_games(rules), kw))
    return out


def renju_cases():
    """The compared renju solves: the positions, renju middle games and the
    black-heavy clusters of tests/test_torch_renju.py, both sides to move,
    at the leaves' budget (16 steps)."""
    from tests.test_torch_renju import clustered

    kw = MCTS_BUDGETS[0]
    alternate = np.where(np.arange(32) % 2 == 0, CROSS, CIRCLE).astype(np.int8)
    return [("positions", GameRules.RENJU, *positions(), MCTS_BUDGETS[1]),
            ("middle", GameRules.RENJU, *middle_games(GameRules.RENJU), kw),
            ("clustered", GameRules.RENJU, clustered(), alternate, kw)]


def jax_vct_solve(renju: bool = False) -> dict:
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.game import vectorized as JV
    from alphagomoku_tpu.patterns import tables as JT
    from alphagomoku_tpu.search import vct_batched as JVB

    out = {}
    for key, rules, boards, stm, kw in renju_cases() if renju else cases():
        tables = JV.RuleTables(pattern=None, threat=jnp.asarray(JT._build_threat_table(rules)),
                               rules=int(rules))
        res = jax.jit(lambda b, s: JVB.solve(tables, b, s, **kw))(jnp.asarray(boards),
                                                                 jnp.asarray(stm))
        for name, v in res._asdict().items():
            out[f"{key}.{name}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_solve_matches_jax(case):
    key, rules, boards, stm, kw = case
    ref = torch_golden.load("vct_solve")
    res = TVB.solve(TV.device_tables(rules), torch.from_numpy(boards),
                    torch.from_numpy(stm), **kw)
    for name, v in res._asdict().items():
        assert np.array_equal(ref[f"{key}.{name}"], v.numpy()), name
    if key.startswith("positions"):
        # fork, VCF chain and five proven; the counter-three refuted
        assert res.win.tolist() == [True, True, False, True, False]
        assert res.best_move[0] == 7 * 15 + 7 and res.best_move[3] == 4
    else:
        assert 0 < int(res.win.sum()) < len(boards)


@pytest.mark.parametrize("case", renju_cases(), ids=lambda c: c[0])
def test_renju_solve_matches_jax(case):
    """Renju: black's candidates leave out possibly forbidden cells, and a
    forced block certainly forbidden for a black defender is a win."""
    key, rules, boards, stm, kw = case
    ref = torch_golden.load("vct_solve_renju")
    res = TVB.solve(TV.device_tables(rules), torch.from_numpy(boards),
                    torch.from_numpy(stm), **kw)
    for name, v in res._asdict().items():
        assert np.array_equal(ref[f"{key}.{name}"], v.numpy()), name
    assert 0 < int(res.win.sum()) < len(boards)


def test_finished_board_is_a_fixed_point():
    """A board whose search has finished (WIN or FAIL) is left exactly as
    it is by one more transition, whatever the other boards do: `solve`
    relies on this when it checks for searching boards only every few
    transitions."""
    boards, stm = middle_games(GameRules.FREESTYLE)
    tb, ts = torch.from_numpy(boards), torch.from_numpy(stm)
    st = TVB._init_state(tb, max_depth=6, max_threes=2, tt_slots=128)
    step = TVB._make_transition(GameRules.FREESTYLE, ts, max_depth=6, max_defenses=12,
                                tt_slots=128)
    seen = set()
    for _ in range(48):
        done = st.status != TVB._SEARCHING
        before = [t.clone() for t in st]
        st = step(st)
        for old, new in zip(before, st):
            assert torch.equal(old[done], new[done])
        seen |= set(st.status[st.status != TVB._SEARCHING].tolist())
    assert seen == {TVB._WIN, TVB._FAIL}
    assert (st.status == TVB._SEARCHING).any()  # and others still searching
