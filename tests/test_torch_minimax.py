"""The port's host validation minimax and alpha-beta
(`search/minimax.py`) against known tactical results, against the JAX
package's on the same boards (scores and root actions equal), and against
the port's batched VCT (`search/vct_batched.py`, itself held against the
JAX package's): every batched win claim is confirmed by the minimax."""

import numpy as np
import pytest
import torch

from alphagomoku_tpu.game.types import GameRules
from alphagomoku_tpu.search import minimax as JMM

from alphagomoku_tpu_torch.game import vectorized as V
from alphagomoku_tpu_torch.game.types import CIRCLE, CROSS, GameRules as TRules
from alphagomoku_tpu_torch.search import minimax as MM
from alphagomoku_tpu_torch.search import move_generator as MG
from alphagomoku_tpu_torch.search import vct_batched as VB

torch.set_num_threads(1)

H = W = 15
FREE = TRules.FREESTYLE


def _open_three():
    b = np.zeros((H, W), np.int8)
    b[7, 4:7] = CROSS  # open three -> open four -> win in 3
    b[0, 0] = b[0, 14] = CIRCLE
    return b


def _double_three():
    b = np.zeros((H, W), np.int8)
    b[5, 7] = b[6, 7] = CROSS  # vertical pair
    b[7, 5] = b[7, 6] = CROSS  # horizontal pair
    b[0, 0] = b[0, 14] = b[14, 0] = CIRCLE
    return b


def _ladder():
    """A win reachable only through recursion: (7,7) makes a four and a
    half-open diagonal three, and the follow-up (8,8) a 4x3 fork."""
    b = np.zeros((H, W), np.int8)
    b[7, 4:7] = CROSS
    b[7, 3] = CIRCLE
    b[5, 5] = b[6, 6] = CROSS
    b[4, 4] = CIRCLE
    b[8, 10] = b[8, 11] = CROSS
    for rc in [(0, 0), (0, 14), (14, 0), (14, 14), (0, 7)]:
        b[rc] = CIRCLE
    return b


def test_win_in_1_and_3():
    b = np.zeros((H, W), np.int8)
    b[7, 3:7] = CROSS  # four in a row, open at (7,7) and (7,2)
    s, acts = MM.solve(b, CROSS, FREE, depth=2)
    assert s == MG.win_in(1)
    assert acts[(7, 7)] == MG.win_in(1) or acts[(7, 2)] == MG.win_in(1)
    s2, _ = MM.solve(_open_three(), CROSS, FREE, depth=4)
    assert s2 == MG.win_in(3), hex(s2)


def test_double_three_win_in_5():
    s, acts = MM.solve(_double_three(), CROSS, FREE, depth=6)
    assert s == MG.win_in(5), hex(s)
    assert MG.is_win(acts[(7, 7)])  # the fork cell


def test_alpha_beta_iterative_deepening():
    s, _ = MM.solve_ab(_open_three(), CROSS, FREE, max_depth=8)
    assert s == MG.win_in(3), hex(s)
    s2, _ = MM.solve_ab(_double_three(), CROSS, FREE, max_depth=8)
    assert s2 == MG.win_in(5), hex(s2)
    b3 = np.zeros((H, W), np.int8)
    b3[7, 4:7] = CROSS
    assert (MM.evaluate(b3, CROSS, FREE) & 8191) - 4000 > 0
    assert (MM.evaluate(b3, CIRCLE, FREE) & 8191) - 4000 < 0


def test_deepening_proves_forcing_four_ladder():
    b = _ladder()
    acts, s0 = MG.generate(b, CROSS, FREE, mode="optimal")
    assert not MG.is_proven(s0) and not MG.is_win(acts.moves[(7, 7)])
    s, _ = MM.solve(b, CROSS, FREE, depth=6)
    assert MG.is_win(s), hex(s)
    sab, root = MM.solve_ab(b, CROSS, FREE, max_depth=8)
    assert MG.is_win(sab) and MG.is_win(root[(7, 7)])


def test_score_helpers_equal_jax():
    values = [0, 0xFFFF, MG.UNKNOWN] + [f(d) for f in (MG.win_in, MG.loss_in, MG.draw_in)
                                        for d in range(0, 12)]
    values += [MG.score(e) for e in range(-1000, 1001, 97)]
    for s in values:
        assert MM.invert_up(s) == JMM.invert_up(s)
        assert MM.invert_down(s) == JMM.invert_down(s)


def _random_tactical(seed: int, n: int):
    rng = np.random.default_rng(seed)
    boards = []
    for _ in range(n):
        b = np.zeros((H, W), np.int8)
        r0, c0 = rng.integers(4, 9, size=2)
        k = rng.integers(4, 9)
        rs = np.clip(r0 + rng.integers(0, 5, size=k), 0, H - 1)
        cs = np.clip(c0 + rng.integers(0, 5, size=k), 0, W - 1)
        b[rs, cs] = CROSS
        for _ in range(rng.integers(0, 2)):
            r, c = rng.integers(0, H, size=2)
            if b[r, c] == 0:
                b[r, c] = CIRCLE
        boards.append(b)
    return boards


@pytest.mark.parametrize("rules", [GameRules.FREESTYLE, GameRules.RENJU], ids=lambda r: r.name)
def test_solvers_equal_jax(rules):
    """solve and solve_ab: the same packed score and root action scores as
    the JAX package's, on the fixed positions and on random tactical ones,
    with small node budgets (a budget cut ends both at the same node)."""
    boards = [_open_three(), _double_three(), _ladder()] + _random_tactical(int(rules), 6)
    for i, b in enumerate(boards):
        stm = CROSS if i % 3 else CIRCLE
        assert MM.solve(b, stm, TRules(rules), depth=4, node_budget=400) == JMM.solve(
            b, stm, rules, depth=4, node_budget=400)
        assert MM.solve_ab(b, stm, TRules(rules), max_depth=8, node_budget=300) == JMM.solve_ab(
            b, stm, rules, max_depth=8, node_budget=300)
        assert MM.evaluate(b, stm, TRules(rules)) == JMM.evaluate(b, stm, rules)


def test_minimax_agrees_with_batched_vct():
    """On random tactical boards every win claim of the port's batched VCT
    is confirmed by the (independent) minimax at matching depth."""
    tables = V.device_tables(FREE)
    boards = _random_tactical(9, 24)
    batch = torch.from_numpy(np.stack(boards))
    stm = torch.full((len(boards),), CROSS, dtype=torch.int8)
    res = VB.solve(tables, batch, stm, max_depth=6, max_steps=256)
    win = res.win.numpy()
    dist = res.distance.numpy()
    confirmed = 0
    for i in np.where(win)[0]:
        s, _ = MM.solve(boards[i], CROSS, FREE, depth=int(dist[i]) + 1, mode="threats")
        assert MG.is_win(s), (i, hex(s), int(dist[i]))
        confirmed += 1
    assert confirmed >= 1  # the corpus must exercise the cross-check
