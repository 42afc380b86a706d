"""The port's loss prover held bit-exact against the JAX package's
`vct_batched.prepare_loss`, `finish_loss` and `solve_loss` (levels 1 and
2): on the positions of tests/test_loss_prover.py and the 9x9 and 15x15
boards of tests/fixtures/solver_golden.json, in freestyle and in renju
(the level-2 fixture of tests/test_loss_levels.py is
tests/test_torch_loss_levels.py).  The JAX side is the golden loss_prover
(`jax_loss_prover`).  The search's fused leaf leg (the option children
solved in the win solve's batch) is held against the separate solves."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from alphagomoku_tpu.game import board as board_mod
from alphagomoku_tpu.game.types import GameRules, CROSS, CIRCLE

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.search import mcts as TM
from alphagomoku_tpu_torch.search import vct_batched as TVB
from alphagomoku_tpu_torch.patterns import features as TF
from tests import torch_golden

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "solver_golden.json"


def prover_positions():
    """The 9x9 boards of tests/test_loss_prover.py, CIRCLE to move unless
    noted: an open four (lost), one four to block (holds), a forced block
    into a fork (lost), two open threes (lost), the same with a
    counter-four (holds), an own five (holds), two quiet boards (CIRCLE,
    CROSS)."""
    b = np.zeros((8, 9, 9), np.int8)
    b[0, 4, 2:6], b[0, 5, 2:5] = CROSS, CIRCLE
    b[1, 4, 0:4], b[1, 5, 0:3] = CROSS, CIRCLE
    b[2, 0, 0:4] = CROSS
    b[2, 1, 0] = b[2, 2, 2] = b[2, 8, 8] = CIRCLE
    b[2, 3, 5] = b[2, 4, 5] = b[2, 5, 3] = b[2, 5, 4] = CROSS
    for i in (3, 4):
        b[i, 2, 2:5] = CROSS
        b[i, 6, 2] = b[i, 5, 3] = b[i, 4, 4] = CROSS
    b[3, 8, 0] = b[3, 7, 2] = b[3, 0, 8] = CIRCLE
    b[4, 8, 0:3] = CIRCLE
    b[5, 4, 2:6], b[5, 6, 0:4] = CROSS, CIRCLE
    b[6, 4, 4], b[7, 2, 2] = CROSS, CIRCLE
    stm = np.array([CIRCLE] * 7 + [CROSS], np.int8)
    return b, stm


def golden_positions(size: int):
    """The boards of tests/fixtures/solver_golden.json of one size, with
    the side to move of their runs."""
    boards, stm = [], []
    for case in json.loads(GOLDEN.read_text()):
        board = board_mod.from_string(case["board"])
        if board.shape == (size, size):
            boards.append(board)
            stm.append(CROSS if case["runs"][0]["stm"] == "CROSS" else CIRCLE)
    return np.stack(boards), np.array(stm, np.int8)


ROOT = dict(max_options=8, max_depth=6, max_steps=64, max_threes=2)  # the search's roots


def cases():
    """(key, rules, boards, stm, solve_loss kwargs, levels) of every
    compared proof."""
    out = [("prover", GameRules.FREESTYLE, *prover_positions(),
            dict(max_options=8, max_depth=8, max_steps=512), (1,))]
    for rules in (GameRules.FREESTYLE, GameRules.RENJU):
        out.append((f"golden9.{rules.name}", rules, *golden_positions(9), ROOT, (1,)))
        out.append((f"golden15.{rules.name}", rules, *golden_positions(15), ROOT, (1,)))
        # level 2 at the leaves' budget on three of them (the batch grows
        # 32-fold a level)
        boards, stm = golden_positions(15)
        out.append((f"golden15.{rules.name}.l2", rules, boards[2:5], stm[2:5],
                    dict(ROOT, max_steps=16), (2,)))
    return out


def jax_loss_prover() -> dict:
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.game import vectorized as JV
    from alphagomoku_tpu.patterns import tables as JT
    from alphagomoku_tpu.search import vct_batched as JVB

    out = {}
    for key, rules, boards, stm, kw, levels in cases():
        tables = JV.RuleTables(pattern=None, threat=jnp.asarray(JT._build_threat_table(rules)),
                               rules=int(rules))
        b, s = jnp.asarray(boards), jnp.asarray(stm)
        prep = jax.jit(lambda b, s: JVB.prepare_loss(tables, b, s, kw["max_options"]))(b, s)
        for name, v in prep._asdict().items():
            out[f"{key}.prepare.{name}"] = np.asarray(v)
        for lv in levels:
            res = jax.jit(lambda b, s: JVB.solve_loss(tables, b, s, levels=lv, **kw))(b, s)
            for name, v in res._asdict().items():
                out[f"{key}.level{lv}.{name}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_loss_prover_matches_jax(case):
    key, rules, boards, stm, kw, levels = case
    ref = torch_golden.load("loss_prover")
    tables = TV.device_tables(rules)
    tb, ts = torch.from_numpy(boards), torch.from_numpy(stm)
    prep = TVB.prepare_loss(tables, tb, ts, kw["max_options"])
    for name, v in prep._asdict().items():
        assert np.array_equal(ref[f"{key}.prepare.{name}"], v.numpy()), name
    assert prep.provable.any()
    for lv in levels:
        res = TVB.solve_loss(tables, tb, ts, levels=lv, **kw)
        for name, v in res._asdict().items():
            assert np.array_equal(ref[f"{key}.level{lv}.{name}"], v.numpy()), (lv, name)
    if key == "prover":
        assert res.loss.tolist() == [True, False, True, True, False, False, False, False]
    if key.endswith(".l2"):
        assert res.loss.any()


def test_finish_loss_combines_children():
    """finish_loss on hand-made verdicts: all real options refuted is a
    loss at 1 + the longest refutation; one option left standing is not;
    an unprovable set never is; invalid lanes do not count."""
    prep = TVB.LossPrepared(
        child_board=None, child_stm=None,
        valid=torch.tensor([[True, True, False], [True, True, False], [True, False, False]]),
        provable=torch.tensor([True, True, False]), five_case=None,
        n_opts=torch.tensor([2, 2, 1]), base=torch.tensor([3, 3, 1], dtype=torch.int32))
    cwin = torch.tensor([[True, True, False], [True, False, True], [True, True, True]])
    cdist = torch.tensor([[5, 7, 99], [5, 0, 0], [1, 1, 1]], dtype=torch.int32)
    res = TVB.finish_loss(prep, cwin, cdist)
    assert res.loss.tolist() == [True, False, False]
    assert res.distance.tolist() == [8, 0, 0]


def test_fused_leaf_leg_equals_separate_solves():
    """The search's leaf solver puts the loss children into its win
    solve's batch (`mcts._solve`): per row that equals the win solve and
    `solve_loss` run apart, at the same budgets, with the compaction and
    the draw horizon applied the same way."""
    rules = GameRules.FREESTYLE
    tables = TV.device_tables(rules)
    boards, stm = golden_positions(15)
    pb, ps = prover_positions()
    pad = np.zeros((len(pb), 15, 15), np.int8)
    pad[:, :9, :9] = pb
    boards, stm = np.concatenate([boards, pad]), np.concatenate([stm, ps])
    tb, ts = torch.from_numpy(boards), torch.from_numpy(stm)
    n = len(boards)
    active = torch.arange(n) % 5 != 1
    dtd = torch.full((n,), 40, dtype=torch.int32)
    dtd[3] = 3
    packed = TF.encode(tables, tb, ts)
    cfg = TM.MCTSConfig(leaf_solver="vct", leaf_solver_steps=32, leaf_solver_cap=n - 2,
                        loss_prover=True, loss_cap=32)
    win, best, win_sc, lost, loss_sc = TM._solve(tables, cfg, tb, ts, active, dtd, 32, n - 2,
                                                 packed)

    sel = TV.first_k(((packed >> 8) & 0xFFF).ne(0).flatten(1).any(-1) & active, n - 2)
    sres = TVB.solve(tables, tb[sel], ts[sel], max_depth=6, max_steps=32, max_threes=2)
    want_win = torch.zeros(n, dtype=torch.bool).index_copy(0, sel, sres.win)
    dist = torch.zeros(n, dtype=torch.int32).index_copy(0, sel, sres.distance)
    want_win &= active & (dist <= dtd)
    assert torch.equal(win, want_win) and want_win.any()
    cand = TM._opp_threats(packed) & active
    lsel = TV.first_k(cand, n)
    lres = TVB.solve_loss(tables, tb[lsel], ts[lsel], max_options=8, max_depth=6, max_steps=32,
                          max_threes=2)
    want_lost = torch.zeros(n, dtype=torch.bool).index_copy(0, lsel, lres.loss & cand[lsel])
    ldist = torch.zeros(n, dtype=torch.int32).index_copy(0, lsel, lres.distance)
    want_lost &= (ldist <= dtd) & ~want_win
    assert torch.equal(lost, want_lost) and want_lost.any()
    assert torch.equal(loss_sc[lost], TM.S.loss_in(ldist.clamp(1, 512))[lost])
