"""Rules, features, scores, hashes and the static solver of the PyTorch
port, held bit-exact against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.game import vectorized as JV
from alphagomoku_tpu.game.types import GameRules, GameOutcome
from alphagomoku_tpu.patterns import bitwise as JB
from alphagomoku_tpu.patterns import features as JF
from alphagomoku_tpu.search import score as JS
from alphagomoku_tpu.search import static_solver as JSS
from alphagomoku_tpu.search import zobrist as JZ

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.patterns import bitwise as TB
from alphagomoku_tpu_torch.patterns import features as TF
from alphagomoku_tpu_torch.search import score as TS
from alphagomoku_tpu_torch.search import static_solver as TSS
from alphagomoku_tpu_torch.search import zobrist as TZ

torch.set_num_threads(1)

NON_RENJU = [GameRules.FREESTYLE, GameRules.STANDARD, GameRules.CARO5, GameRules.CARO6]


def _jax_tables(rules):
    # the non-renju batched paths read only `rules` (bit-math classify),
    # so the 4^10 lookup tables need not be built
    return JV.RuleTables(pattern=None, threat=None, rules=int(rules))


def _boards(seed, n=12, h=15, w=15):
    rng = np.random.default_rng(seed)
    density = rng.uniform(0.1, 0.6, size=(n, 1, 1))
    filled = rng.random((n, h, w)) < density
    signs = rng.integers(1, 3, size=(n, h, w))
    return np.where(filled, signs, 0).astype(np.int8), rng


@pytest.mark.parametrize("rules", list(GameRules))
def test_classify_and_five_mask_match_jax(rules):
    rng = np.random.default_rng(int(rules))
    wins = rng.integers(0, 1 << 22, size=(4096,), dtype=np.uint32) & np.uint32(0x3FF3FF)
    jx, jo = JB.classify(jnp.asarray(wins), rules)
    tx, to = TB.classify(torch.from_numpy(wins.astype(np.int64)), rules)
    assert np.array_equal(np.asarray(jx), tx.numpy())
    assert np.array_equal(np.asarray(jo), to.numpy())
    jfx, jfo = JB.five_mask(jnp.asarray(wins), rules)
    tfx, tfo = TB.five_mask(torch.from_numpy(wins.astype(np.int64)), rules)
    assert np.array_equal(np.asarray(jfx), tfx.numpy())
    assert np.array_equal(np.asarray(jfo), tfo.numpy())
    assert tx.eq(6).eq(tfx).all() and to.eq(6).eq(tfo).all()


@pytest.mark.parametrize("rules", NON_RENJU)
def test_windows_encode_unpack_match_jax(rules):
    boards, rng = _boards(10 + int(rules))
    stm = rng.integers(1, 3, size=boards.shape[0]).astype(np.int8)
    tb, ts = torch.from_numpy(boards), torch.from_numpy(stm)
    assert np.array_equal(
        np.asarray(JV.windows_all(jnp.asarray(boards))).astype(np.int64),
        TV.windows_all(tb).numpy(),
    )
    rows = rng.integers(0, 15, size=boards.shape[0]).astype(np.int32)
    cols = rng.integers(0, 15, size=boards.shape[0]).astype(np.int32)
    assert np.array_equal(
        np.asarray(JV.windows_at_one(jnp.asarray(boards), jnp.asarray(rows), jnp.asarray(cols))),
        TV.windows_at_one(tb, torch.from_numpy(rows), torch.from_numpy(cols)).numpy(),
    )
    jp = np.asarray(JF.encode(_jax_tables(rules), jnp.asarray(boards), jnp.asarray(stm)))
    tp = TF.encode(TV.device_tables(rules), tb, ts)
    assert np.array_equal(jp.astype(np.int64), tp.numpy())
    assert np.array_equal(
        np.asarray(JF.unpack_raw_planes(jnp.asarray(jp))).astype(np.float32),
        TF.unpack_raw_planes(tp).float().numpy(),
    )
    assert np.array_equal(
        np.asarray(JF.unpack_planes(jnp.asarray(jp))).astype(np.float32),
        TF.unpack_planes(tp).float().numpy(),
    )


@pytest.mark.parametrize("rules", NON_RENJU)
def test_outcome_after_matches_jax(rules):
    boards, rng = _boards(20 + int(rules), n=64)
    n = boards.shape[0]
    rows = np.zeros(n, np.int32)
    cols = np.zeros(n, np.int32)
    signs = rng.integers(1, 3, size=n).astype(np.int8)
    for b in range(n):
        empty = np.flatnonzero(boards[b] == 0)
        cell = rng.choice(empty)
        rows[b], cols[b] = divmod(int(cell), 15)
        boards[b, rows[b], cols[b]] = signs[b]
    count = (boards != 0).sum((1, 2)).astype(np.int32)
    draw_after = int(np.median(count))
    jo = JV.outcome_after(
        _jax_tables(rules), jnp.asarray(boards), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(signs), jnp.asarray(count), draw_after,
    )
    to = TV.outcome_after(
        TV.device_tables(rules), torch.from_numpy(boards), torch.from_numpy(rows),
        torch.from_numpy(cols), torch.from_numpy(signs), torch.from_numpy(count), draw_after,
    )
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert len(set(to.tolist())) >= 2  # the draw horizon and fives both fire


def test_renju_raises_not_implemented():
    """Under renju, the search options of ROADMAP.md item 10 (another
    policy, leaf_batch > 1, root noise, symmetry averaging) still raise
    NotImplementedError naming the item."""
    from alphagomoku_tpu_torch.search import mcts as TM
    from tests.test_torch_mcts import TORCH_CFG, boards_and_stm, torch_stub

    tables = TV.device_tables(GameRules.RENJU)
    boards, stm = boards_and_stm()
    for cfg in (TORCH_CFG._replace(policy="ucb"), TORCH_CFG._replace(leaf_batch=2),
                TORCH_CFG._replace(noise_weight=0.25),
                TORCH_CFG._replace(symmetry_averaging=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 10"):
            TM.run_search(torch_stub, None, tables, cfg, boards, stm, 1, device="cpu")


def test_renju_tables_build_and_search_runs():
    """Renju is ported: its tables build and its search runs, with each
    leaf solver and the loss prover."""
    from alphagomoku_tpu_torch.search import mcts as TM
    from tests.test_torch_mcts import TORCH_CFG, boards_and_stm, torch_stub

    tables = TV.device_tables(GameRules.RENJU)
    assert tables.rules == GameRules.RENJU
    boards, stm = boards_and_stm()
    for cfg in (TORCH_CFG, TORCH_CFG._replace(leaf_solver="vcf"),
                TORCH_CFG._replace(leaf_solver="vct", loss_prover=True)):
        state = TM.run_search(torch_stub, None, tables, cfg, boards, stm, 2, device="cpu")
        assert bool((state.sims_done == 2).all())


def test_score_functions_match_jax_on_every_u16():
    s16 = np.arange(1 << 16, dtype=np.uint16)
    js = jnp.asarray(s16)
    ts = torch.from_numpy(s16.astype(np.int32))
    for name in ("neg", "invert_up", "invert_down", "increase_distance",
                 "get_distance", "get_eval", "get_pv"):
        a = np.asarray(getattr(JS, name)(js)).astype(np.int64)
        b = getattr(TS, name)(ts).numpy().astype(np.int64)
        assert np.array_equal(a, b), name
    for name in ("is_infinite", "is_finite", "is_proven", "is_win", "is_loss", "is_draw"):
        assert np.array_equal(np.asarray(getattr(JS, name)(js)), getattr(TS, name)(ts).numpy()), name
    assert np.array_equal(np.asarray(JS.convert_to_value(js)), TS.convert_to_value(ts).numpy())
    assert np.array_equal(
        np.asarray(JS.add_int(js, jnp.int32(-3))).astype(np.int64),
        TS.add_int(ts, -3).numpy().astype(np.int64),
    )
    for plys in (1, 2, 3, 17):
        assert int(JS.win_in(plys)) == TS.win_in(plys)
        assert int(JS.loss_in(plys)) == TS.loss_in(plys)
        assert int(JS.draw_in(plys)) == TS.draw_in(plys)
    assert int(JS.zero()) == TS.zero()
    for ev in (-4000, -17, 0, 3, 4000):
        assert int(JS.eval_score(ev)) == TS.eval_score(ev)
    wd = np.random.default_rng(0).dirichlet(np.ones(3), size=16)[:, :2].astype(np.float32)
    for name in ("value_expectation", "value_invert"):
        a = np.asarray(getattr(JS, name)(jnp.asarray(wd)))
        assert np.allclose(a, getattr(TS, name)(torch.from_numpy(wd)).numpy(), rtol=1e-6), name
    outcome = np.repeat(np.arange(4, dtype=np.int8), 2)
    stm = np.tile(np.array([1, 2], np.int8), 4)
    for dist in (0, 5):
        a = np.asarray(JS.from_outcome(jnp.asarray(outcome), jnp.asarray(stm), dist))
        b = TS.from_outcome(torch.from_numpy(outcome), torch.from_numpy(stm), dist)
        assert np.array_equal(a.astype(np.int64), b.numpy().astype(np.int64))
    assert int(GameOutcome.UNKNOWN) == 0


def test_full_hash_matches_jax():
    boards, rng = _boards(30, n=16)
    stm = rng.integers(1, 3, size=boards.shape[0]).astype(np.int8)
    jh = JZ.full_hash(JZ.make_table(15, 15), jnp.asarray(boards), jnp.asarray(stm))
    th = TZ.full_hash(torch.from_numpy(boards), torch.from_numpy(stm))
    assert np.array_equal(np.asarray(jh).astype(np.int64), th.numpy())
    small, _ = _boards(31, n=5, h=7, w=9)
    jh = JZ.full_hash(JZ.make_table(7, 9), jnp.asarray(small), jnp.asarray(stm[:5]))
    th = TZ.full_hash(torch.from_numpy(small), torch.from_numpy(stm[:5]))
    assert np.array_equal(np.asarray(jh).astype(np.int64), th.numpy())


@pytest.mark.parametrize("rules", [GameRules.FREESTYLE, GameRules.CARO5])
def test_static_analyze_matches_jax(rules):
    boards, rng = _boards(40 + int(rules), n=48)
    stm = rng.integers(1, 3, size=boards.shape[0]).astype(np.int8)
    dtd = rng.integers(1, 5, size=boards.shape[0]).astype(np.int32)
    jp = JF.encode(_jax_tables(rules), jnp.asarray(boards), jnp.asarray(stm))
    legal = (jp & 1) == 1
    tp = TF.encode(TV.device_tables(rules), torch.from_numpy(boards), torch.from_numpy(stm))
    tlegal = (tp & 1) == 1
    for jd, td in ((None, None), (jnp.asarray(dtd), torch.from_numpy(dtd))):
        ja = JSS.analyze(jp, legal, jd)
        ta = TSS.analyze(tp, tlegal, td)
        assert np.array_equal(np.asarray(ja.action_scores).astype(np.int64),
                              ta.action_scores.numpy().astype(np.int64))
        assert np.array_equal(np.asarray(ja.restrict), ta.restrict.numpy())
        assert np.array_equal(np.asarray(ja.node_score).astype(np.int64),
                              ta.node_score.numpy().astype(np.int64))
    # the positions exercise the proven stages
    assert (TS.is_proven(ta.node_score)).any()
