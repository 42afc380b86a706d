"""The port's run_search held against the JAX package's, array for array,
with one deterministic stub network fed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.game import vectorized as JV
from alphagomoku_tpu.game.types import GameRules, CROSS, CIRCLE
from alphagomoku_tpu.models.networks import NetOutput as JaxNetOutput
from alphagomoku_tpu.search import mcts as JM

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.models.networks import NetOutput
from alphagomoku_tpu_torch.search import mcts as TM

torch.set_num_threads(1)

H = W = 15
SIMS = 32
JAX_CFG = JM.MCTSConfig(max_nodes=40, max_edges=8, max_depth=8)
TORCH_CFG = TM.MCTSConfig(max_nodes=40, max_edges=8, max_depth=8)

# stub network: per-cell policy logits on a 0.25 grid (many exact ties,
# and no two distinct logits closer than 0.25, so an ulp of difference in
# exp cannot reorder edges), plus a row-occupancy term; value logits from
# a fixed weighting of the stones in multiples of 1/8 (exact in f32)
_BASE = ((np.random.default_rng(7).permutation(H * W) % 24) * 0.25).reshape(H, W)
_BASE = _BASE.astype(np.float32)
_WV = (np.random.default_rng(8).integers(-4, 5, size=(H, W)) / 8.0).astype(np.float32)


def jax_stub(_, planes):
    p = planes.astype(jnp.float32)
    stones = p[..., 1] + p[..., 2]
    rows = stones.sum(2, keepdims=True)
    s = (p[..., 1] * _WV).sum((1, 2)) - (p[..., 2] * _WV).sum((1, 2))
    return JaxNetOutput(
        policy_logits=_BASE[None] + 0.25 * rows,
        value_logits=jnp.stack([s, jnp.zeros_like(s), -s], -1),
        q_logits=None, moves_left_logits=None, soft_policy_logits=None,
    )


def torch_stub(_, planes):
    p = planes.float()
    stones = p[..., 1] + p[..., 2]
    rows = stones.sum(2, keepdim=True)
    wv = torch.from_numpy(_WV)
    s = (p[..., 1] * wv).sum((1, 2)) - (p[..., 2] * wv).sum((1, 2))
    return NetOutput(
        policy_logits=torch.from_numpy(_BASE)[None] + 0.25 * rows,
        value_logits=torch.stack([s, torch.zeros_like(s), -s], -1),
        q_logits=None, moves_left_logits=None, soft_policy_logits=None,
    )


def boards_and_stm():
    """An opening from the bench generator, an open three for CROSS with
    CIRCLE to move, a dense random middle game, and a five-free full board
    with seven cells left, where K = 8 edges make nodes complete and the
    minimax proves losses and draws."""
    rng = np.random.default_rng(0)
    boards = np.zeros((4, H, W), np.int8)
    n = rng.integers(2, 8)
    cells = rng.choice(H * W, size=n, replace=False)
    boards[0].flat[cells] = np.where(np.arange(n) % 2 == 0, CROSS, CIRCLE)
    boards[1, 7, 5:8] = CROSS
    boards[1, 9, 6:8] = CIRCLE
    cells = rng.choice(H * W, size=30, replace=False)
    boards[2].flat[cells] = np.where(np.arange(30) % 2 == 0, CROSS, CIRCLE)
    r, c = np.mgrid[:H, :W]
    boards[3] = np.where((c + 2 * r) % 4 < 2, CROSS, CIRCLE)
    boards[3, 7, 4:11] = 0
    stm = np.array([CROSS, CIRCLE, CROSS, CROSS], np.int8)
    return boards, stm


EXACT = ("node_visits", "node_count", "edge_action", "edge_child", "node_score",
         "edge_score", "node_hash", "node_complete")
CLOSE = ("node_value_sum", "edge_prior")


def check_stub_search(rules):
    """Both packages' run_search with the stub network: the trees must be
    equal array for array (values and priors within 1e-5 relative)."""
    boards, stm = boards_and_stm()
    jtables = JV.RuleTables(pattern=None, threat=None, rules=int(rules))
    search = jax.jit(lambda b, s: JM.run_search(jax_stub, None, jtables, JAX_CFG, b, s, SIMS))
    js = search(jnp.asarray(boards), jnp.asarray(stm))
    ts = TM.run_search(
        torch_stub, None, TV.device_tables(rules), TORCH_CFG, boards, stm, SIMS, device="cpu"
    )
    for name in EXACT:
        a = np.asarray(getattr(js.tree, name)).astype(np.int64)
        b = getattr(ts.tree, name).numpy().astype(np.int64)
        assert np.array_equal(a, b), name
    for name in CLOSE:
        a = np.asarray(getattr(js.tree, name), np.float32)
        b = getattr(ts.tree, name).float().numpy()
        assert np.allclose(a, b, rtol=1e-5, atol=0), name
    for name, a in ts.stats._asdict().items():
        assert np.array_equal(np.asarray(getattr(js.stats, name)), a.numpy()), name
    assert np.array_equal(np.asarray(JM.select_move(js)), TM.select_move(ts).numpy())
    assert np.allclose(np.asarray(JM.root_value(js)), TM.root_value(ts).numpy(), rtol=1e-5)
    assert np.allclose(
        np.asarray(JM.root_visit_distribution(js)), TM.root_visit_distribution(ts).numpy(),
        rtol=1e-6,
    )
    # the searches went through expansion, transpositions and proofs
    assert int(ts.stats.expansions.sum()) > 0
    assert int(ts.stats.transpositions.sum()) > 0
    assert TM.S.is_proven(ts.tree.edge_score).any()
    assert TM.S.is_loss(ts.tree.edge_score).any() or TM.S.is_draw(ts.tree.node_score).any()


def test_stub_search_matches_jax_freestyle():
    check_stub_search(GameRules.FREESTYLE)


def test_unported_config_raises():
    boards, stm = boards_and_stm()
    tables = TV.device_tables(GameRules.FREESTYLE)
    for cfg in (TORCH_CFG._replace(policy="ucb"), TORCH_CFG._replace(leaf_batch=2),
                TORCH_CFG._replace(leaf_solver="vct")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TM.run_search(torch_stub, None, tables, cfg, boards, stm, 1, device="cpu")


def test_select_move_samples_root_edges_by_visits():
    """Temperature sampling draws from a torch.Generator: the same seed
    gives the same moves, and only visited root edges are drawn (on roots
    where the search visited any)."""
    boards, stm = boards_and_stm()
    tables = TV.device_tables(GameRules.FREESTYLE)
    ts = TM.run_search(torch_stub, None, tables, TORCH_CFG, boards, stm, SIMS, device="cpu")
    rb = torch.arange(len(boards))
    visits = TM.edge_stats(ts.tree, rb, ts.root_node).visits
    actions = ts.tree.edge_action[rb, ts.root_node].long()
    allowed = torch.where((visits > 0).any(-1, keepdim=True), visits > 0, actions != TM.NULL)
    gen = torch.Generator().manual_seed(0)
    for _ in range(8):
        move = TM.select_move(ts, gen, temperature=1.0)
        assert ((actions == move[:, None]) & allowed).any(-1).all()
    same = [TM.select_move(ts, torch.Generator().manual_seed(1), 1.0) for _ in range(2)]
    assert torch.equal(same[0], same[1])
