"""The port's run_search held against the JAX package's, array for array,
with one deterministic stub network fed to both.  Freestyle is compared
live here; the other rules and the leaf-solver search compare against
goldens of the same JAX computation (`jax_stub_search`, tests/torch_golden)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.game import vectorized as JV
from alphagomoku_tpu.game.types import GameRules, CROSS, CIRCLE
from alphagomoku_tpu.models.networks import NetOutput as JaxNetOutput
from alphagomoku_tpu.patterns import tables as JT
from alphagomoku_tpu.search import mcts as JM

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.models.networks import NetOutput
from alphagomoku_tpu_torch.search import mcts as TM
from tests import torch_golden

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


def _results(state, search, to_np) -> dict:
    """The arrays a stub search is compared on: the tree, the statistics
    and the three result readers."""
    out = {f"tree.{n}": to_np(getattr(state.tree, n)).astype(np.int64) for n in EXACT}
    out.update({f"tree.{n}": to_np(getattr(state.tree, n)).astype(np.float32) for n in CLOSE})
    out.update({f"stats.{n}": to_np(v) for n, v in state.stats._asdict().items()})
    out["select_move"] = to_np(search.select_move(state))
    out["root_value"] = to_np(search.root_value(state))
    out["root_visit_distribution"] = to_np(search.root_visit_distribution(state))
    return out


def jax_stub_search(rules, positions=None, **cfg) -> dict:
    """The JAX package's run_search with the stub network (the reference
    side of the stub tests and of their goldens) on `positions` (boards,
    stm), by default `boards_and_stm()`."""
    boards, stm = positions or boards_and_stm()
    # the batched paths classify by bit math: only the threat table is read
    jtables = JV.RuleTables(pattern=None, threat=jnp.asarray(JT._build_threat_table(rules)),
                            rules=int(rules))
    jcfg = JAX_CFG._replace(**cfg)
    search = jax.jit(lambda b, s: JM.run_search(jax_stub, None, jtables, jcfg, b, s, SIMS))
    js = search(jnp.asarray(boards), jnp.asarray(stm))
    return _results(js, JM, lambda a: np.asarray(a).astype(
        np.float32 if a.dtype == jnp.bfloat16 else a.dtype))


def check_stub_search(rules, golden: str | None = None, positions=None, **cfg):
    """The port's run_search with the stub network against the JAX
    package's (live, or its golden `golden`) on `positions`: the trees
    must be equal array for array (values and priors within 1e-5
    relative)."""
    ref = (jax_stub_search(rules, positions, **cfg) if golden is None
           else torch_golden.load(golden))
    boards, stm = positions or boards_and_stm()
    ts = TM.run_search(
        torch_stub, None, TV.device_tables(rules), TORCH_CFG._replace(**cfg), boards,
        stm, SIMS, device="cpu",
    )
    ours = _results(ts, TM, lambda t: t.float().numpy() if t.is_floating_point() else t.numpy())
    assert sorted(ours) == sorted(ref)
    for name, a in ref.items():
        b = ours[name]
        if name.startswith("tree.") and name[5:] in CLOSE:
            assert np.allclose(a, b, rtol=1e-5, atol=0), name
        elif name == "root_value":
            assert np.allclose(a, b, rtol=1e-5), name
        elif name == "root_visit_distribution":
            assert np.allclose(a, b, rtol=1e-6), name
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name
    # the searches went through expansion, transpositions and proofs
    assert int(ts.stats.expansions.sum()) > 0
    assert int(ts.stats.transpositions.sum()) > 0
    assert TM.S.is_proven(ts.tree.edge_score).any()
    assert TM.S.is_loss(ts.tree.edge_score).any() or TM.S.is_draw(ts.tree.node_score).any()
    return ts


def test_stub_search_matches_jax_freestyle():
    check_stub_search(GameRules.FREESTYLE)


def test_unported_config_raises():
    """Options outside the ported slice raise naming ROADMAP.md item 10:
    another policy, leaf_batch > 1, root noise, symmetry averaging; and a
    trunk width the kernel has no layout for.  The VCF and VCT leaf
    solvers and the loss prover run."""
    boards, stm = boards_and_stm()
    tables = TV.device_tables(GameRules.FREESTYLE)
    for cfg in (TORCH_CFG._replace(policy="ucb"), TORCH_CFG._replace(leaf_batch=2),
                TORCH_CFG._replace(noise_weight=0.25),
                TORCH_CFG._replace(symmetry_averaging=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 10"):
            TM.run_search(torch_stub, None, tables, cfg, boards, stm, 1, device="cpu")
    for solver in ("vct", "vcf"):
        TM.run_search(torch_stub, None, tables,
                      TORCH_CFG._replace(leaf_solver=solver, loss_prover=True), boards, stm, 1,
                      device="cpu")
    from alphagomoku_tpu_torch.ops import convnext_fused as CF

    x = torch.zeros((1, 15, 15, 256), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CF.fused_trunk(x.to("meta"), None)


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
