"""The rest of search in the port held against the JAX package, on the
CPU: every in-tree policy and `init_to` mode, `leaf_batch` 2 and 4 (with
transpositions, with the VCT leaf solver, at 81 edge slots, and in a tree
that fills up), a root move mask and the NNUE leaf blend.

The searches are 9x9, B = 2, 16 simulations with a stub network that has a
q head; the JAX side of each is a golden (`options_*`, `jax_options_search`),
and the trees must be equal array for array (values, priors and the q-head
rows within 1e-5 relative).  Live: `_hash_uniform` and the generator masks
bit-equal, `_fit_kl`, every policy's edge utility (with virtual visits, at
and below the root) and the tree policy's features, MLP and train step
within 2e-6 relative, and `dedup_claims` bit-equal to the JAX package's
rule on random claims with ties and no-change claims.
"""

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.game.types import CIRCLE, CROSS, GameRules
from alphagomoku_tpu_torch.models.convert import tree_policy_from_jax
from alphagomoku_tpu_torch.models.networks import NetOutput
from alphagomoku_tpu_torch.ops import score_scan as SSM
from alphagomoku_tpu_torch.search import generators as TG
from alphagomoku_tpu_torch.search import mcts as TM
from alphagomoku_tpu_torch.search import tree_policy as TTP
from tests import torch_golden

torch.set_num_threads(1)

H = W = 9
SIMS = 16
BASE = dict(max_nodes=24, max_edges=4, max_depth=8)
REL = 2e-6  # f32 utilities, _fit_kl and the tree policy's MLP

# stub network: policy logits on a 0.75 grid plus a row-occupancy term (as
# tests/test_torch_mcts.py's), value logits from a stone weighting in
# multiples of 1/8, q logits on a 0.25 grid minus a row term
_rng = np.random.default_rng
_BASE = ((_rng(11).permutation(H * W) % 12) * 0.75).reshape(H, W).astype(np.float32)
_WV = (_rng(12).integers(-4, 5, size=(H, W)) / 8.0).astype(np.float32)
_QB = ((_rng(13).permutation(H * W) % 8) * 0.25).reshape(H, W).astype(np.float32)


def jax_stub(_, planes):
    import jax.numpy as jnp
    from alphagomoku_tpu.models.networks import NetOutput as JaxNetOutput

    p = planes.astype(jnp.float32)
    stones = p[..., 1] + p[..., 2]
    rows = stones.sum(2, keepdims=True)
    s = (p[..., 1] * _WV).sum((1, 2)) - (p[..., 2] * _WV).sum((1, 2))
    qw = _QB[None] - 0.125 * rows
    return JaxNetOutput(
        policy_logits=_BASE[None] + 0.25 * rows,
        value_logits=jnp.stack([s, jnp.zeros_like(s), -s], -1),
        q_logits=jnp.stack([qw, jnp.zeros_like(qw), -qw], -1),
        moves_left_logits=None, soft_policy_logits=None,
    )


def torch_stub(_, planes):
    p = planes.float()
    stones = p[..., 1] + p[..., 2]
    rows = stones.sum(2, keepdim=True)
    wv = torch.from_numpy(_WV)
    s = (p[..., 1] * wv).sum((1, 2)) - (p[..., 2] * wv).sum((1, 2))
    qw = torch.from_numpy(_QB)[None] - 0.125 * rows
    return NetOutput(
        policy_logits=torch.from_numpy(_BASE)[None] + 0.25 * rows,
        value_logits=torch.stack([s, torch.zeros_like(s), -s], -1),
        q_logits=torch.stack([qw, torch.zeros_like(qw), -qw], -1),
        moves_left_logits=None, soft_policy_logits=None,
    )


def positions():
    """A sparse opening, and a middle game where CIRCLE has a four that
    CROSS (to move) must block, its one root edge (so the step's later
    descents duplicate the first one's expansion), and CROSS an open
    three; CROSS to move on both."""
    rng = _rng(5)
    boards = np.zeros((2, H, W), np.int8)
    boards[1, 2, 2:6] = CIRCLE
    boards[1, 2, 1] = CROSS
    boards[1, 5, 3:6] = CROSS
    free = np.flatnonzero(boards[1].ravel() == 0)
    for b, n in ((0, 6), (1, 12)):
        cells = rng.choice(free if b else np.arange(H * W), size=n, replace=False)
        boards[b].flat[cells] = np.where(np.arange(n) % 2 == 0, CROSS, CIRCLE)
    return boards, np.array([CROSS, CROSS], np.int8)


def tp_arrays() -> dict:
    """Seeded tree-policy weights (He-normal, zero biases, as the JAX
    initialiser draws them), numpy."""
    rng = _rng(21)
    dense = lambda i, o: (rng.standard_normal((i, o)) * np.sqrt(2.0 / i)).astype(np.float32)
    return dict(w1=dense(8, 64), b1=np.zeros(64, np.float32), w2=dense(64, 64),
                b2=np.zeros(64, np.float32), w3=dense(64, 1), b3=np.zeros(1, np.float32))


def nnue_variables(hidden: int = 8) -> dict:
    """Seeded f32 NNUE weights in the flax layout, numpy."""
    rng = _rng(22)
    f = 1 + H * W * 16
    dims = ((f, hidden), (hidden, hidden), (hidden, 3))
    return {"params": {f"Dense_{i}": {
        "kernel": (rng.standard_normal(d) / np.sqrt(d[0])).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(d[1])).astype(np.float32)}
        for i, d in enumerate(dims)}}


def root_mask() -> np.ndarray:
    from alphagomoku_tpu.search import generators as JG

    return np.asarray(JG.center_excluding_mask(2, H, W, 1))


# golden name -> (MCTSConfig overrides, extras: "tp", "nnue", "mask")
CASES = {
    **{f"options_policy_{p}": (dict(policy=p), ()) for p in TM.POLICIES if p != "puct"},
    **{f"options_init_{m}": (dict(init_to=m), ()) for m in ("loss", "draw", "q_head")},
    "options_leaf_batch2": (dict(leaf_batch=2), ()),
    "options_leaf_batch4": (dict(leaf_batch=4), ()),
    "options_leaf_batch4_vct": (dict(leaf_batch=4, leaf_solver="vct"), ()),
    "options_leaf_batch4_k81": (dict(leaf_batch=4, max_edges=H * W), ()),
    "options_leaf_batch4_learnable": (dict(leaf_batch=4, policy="learnable"), ("tp",)),
    # 11 nodes: the third step's block is clamped into live rows, later
    # steps allocate nothing
    "options_leaf_batch4_full": (dict(leaf_batch=4, max_nodes=11), ()),
    "options_root_mask": (dict(), ("mask",)),
    "options_nnue": (dict(), ("nnue",)),
}
CASES["options_policy_learnable"] = (dict(policy="learnable"), ("tp",))

EXACT = ("node_visits", "node_count", "edge_action", "edge_child", "node_score",
         "edge_score", "node_hash", "node_complete")
CLOSE = ("node_value_sum", "edge_prior", "edge_q_init")


def _results(state, search, to_np) -> dict:
    out = {f"tree.{n}": to_np(getattr(state.tree, n)).astype(np.int64) for n in EXACT}
    out.update({f"tree.{n}": to_np(getattr(state.tree, n)).astype(np.float32) for n in CLOSE})
    out.update({f"stats.{n}": to_np(v) for n, v in state.stats._asdict().items()})
    out["select_move"] = to_np(search.select_move(state))
    out["root_value"] = to_np(search.root_value(state))
    out["root_visit_distribution"] = to_np(search.root_visit_distribution(state))
    return out


def jax_options_search(name: str) -> dict:
    """The JAX package's run_search of case `name` (the golden)."""
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.models import nnue as JN
    from alphagomoku_tpu.search import mcts as JM
    from alphagomoku_tpu.search import tree_policy as JTP
    from tests.test_torch_mcts import jax_tables

    over, extras = CASES[name]
    cfg = JM.MCTSConfig(**BASE)._replace(**over)
    kw = {}
    if "tp" in extras:
        kw["tp_params"] = JTP.TreePolicyParams(**{k: jnp.asarray(v) for k, v in tp_arrays().items()})
    if "nnue" in extras:
        kw["nnue"] = JN.quantize(nnue_variables())
    if "mask" in extras:
        kw["root_move_mask"] = jnp.asarray(root_mask())
    boards, stm = positions()
    tables = jax_tables(GameRules.FREESTYLE)
    search = jax.jit(lambda b, s: JM.run_search(jax_stub, None, tables, cfg, b, s, SIMS, **kw))
    state = search(jnp.asarray(boards), jnp.asarray(stm))
    return _results(state, JM, lambda a: np.asarray(a).astype(
        np.float32 if a.dtype == jnp.bfloat16 else a.dtype))


def torch_options_search(name: str):
    from alphagomoku_tpu_torch.models import nnue as TN

    over, extras = CASES[name]
    cfg = TM.MCTSConfig(**BASE)._replace(**over)
    kw = {}
    if "tp" in extras:
        kw["tp_params"] = TTP.TreePolicyParams(**{k: torch.from_numpy(v) for k, v in
                                                  tp_arrays().items()})
    if "nnue" in extras:
        kw["nnue"] = TN.quantize(nnue_variables()).to("cpu")
    if "mask" in extras:
        kw["root_move_mask"] = TG.center_excluding_mask(2, H, W, 1)
    boards, stm = positions()
    return TM.run_search(torch_stub, None, TV.device_tables(GameRules.FREESTYLE), cfg, boards,
                         stm, SIMS, device="cpu", **kw)


def compare(ref: dict, state) -> None:
    ours = _results(state, TM, lambda t: t.float().numpy() if t.is_floating_point() else t.numpy())
    assert sorted(ours) == sorted(ref)
    for key, a in ref.items():
        b = ours[key]
        if key.startswith("tree.") and key[5:] in CLOSE or key == "root_value":
            assert np.allclose(a, b, rtol=1e-5, atol=0), key
        elif key == "root_visit_distribution":
            assert np.allclose(a, b, rtol=1e-6), key
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), key


@pytest.mark.parametrize("name", sorted(CASES))
def test_search_matches_jax(name):
    state = torch_options_search(name)
    compare(torch_golden.load(name), state)
    over, extras = CASES[name]
    sims = int(state.sims_done[0])
    assert sims == SIMS and int(state.tree.node_visits[0, 0]) <= 1 + SIMS
    stats = state.stats.summary(state.sims_done)
    if over.get("leaf_batch", 1) > 1:
        # the step deduplicated claims on one edge and linked transpositions
        assert stats["duplicates"] > 0 or stats["transpositions"] > 0
    if "mask" in extras:
        actions = state.tree.edge_action[:, 0]
        allowed = torch.from_numpy(root_mask()).flatten(1)
        assert bool(allowed.gather(1, actions.clamp(min=0).long())[actions >= 0].all())


def test_leaf_batch_launches_score_scan_once_a_step():
    """At leaf_batch 4 backup B goes through score_backup_paths: one
    score_scan call a step, no score_backup; at leaf_batch 1 the reverse."""
    SSM.score_scan.launches = SSM.score_backup.launches = 0
    calls = {"scan": 0, "backup": 0}
    scan, backup = SSM.score_scan, TM.score_backup

    def counting_scan(*a):
        calls["scan"] += 1
        return scan(*a)

    def counting_backup(*a):
        calls["backup"] += 1
        return backup(*a)

    SSM.score_scan, TM.score_backup = counting_scan, counting_backup
    try:
        boards, stm = positions()
        tables = TV.device_tables(GameRules.FREESTYLE)
        TM.run_search(torch_stub, None, tables, TM.MCTSConfig(**BASE, leaf_batch=4), boards,
                      stm, SIMS, device="cpu")
        assert calls == {"scan": SIMS // 4, "backup": 0}
        TM.run_search(torch_stub, None, tables, TM.MCTSConfig(**BASE), boards, stm, 4,
                      device="cpu")
        assert calls == {"scan": SIMS // 4, "backup": 4}
    finally:
        SSM.score_scan, TM.score_backup = scan, backup


def test_check_config_names():
    for bad in (dict(policy="uct"), dict(init_to="zero")):
        with pytest.raises(ValueError, match="is not one of"):
            TM.check_config(TM.MCTSConfig(**bad))
    for policy in TM.POLICIES:
        for init_to in TM.INIT_TO:
            TM.check_config(TM.MCTSConfig(policy=policy, init_to=init_to, leaf_batch=3))


# ---------------------------------------------------------------------------
# live: the utility's pieces
# ---------------------------------------------------------------------------


def test_hash_uniform_bit_equal():
    import jax.numpy as jnp
    from alphagomoku_tpu.search import mcts as JM

    rng = _rng(5)
    a = rng.integers(0, 2**31 - 1, size=(64, 1), dtype=np.int32)
    b = rng.integers(-2**31, 2**31 - 1, size=(1, 40), dtype=np.int64).astype(np.int32)
    c = rng.integers(0, 5000, size=(64, 1), dtype=np.int32)
    want = np.asarray(JM._hash_uniform(*(jnp.asarray(x) + jnp.zeros((64, 40), jnp.int32)
                                         for x in (a, b, c))))
    got = TM._hash_uniform(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    assert want.dtype == got.dtype == np.float32
    assert np.array_equal(want, got)


def test_fit_kl_within_tolerance():
    """Within 2e-6 relative of the JAX package's for t >= 1e-3: a search
    reads t = log(N) / n >= log(N) / N, which stays above 1e-3 up to N =
    9,000 visits of one node.  As t goes to 0 the root q -> p turns double,
    Newton converges only as far as the rounding of the logs lets it, and
    two libraries' logs stop it at different points: at t = 1e-4 and 0 the
    two lie within 2e-4 of each other (and of p at t = 0)."""
    import jax.numpy as jnp
    from alphagomoku_tpu.search import mcts as JM

    rng = _rng(6)
    p = np.concatenate([rng.random(200), [0.0, 1.0, 0.5, 0.5]]).astype(np.float32)
    t = np.concatenate([1e-3 + rng.random(200) * 3, [0.1, 0.2, 1e-3, 1e-2]]).astype(np.float32)
    want = np.asarray(JM._fit_kl(jnp.asarray(p), jnp.asarray(t)))
    got = TM._fit_kl(torch.from_numpy(p), torch.from_numpy(t)).numpy()
    assert np.allclose(got, want, rtol=REL, atol=0)
    p0 = np.array([0.5, 0.2, 0.9, 0.3, 0.7], np.float32)
    t0 = np.array([0.0, 0.0, 0.0, 1e-4, 1e-4], np.float32)
    want = np.asarray(JM._fit_kl(jnp.asarray(p0), jnp.asarray(t0)))
    got = TM._fit_kl(torch.from_numpy(p0), torch.from_numpy(t0)).numpy()
    assert np.abs(got - want).max() < 2e-4
    assert np.abs(got - p0)[:3].max() < 2e-4 and np.abs(want - p0)[:3].max() < 2e-4


def _jax_tree(tree):
    """The port's tree as the JAX package's Tree (same values)."""
    import jax.numpy as jnp
    from alphagomoku_tpu.search import mcts as JM

    t = {n: getattr(tree, n) for n in tree._fields}
    return JM.Tree(
        node_visits=jnp.asarray(t["node_visits"].numpy()),
        node_value_sum=jnp.asarray(t["node_value_sum"].numpy()),
        node_score=jnp.asarray(t["node_score"].numpy().astype(np.uint16)),
        node_moves_left_sum=jnp.asarray(t["node_moves_left_sum"].numpy()),
        node_complete=jnp.asarray(t["node_complete"].numpy()),
        edge_action=jnp.asarray(t["edge_action"].numpy().astype(np.int16)),
        edge_child=jnp.asarray(t["edge_child"].numpy().astype(np.int16)),
        edge_prior=jnp.asarray(t["edge_prior"].float().numpy()).astype(jnp.bfloat16),
        edge_score=jnp.asarray(t["edge_score"].numpy().astype(np.uint16)),
        edge_q_init=jnp.asarray(t["edge_q_init"].float().numpy()).astype(jnp.bfloat16),
        node_hash=jnp.asarray(t["node_hash"].numpy().astype(np.uint32)),
        node_count=jnp.asarray(t["node_count"].numpy()),
    )


@pytest.fixture(scope="module")
def searched_tree():
    """A 16-sim tree (policy puct, init q_head), two boards; for the
    utility checks, rows of visited nodes."""
    return torch_options_search("options_init_q_head")


@pytest.mark.parametrize("policy", TM.POLICIES)
@pytest.mark.parametrize("init_to", ("parent", "q_head"))
def test_edge_utility_matches_jax(searched_tree, policy, init_to):
    """Every policy's utility on the searched tree's visited nodes, with
    and without virtual visits, at and below the root: within 2e-6
    relative of the JAX package's (the same infinities), and the same
    argmax wherever the top two lie farther apart than that."""
    import jax.numpy as jnp
    from alphagomoku_tpu.search import mcts as JM
    from alphagomoku_tpu.search import tree_policy as JTP

    tree = searched_tree.tree
    jtree = _jax_tree(tree)
    tp = tp_arrays()
    ttp = TTP.TreePolicyParams(**{k: torch.from_numpy(v) for k, v in tp.items()})
    jtp = JTP.TreePolicyParams(**{k: jnp.asarray(v) for k, v in tp.items()})
    jcfg = JM.MCTSConfig(**BASE, policy=policy, init_to=init_to, exploration_scaling=0.5)
    tcfg = TM.MCTSConfig(**BASE, policy=policy, init_to=init_to, exploration_scaling=0.5)
    packed = TM.pack_node_stats(tree)
    rng = _rng(7)
    visited = [n for n in range(int(tree.node_count[0])) if
               bool((tree.node_visits[:, n] > 1).all())]
    assert len(visited) >= 3
    for node_id in visited:
        node = torch.full((2,), node_id, dtype=torch.int64)
        prior = tree.edge_prior[torch.arange(2), node].float()
        for vl in (None, rng.integers(0, 3, size=(2, BASE["max_edges"])).astype(np.int32)):
            is_root = np.array([node_id == 0, True])
            got = TM._edge_utility(tree, tcfg, node, prior,
                                   None if vl is None else torch.from_numpy(vl),
                                   torch.from_numpy(is_root), ttp, packed).numpy()
            want = np.asarray(JM._edge_utility(
                jtree, jcfg, jnp.asarray(node.numpy().astype(np.int32)), jnp.asarray(prior.numpy()),
                None if vl is None else jnp.asarray(vl), jnp.asarray(is_root), jtp,
                JM.pack_node_stats(jtree)))
            fin = np.isfinite(want)
            assert np.array_equal(fin, np.isfinite(got))
            assert np.allclose(got[fin], want[fin], rtol=REL, atol=REL), (node_id, vl)
            srt = np.sort(np.where(fin, want, -np.inf), -1)
            clear = srt[:, -1] - srt[:, -2] > REL * np.abs(srt[:, -1]) + REL
            assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_tree_policy_matches_jax(searched_tree):
    """edge_features, apply, training_batch_from_state and one train step
    within 2e-6 relative of the JAX package's, from the same seeded
    weights carried across by `tree_policy_from_jax`."""
    import jax.numpy as jnp
    from alphagomoku_tpu.search import mcts as JM
    from alphagomoku_tpu.search import tree_policy as JTP

    tp = tp_arrays()
    jtp = JTP.TreePolicyParams(**{k: jnp.asarray(v) for k, v in tp.items()})
    ttp = tree_policy_from_jax(jtp)
    assert all(torch.equal(a, torch.from_numpy(tp[k])) for k, a in ttp._asdict().items())
    state = searched_tree
    jstate = JM.SearchState(tree=_jax_tree(state.tree), root_board=None, root_stm=None,
                            root_node=jnp.zeros(2, jnp.int32), noisy_prior=None, sims_done=None,
                            stats=None)
    jf, jt, jv = JTP.training_batch_from_state(jstate)
    tf, tt, tv = TTP.training_batch_from_state(state)
    assert np.allclose(tf.numpy(), np.asarray(jf), rtol=REL, atol=1e-7)
    assert np.allclose(tt.numpy(), np.asarray(jt), rtol=REL, atol=0)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.allclose(TTP.apply(ttp, tf).numpy(), np.asarray(JTP.apply(jtp, jf)),
                       rtol=REL, atol=1e-6)
    jnew, jloss = JTP.make_train_step(0.05)(jtp, jf, jt, jv)
    tnew, tloss = TTP.make_train_step(0.05)(ttp, tf, tt, tv)
    assert abs(float(tloss) - float(jloss)) <= REL * abs(float(jloss))
    for a, b in zip(tnew, jnew):
        assert np.allclose(a.numpy(), np.asarray(b), rtol=REL, atol=1e-6)
    params = TTP.init_params(torch.Generator().manual_seed(0))
    assert params.w1.shape == (8, 64) and float(params.b3.abs().sum()) == 0.0


def test_generators_bit_equal():
    import jax.numpy as jnp
    from alphagomoku_tpu.search import generators as JG

    for rows, cols, radius in ((9, 9, 1), (15, 15, 2), (8, 10, 0)):
        assert np.array_equal(np.asarray(JG.center_excluding_mask(3, rows, cols, radius)),
                              TG.center_excluding_mask(3, rows, cols, radius).numpy())
        assert np.array_equal(np.asarray(JG.center_only_mask(3, rows, cols, radius)),
                              TG.center_only_mask(3, rows, cols, radius).numpy())
    boards = np.zeros((5, 9, 9), np.int8)
    boards[1, 4, 4] = CROSS
    boards[2, 4, 4], boards[2, 3, 3] = CROSS, CIRCLE
    boards[3, 4, 3], boards[3, 4, 5] = CROSS, CIRCLE
    boards[4] = _rng(9).choice([0, 1, 2], size=(9, 9), p=[0.8, 0.1, 0.1])
    rect = np.zeros((2, 8, 10), np.int8)
    rect[1, 3, 4] = CROSS
    for b in (boards, rect):
        want = np.asarray(JG.symmetrical_excluding_mask(jnp.asarray(b)))
        assert np.array_equal(want, TG.symmetrical_excluding_mask(torch.from_numpy(b)).numpy())
    # the empty board keeps one cell of each of the 15 orbits of 9x9
    assert int(TG.symmetrical_excluding_mask(torch.from_numpy(boards))[0].sum()) == 15


def _jax_dedup(key_p, new_p, old_p, valid_all):
    """The JAX package's dedup_claims (`search/mcts.py:1458-1476`, a
    closure of its step), on the same arrays."""
    import jax.numpy as jnp

    P = key_p.shape[1]
    changes = (new_p != old_p) & valid_all
    rankv = new_p.astype(jnp.int32) + (changes.astype(jnp.int32) << 17)
    p_iota = jnp.arange(P, dtype=jnp.int32)
    same = (key_p[:, :, None] == key_p[:, None, :]) & valid_all[:, None, :]
    beats = (rankv[:, None, :] > rankv[:, :, None]) | (
        (rankv[:, None, :] == rankv[:, :, None]) & (p_iota[None, None, :] < p_iota[None, :, None]))
    win = valid_all & ~(same & beats).any(-1)
    return jnp.where(win & changes,
                     (new_p.astype(jnp.int32) - old_p.astype(jnp.int32)) & 0xFFFF, 0)


@pytest.mark.parametrize("seed", range(3))
def test_dedup_claims_bit_equal(seed):
    """Random claims over few keys (many ties; a third change nothing):
    the winners' deltas are the JAX package's (mod 2^16) and land once per
    key."""
    import jax.numpy as jnp

    rng = _rng(seed)
    B, P = 6, 48
    key = rng.integers(0, 6, size=(B, P)).astype(np.int32)
    old = rng.choice([0x4000 + 4000, 0x6000 + 3990, 0x2000 + 2, 40000], size=(B, P))
    new = np.where(rng.random((B, P)) < 0.33, old,
                   rng.choice([0x6000 + 3995, 0x2000 + 4, 0x0000 + 3, 65535], size=(B, P)))
    valid = rng.random((B, P)) < 0.8
    want = np.asarray(_jax_dedup(jnp.asarray(key), jnp.asarray(new.astype(np.uint16)),
                                 jnp.asarray(old.astype(np.uint16)), jnp.asarray(valid)))
    got = SSM.dedup_claims(*(torch.from_numpy(a) for a in
                             (key, new.astype(np.int32), old.astype(np.int32), valid))).numpy()
    assert np.array_equal(got & 0xFFFF, want)
    nonzero = got != 0
    for b in range(B):
        keys = key[b][nonzero[b]]
        assert len(keys) == len(set(keys.tolist()))
    assert nonzero.any() and (new != old).any()


def test_score_backup_paths_one_path_equals_score_backup():
    """With S = 1, score_backup_paths leaves the tree as score_backup does
    (a path visits a node at most once, so no claim is deduplicated)."""
    from tests.test_torch_score_backup import random_tree, to_torch

    tree = to_torch(random_tree(8, 40, 8, 12, 3))
    a = {k: v.clone() for k, v in tree.items()}
    b = {k: v.clone() for k, v in tree.items()}
    SSM.score_backup(*(a[k] for k in BACKUP_ARGS))
    b["pn"], b["ps"], b["start_score"] = b["pn"][:, None], b["ps"][:, None], b["start_score"][:, None]
    SSM.score_backup_paths(*(b[k] for k in BACKUP_ARGS))
    assert all(torch.equal(a[k], b[k]) for k in ("edge_score", "node_score"))
    assert not torch.equal(a["edge_score"], tree["edge_score"])


BACKUP_ARGS = ("edge_score", "edge_action", "node_complete", "node_score", "pn", "ps",
               "start_score")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [32, 81])
def test_score_backup_paths_kernel_matches_plain_on_card(K):
    """On the card, score_backup_paths launches score_scan once (the K <= 32
    kernel or the wide one) and leaves the trees as its CPU run does, on
    four random paths a board that share nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    from tests.test_torch_score_backup import random_tree, to_torch

    B, S_, D = 64, 4, 12
    tree = to_torch(random_tree(B * S_, 40, D, K, 11))
    cpu = {k: tree[k][:B].clone() for k in ("edge_score", "edge_action", "node_complete",
                                            "node_score")}
    cpu["pn"] = tree["pn"].reshape(B, S_, D) % 10
    cpu["ps"] = tree["ps"].reshape(B, S_, D)
    cpu["pn"] = torch.where(cpu["ps"] < 0, -1, cpu["pn"])
    cpu["start_score"] = tree["start_score"].reshape(B, S_)
    card = {k: v.to("cuda") for k, v in cpu.items()}
    before = SSM.score_scan.launches
    SSM.score_backup_paths(*(card[k] for k in BACKUP_ARGS))
    SSM.score_backup_paths(*(cpu[k] for k in BACKUP_ARGS))
    assert SSM.score_scan.launches == before + 1
    for k in ("edge_score", "node_score"):
        assert torch.equal(card[k].cpu(), cpu[k])


@pytest.mark.parametrize("temperature", [0.5, 1.1, 1.4, 2.0])
def test_topk_edges_with_expansion_temperature_matches_jax(temperature):
    """Edge generation under `policy_expansion_temperature` (tuned by
    EngineTuner): the JAX package's actions, and its priors within 1e-6
    relative, on policies full of exact ties (a row of equal priors must
    stay tied at every cell, wherever torch's float32 pow rounds a row's
    positions differently)."""
    import jax.numpy as jnp
    from alphagomoku_tpu.search import mcts as JM

    rng = _rng(8)
    B = 6
    logits = rng.choice([0.0, -1.0, -2.5, -1e4], size=(B, H * W)).astype(np.float32)
    policy = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    policy = policy.astype(np.float32).reshape(B, H, W)
    legal = rng.random((B, H, W)) < 0.9
    want = JM._topk_edges(jnp.asarray(policy), jnp.asarray(legal), 12, temperature)
    got = TM._topk_edges(torch.from_numpy(policy), torch.from_numpy(legal), 12, temperature)
    assert np.array_equal(np.asarray(want[0]), got[0].numpy())
    assert np.allclose(np.asarray(want[1]), got[1].numpy(), rtol=1e-6, atol=0)
    assert np.array_equal(np.asarray(want[2]), got[2].numpy())


@pytest.mark.parametrize("leaf_batch", [1, 4])
def test_profile_cutoff_ends_the_step_after_its_phase(leaf_batch):
    """`make_simulate_fn(profile_cutoff=)` (the JAX package's keyword for
    attributing a step's cost): the step advances sims_done by S and
    stops after the named phase: select and evaluate leave the tree as it
    was, expand allocates and links, credit may and backupA does add
    visits, and only the whole step runs backup B.  Another name raises
    ValueError."""
    boards, stm = positions()
    tables = TV.device_tables(GameRules.FREESTYLE)
    cfg = TM.MCTSConfig(**BASE, leaf_batch=leaf_batch)
    base = TM.run_search(torch_stub, None, tables, cfg, boards, stm, 8, device="cpu")
    visits = {}
    for cutoff in (*TM.PROFILE_CUTOFFS, None):
        state = TM.SearchState(*(
            type(x)(*(t.clone() for t in x)) if isinstance(x, tuple) else
            (x.clone() if torch.is_tensor(x) else x) for x in base))
        out = TM.make_simulate_fn(torch_stub, tables, cfg, profile_cutoff=cutoff)(None, state)
        assert torch.equal(out.sims_done, base.sims_done + leaf_batch)
        same = all(torch.equal(a, b) for a, b in zip(out.tree, base.tree))
        assert same == (cutoff in ("select", "evaluate")), cutoff
        visits[cutoff] = int(out.tree.node_visits.sum())
    assert visits["expand"] <= visits["credit"] < visits["backupA"] == visits[None]
    with pytest.raises(ValueError, match="profile_cutoff"):
        TM.make_simulate_fn(torch_stub, tables, cfg, profile_cutoff="solve")
