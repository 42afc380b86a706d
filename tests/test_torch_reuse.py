"""The port's `reuse_or_init_root`, and a search on the reused trees, held
against the JAX package's with the stub network of tests/test_torch_mcts.py
and JAX's Dirichlet root noise injected.

Two moves are played from a 16-sim search of `boards_and_stm()` (B = 4,
max_nodes 64, max_edges 8): at the first, lanes 0 and 1 play their best
move (reused: its child was expanded), lane 2 passes `prev_move = -1` and
lane 3 plays a root edge the search never expanded (both restart fresh);
16 more sims follow.  At the second every lane plays its best move with a
`reserve` that no tree can fit (all restart fresh), and 16 more sims
follow.  The trees after each search are compared as the stub searches
are (integers equal, values and priors within 1e-5 relative; the root
noise within 1e-5 relative, its renormalization's sum order being XLA's
on the JAX side).  The JAX side is the golden reuse_search."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphagomoku_tpu.game.types import GameRules
from alphagomoku_tpu.search import mcts as JM

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.search import mcts as TM
from tests import torch_golden
from tests.test_torch_mcts import (
    CLOSE, _results, boards_and_stm, jax_stub, jax_tables, torch_stub,
)

torch.set_num_threads(1)

SIMS = 16
CFG = dict(max_nodes=64, max_edges=8, max_depth=8, noise_weight=0.25, noise_alpha=0.1)
FITS, TOO_BIG = SIMS + 8, 48


def _play(boards, stm, moves):
    """Boards and sides to move after `moves` (flat cells)."""
    boards = boards.copy()
    for i, m in enumerate(moves):
        boards[i].flat[m] = stm[i]
    return boards, (3 - stm).astype(np.int8)


def _noise(key, batch, k):
    return np.array(jax.random.dirichlet(key, jnp.full((k,), CFG["noise_alpha"]), (batch,)))


def jax_reuse_search() -> dict:
    """The JAX side: the two reuses and their searches, the moves played
    and the noise drawn."""
    boards, stm = boards_and_stm()
    jt = jax_tables(GameRules.FREESTYLE)
    jcfg = JM.MCTSConfig(**CFG)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    simulate = JM.make_simulate_fn(jax_stub, jt, jcfg)

    @jax.jit
    def search_on(state):
        return jax.lax.scan(lambda s, _: (simulate(None, s), None), state, None, length=SIMS)[0]

    def reuse(state, prev, b, s, reserve, key):
        return jax.jit(lambda st, p, b_, s_: JM.reuse_or_init_root(
            jax_stub, None, jt, jcfg, st, p, b_, s_, reserve=reserve, noise_key=key))(
            state, jnp.asarray(prev), jnp.asarray(b), jnp.asarray(s))

    out = {}
    s0 = jax.jit(lambda b, s: JM.run_search(jax_stub, None, jt, jcfg, b, s, SIMS,
                                            noise_key=keys[0]))(jnp.asarray(boards),
                                                                jnp.asarray(stm))
    best = np.asarray(JM.select_move(s0))
    rb = np.arange(len(boards))
    child = np.asarray(s0.tree.edge_child)[rb, 0]
    actions = np.asarray(s0.tree.edge_action)[rb, 0].astype(np.int32)
    unexpanded = actions[3][(child[3] == -1) & (actions[3] != -1)][0]
    prev1 = np.array([best[0], best[1], -1, unexpanded], np.int32)
    b1, stm1 = _play(boards, stm, [best[0], best[1], best[2], unexpanded])
    r1 = reuse(s0, prev1, b1, stm1, FITS, keys[1])
    s1 = search_on(r1)
    prev2 = np.asarray(JM.select_move(s1)).astype(np.int32)
    b2, stm2 = _play(b1, stm1, prev2)
    r2 = reuse(s1, prev2, b2, stm2, TOO_BIG, keys[2])
    s2 = search_on(r2)
    to_np = lambda a: np.asarray(a).astype(np.float32 if a.dtype == jnp.bfloat16 else a.dtype)
    for tag, st in (("s0", s0), ("s1", s1), ("s2", s2)):
        out.update({f"{tag}.{k}": v for k, v in _results(st, JM, to_np).items()})
    for tag, st in (("r1", r1), ("r2", r2)):
        out[f"{tag}.root_node"] = np.asarray(st.root_node)
        out[f"{tag}.noisy_prior"] = np.asarray(st.noisy_prior)
    out.update(prev1=prev1, prev2=prev2, b1=b1, stm1=stm1, b2=b2, stm2=stm2)
    for i, key in enumerate(keys):
        out[f"noise{i}"] = _noise(key, len(boards), CFG["max_edges"])
    return out


def _compare(ref: dict, tag: str, state) -> None:
    ours = _results(state, TM, lambda t: t.float().numpy() if t.is_floating_point()
                    else t.numpy())
    for name, got in ours.items():
        want = ref[f"{tag}.{name}"]
        if name.startswith("tree.") and name[5:] in CLOSE or name.startswith("root_"):
            assert np.allclose(want, got, rtol=1e-5, atol=0), (tag, name)
        else:
            assert np.array_equal(want.astype(np.int64), got.astype(np.int64)), (tag, name)


def test_reuse_then_search_matches_jax():
    ref = torch_golden.load("reuse_search")
    boards, stm = boards_and_stm()
    tables = TV.device_tables(GameRules.FREESTYLE)
    tcfg = TM.MCTSConfig(**CFG)
    noise = [torch.from_numpy(ref[f"noise{i}"]) for i in range(3)]
    s0 = TM.run_search(torch_stub, None, tables, tcfg, boards, stm, SIMS, device="cpu",
                       noise=noise[0])
    _compare(ref, "s0", s0)
    states = [s0]
    for step, reserve in ((1, FITS), (2, TOO_BIG)):
        prev = torch.from_numpy(ref[f"prev{step}"])
        r = TM.reuse_or_init_root(torch_stub, None, tables, tcfg, states[-1], prev,
                                  ref[f"b{step}"], ref[f"stm{step}"], reserve,
                                  noise=noise[step])
        assert np.array_equal(r.root_node.numpy(), ref[f"r{step}.root_node"])
        assert np.allclose(r.noisy_prior.numpy(), ref[f"r{step}.noisy_prior"], rtol=1e-5, atol=0)
        assert r.frontier == int(r.tree.node_count.max())
        s = TM.simulate_n(torch_stub, None, tables, tcfg, r, SIMS)
        _compare(ref, f"s{step}", s)
        states.append(s)
    # lanes 0 and 1 reused, lane 2 (-1) and lane 3 (an unexpanded edge)
    # restarted; the second move's reserve fit no tree
    assert (ref["r1.root_node"] > 0).tolist() == [True, True, False, False]
    assert not ref["r2.root_node"].any()


def test_reuse_leaves_the_previous_tree_untouched():
    """The combined tree is new tensors: the previous search's tree, from
    which the sample was taken, is not modified by the reuse or by the
    search after it."""
    boards, stm = boards_and_stm()
    tables = TV.device_tables(GameRules.FREESTYLE)
    tcfg = TM.MCTSConfig(**CFG)
    s0 = TM.run_search(torch_stub, None, tables, tcfg, boards, stm, SIMS, device="cpu")
    before = [t.clone() for t in s0.tree]
    best = TM.select_move(s0)
    b1, stm1 = _play(boards, stm, best.tolist())
    r1 = TM.reuse_or_init_root(torch_stub, None, tables, tcfg, s0, best.int(), b1, stm1, FITS)
    assert (r1.root_node > 0).any()
    TM.simulate_n(torch_stub, None, tables, tcfg, r1, SIMS)
    assert all(torch.equal(a, b) for a, b in zip(before, s0.tree))
