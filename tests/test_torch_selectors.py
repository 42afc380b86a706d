"""The port's final-move selectors (`search/selectors.py`) held against the
JAX package's on the same trees: the stub-search goldens of
tests/torch_golden rebuilt as both packages' SearchStates, rooted at node 0
and at the most-visited child of it (as after tree reuse).  Every policy
must pick the same move on every board."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.search import mcts as JM
from alphagomoku_tpu.search import selectors as JS

from alphagomoku_tpu_torch.search import mcts as TM
from alphagomoku_tpu_torch.search import selectors as TS
from tests import torch_golden

torch.set_num_threads(1)

GOLDENS = ("stub_search_standard", "stub_search_caro5", "stub_search_vct", "stub_search_vcf",
           "stub_search_vct_loss", "stub_search_renju", "stub_search_draw_after")
POLICIES = ("best", "max_balance", "max_visit", "min_visit", "max_value", "max_policy", "lcb",
            "balanced")
H = W = 15


def _roots(g: dict, reused: bool) -> np.ndarray:
    """Node 0, or the most-visited expanded child of node 0 (node 0 where
    no child was expanded)."""
    if not reused:
        return np.zeros(len(g["tree.node_count"]), np.int64)
    child = g["tree.edge_child"][:, 0]
    visits = np.where(child >= 0, np.take_along_axis(g["tree.node_visits"],
                                                      np.clip(child, 0, None), 1), -1)
    best = child[np.arange(len(child)), visits.argmax(-1)]
    return np.where(visits.max(-1) > 0, best, 0)


def jax_state(g: dict, root: np.ndarray) -> JM.SearchState:
    b, n, k = g["tree.edge_action"].shape
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    tree = JM.Tree(
        node_visits=jnp.asarray(g["tree.node_visits"], jnp.int32),
        node_value_sum=f32(g["tree.node_value_sum"]),
        node_score=jnp.asarray(g["tree.node_score"], jnp.uint16),
        node_moves_left_sum=jnp.zeros((b, n), jnp.float32),
        node_complete=jnp.asarray(g["tree.node_complete"], bool),
        edge_action=jnp.asarray(g["tree.edge_action"], jnp.int16),
        edge_child=jnp.asarray(g["tree.edge_child"], jnp.int16),
        edge_prior=jnp.asarray(g["tree.edge_prior"], jnp.bfloat16),
        edge_score=jnp.asarray(g["tree.edge_score"], jnp.uint16),
        edge_q_init=jnp.zeros((b, n, k), jnp.bfloat16),
        node_hash=jnp.asarray(g["tree.node_hash"], jnp.uint32),
        node_count=jnp.asarray(g["tree.node_count"], jnp.int32),
    )
    return JM.SearchState(
        tree=tree, root_board=jnp.zeros((b, H, W), jnp.int8),
        root_stm=jnp.ones((b,), jnp.int8), root_node=jnp.asarray(root, jnp.int32),
        noisy_prior=f32(g["tree.edge_prior"][np.arange(b), root]),
        sims_done=jnp.zeros((b,), jnp.int32), stats=JM.SearchStats.zeros(b),
    )


def torch_state(g: dict, root: np.ndarray) -> TM.SearchState:
    b, n, k = g["tree.edge_action"].shape
    t = lambda name, dt: torch.from_numpy(np.asarray(g[f"tree.{name}"])).to(dt)
    tree = TM.Tree(
        node_visits=t("node_visits", torch.int32),
        node_value_sum=t("node_value_sum", torch.float32),
        node_score=t("node_score", torch.int32),
        node_moves_left_sum=torch.zeros((b, n)),
        node_complete=t("node_complete", torch.bool),
        edge_action=t("edge_action", torch.int32),
        edge_child=t("edge_child", torch.int32),
        edge_prior=t("edge_prior", torch.bfloat16),
        edge_score=t("edge_score", torch.int32),
        edge_q_init=torch.zeros((b, n, k), dtype=torch.bfloat16),
        node_hash=t("node_hash", torch.int64),
        node_count=t("node_count", torch.int32),
    )
    return TM.SearchState(
        tree=tree, root_board=torch.zeros((b, H, W), dtype=torch.int8),
        root_stm=torch.ones(b, dtype=torch.int8), root_node=torch.from_numpy(root),
        noisy_prior=tree.edge_prior[torch.arange(b), torch.from_numpy(root)].float(),
        sims_done=torch.zeros(b, dtype=torch.int32), stats=TM.SearchStats.zeros(b, "cpu"),
        frontier=int(tree.node_count.max()),
    )


@pytest.mark.parametrize("golden", GOLDENS)
def test_selectors_equal_jax(golden):
    g = torch_golden.load(golden)
    picks = set()
    for reused in (False, True):
        root = _roots(g, reused)
        js, ts = jax_state(g, root), torch_state(g, root)
        for policy in POLICIES:
            ref = np.asarray(JS.select(js, policy)).astype(np.int64)
            ours = TS.select(ts, policy).numpy()
            assert np.array_equal(ours, ref), (policy, reused, ref, ours)
            picks.add((policy, tuple(ref)))
    # the policies do not all agree: the comparison tells them apart
    assert len({p for _, p in picks}) > 1


def test_unknown_policy_raises():
    g = torch_golden.load(GOLDENS[0])
    with pytest.raises(ValueError, match="unknown selector"):
        TS.select(torch_state(g, _roots(g, False)), "nope")
