"""The port's run_search with the VCT leaf solver (the engine default)
held against the JAX package's, array for array, with the stub network of
tests/test_torch_mcts.py.  A cap of 2 of the 4 leaves makes the leaf
compaction run; the JAX side is the golden stub_search_vct
(tests/torch_golden)."""

import torch

from alphagomoku_tpu.game.types import GameRules

from tests.test_torch_mcts import check_stub_search

torch.set_num_threads(1)

VCT = dict(leaf_solver="vct", leaf_solver_cap=2, leaf_solver_steps=16)


def test_stub_search_with_vct_leaf_solver_matches_jax():
    ts = check_stub_search(GameRules.FREESTYLE, golden="stub_search_vct", **VCT)
    assert int(ts.stats.solver_wins.sum()) > 0  # the solver proved a leaf
