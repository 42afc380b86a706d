"""The port's run_search held against the JAX package's under caro5
rules, with the stub network of tests/test_torch_mcts.py, against the
golden of the JAX search (tests/torch_golden/stub_search_caro5.npz)."""

import torch

from alphagomoku_tpu.game.types import GameRules

from tests.test_torch_mcts import check_stub_search

torch.set_num_threads(1)


def test_stub_search_matches_jax_caro5():
    check_stub_search(GameRules.CARO5, golden="stub_search_caro5")
