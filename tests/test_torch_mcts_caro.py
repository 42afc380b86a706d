"""The port's run_search held against the JAX package's under caro5
rules, with the stub network of tests/test_torch_mcts.py (its own file so
that each file's JAX compile stays well inside a minute)."""

import torch

from alphagomoku_tpu.game.types import GameRules

from tests.test_torch_mcts import check_stub_search

torch.set_num_threads(1)


def test_stub_search_matches_jax_caro5():
    check_stub_search(GameRules.CARO5)
