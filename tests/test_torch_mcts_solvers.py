"""The port's run_search with the VCF leaf solver, and with the VCT leaf
solver and the loss prover (freestyle and renju), held against the JAX
package's, array for array, with the stub network of
tests/test_torch_mcts.py (B = 4, 32 simulations).  The JAX sides are the
goldens stub_search_vcf, stub_search_vct_loss and stub_search_renju
(`jax_stub_search`)."""

import torch

from alphagomoku_tpu.game.types import GameRules, CROSS, CIRCLE

from alphagomoku_tpu_torch.search import score as TS
from tests.test_torch_mcts import boards_and_stm, check_stub_search

torch.set_num_threads(1)

VCF = dict(leaf_solver="vcf", leaf_solver_cap=2, leaf_solver_steps=16)
VCT_LOSS = dict(leaf_solver="vct", leaf_solver_cap=2, leaf_solver_steps=16, loss_prover=True,
                loss_cap=2)
RENJU_LOSS = dict(leaf_solver="vct", leaf_solver_cap=2, leaf_solver_steps=16, loss_prover=True)


def tactical_positions():
    """boards_and_stm() with two boards replaced: CIRCLE to move against
    two open threes of CROSS (a lost root, which only the loss prover
    proves: it has more legal defenses than edge slots), and CROSS to move
    with two pairs meeting at (7, 7), a double three: a win in freestyle,
    a forbidden cell for black in renju."""
    boards, stm = boards_and_stm()
    boards[0] = 0
    boards[0, 5, 5:8] = CROSS
    boards[0, 9, 5] = boards[0, 8, 6] = boards[0, 7, 7] = CROSS
    boards[0, 11, 3] = boards[0, 10, 5] = boards[0, 3, 11] = CIRCLE
    boards[2] = 0
    boards[2, 7, 5:7] = boards[2, 5:7, 7] = CROSS
    boards[2, 2, 2] = boards[2, 12, 12] = boards[2, 2, 12] = boards[2, 12, 2] = CIRCLE
    stm = stm.copy()
    stm[0], stm[2] = CIRCLE, CROSS
    return boards, stm


def test_stub_search_with_vcf_leaf_solver_matches_jax():
    ts = check_stub_search(GameRules.FREESTYLE, golden="stub_search_vcf", **VCF)
    assert int(ts.stats.solver_wins.sum()) > 0


def test_stub_search_with_loss_prover_matches_jax():
    ts = check_stub_search(GameRules.FREESTYLE, golden="stub_search_vct_loss",
                           positions=tactical_positions(), **VCT_LOSS)
    root = ts.tree.node_score[:, 0]
    assert TS.is_loss(root[0]) and TS.is_win(root[2])


def test_stub_search_renju_with_loss_prover_matches_jax():
    ts = check_stub_search(GameRules.RENJU, golden="stub_search_renju",
                           positions=tactical_positions(), **RENJU_LOSS)
    root = ts.tree.node_score[:, 0]
    assert TS.is_loss(root[0]) and not TS.is_proven(root[2])
    # the forbidden double three is no edge of black's root
    assert not (ts.tree.edge_action[2, 0] == 7 * 15 + 7).any()
