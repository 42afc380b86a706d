"""The JAX computations behind the goldens: name -> a function returning
the dict of numpy arrays stored in `<name>.npz`.  Each function lives
beside the port test that reads its golden, and runs the JAX package on
the same numpy-seeded inputs as that test."""

from __future__ import annotations

from alphagomoku_tpu.game.types import GameRules

from tests import test_torch_augment as augment_tests
from tests import test_torch_engine as engine_tests
from tests import test_torch_env as env_tests
from tests import test_torch_host_rules as host_rules_tests
from tests import test_torch_mcts as mcts_tests
from tests import test_torch_mcts_flagship as flagship_tests
from tests import test_torch_loss_levels as loss_levels_tests
from tests import test_torch_loss_prover as loss_prover_tests
from tests import test_torch_match as match_tests
from tests import test_torch_mcts_leafsolver as leafsolver_tests
from tests import test_torch_mcts_solvers as solvers_tests
from tests import test_torch_network as network_tests
from tests import test_torch_openings as openings_tests
from tests import test_torch_renju as renju_tests
from tests import test_torch_reuse as reuse_tests
from tests import test_torch_selfplay as selfplay_tests
from tests import test_torch_score_scan as score_scan_tests
from tests import test_torch_threats as threat_tests
from tests import test_torch_trunk_shapes as trunk_shapes_tests
from tests import test_torch_train as train_tests
from tests import test_torch_vct as vct_tests
from tests import test_torch_vcf as vcf_tests
from tests import test_torch_zoo as zoo_tests
from tests import test_torch_selfcheck as selfcheck_tests
from tests import test_torch_search_options as options_tests
from tests import test_torch_tuner as tuner_tests
from tests import test_torch_anchor as anchor_tests

CASES = {
    "stub_search_standard": lambda: mcts_tests.jax_stub_search(GameRules.STANDARD),
    "stub_search_caro5": lambda: mcts_tests.jax_stub_search(GameRules.CARO5),
    "stub_search_caro6": lambda: mcts_tests.jax_stub_search(GameRules.CARO6),
    "stub_search_vct": lambda: mcts_tests.jax_stub_search(GameRules.FREESTYLE,
                                                          **leafsolver_tests.VCT),
    "flagship_search": flagship_tests.jax_flagship_search,
    "forward_2x32": network_tests.jax_forward_2x32,
    "forward_6x64": network_tests.jax_forward_6x64,
    "forward_1x136": trunk_shapes_tests.jax_forward_1x136,
    "forward_1x300": trunk_shapes_tests.jax_forward_1x300,
    "score_scan_interpret": score_scan_tests.jax_score_scan_interpret,
    "defensive_tables": threat_tests.jax_defensive_tables,
    "defensive_moves": threat_tests.jax_defensive_moves,
    "vct_solve": vct_tests.jax_vct_solve,
    "vct_solve_renju": lambda: vct_tests.jax_vct_solve(renju=True),
    "renju_forbidden": renju_tests.jax_renju_forbidden,
    "renju_checks": renju_tests.jax_renju_checks,
    "renju_defensive": renju_tests.jax_renju_defensive,
    "vcf_solve": vcf_tests.jax_vcf_solve,
    "loss_prover": loss_prover_tests.jax_loss_prover,
    "loss_levels": loss_levels_tests.jax_loss_levels,
    "stub_search_vcf": lambda: mcts_tests.jax_stub_search(GameRules.FREESTYLE, **solvers_tests.VCF),
    "stub_search_vct_loss": lambda: mcts_tests.jax_stub_search(
        GameRules.FREESTYLE, solvers_tests.tactical_positions(), **solvers_tests.VCT_LOSS),
    "stub_search_renju": lambda: mcts_tests.jax_stub_search(
        GameRules.RENJU, solvers_tests.tactical_positions(), **solvers_tests.RENJU_LOSS),
    "env_renju": lambda: env_tests.jax_env_games(GameRules.RENJU, env_tests.RENJU_DRAW_AFTER),
    "reuse_search": reuse_tests.jax_reuse_search,
    "selfplay_reuse": lambda: selfplay_tests.jax_selfplay(tree_reuse=True),
    "selfplay_fresh": lambda: selfplay_tests.jax_selfplay(tree_reuse=False),
    "selfplay_resumed": lambda: selfplay_tests.jax_selfplay(tree_reuse=True, resumed=True),
    "openings": openings_tests.jax_openings,
    "stub_search_draw_after": lambda: mcts_tests.jax_stub_search(
        GameRules.FREESTYLE, **solvers_tests.DRAW_HORIZON),
    "stub_search_no_transpositions": lambda: mcts_tests.jax_stub_search(
        GameRules.FREESTYLE, **solvers_tests.NO_TRANSPOSITIONS),
    "stub_search_symmetry": augment_tests.jax_symmetry_search,
    "train_steps": train_tests.jax_train_steps,
    "distill_step": train_tests.jax_distill_step,
    "match_stub": match_tests.jax_match,
    **{f"engine_{name}": (lambda name=name: engine_tests.jax_engine_case(name))
       for name in engine_tests.CASES},
    "engine_flagship": engine_tests.jax_engine_flagship,
    "host_vct": host_rules_tests.jax_host_vct,
    "zoo_train_steps": zoo_tests.jax_zoo_train_steps,
    "selfcheck_search": selfcheck_tests.jax_selfcheck_search,
    **{name: (lambda name=name: options_tests.jax_options_search(name))
       for name in options_tests.CASES},
    "tuner_step": tuner_tests.jax_tuner_step,
    "anchor_match": anchor_tests.jax_anchor_match,
}
