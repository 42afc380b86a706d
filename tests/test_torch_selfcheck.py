"""The port's `--selfcheck` (utils/selfcheck.py) on the CPU: the five
checks pass, in process and through the launcher; the pattern-table
digests are the JAX package's; and the search check, a FastPolicy 1x8
search at 9x9 with 81 edge slots (score_backup's K > 32), held to the JAX
package's search with its own flax weights carried across (golden
`selfcheck_search`): the same move, the same root visits and the same
tree.
"""

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.models.convert import network_from_flax
from alphagomoku_tpu_torch.search import mcts as TM
from alphagomoku_tpu_torch.utils import selfcheck
from tests import torch_golden
from tests.test_torch_mcts import CLOSE, EXACT
from tests.test_torch_network import _flatten, _unflatten

torch.set_num_threads(1)

CHECK_NAMES = ("torch device", "pattern tables", "rules engine", "network", "search")


def jax_selfcheck_search() -> dict:
    """The golden selfcheck_search: the JAX package's `--selfcheck` search
    (`alphagomoku_tpu/utils/selfcheck.py:_check_search`: FastPolicy 1x8,
    flax init PRNGKey(0), 9x9, max_nodes 24, max_edges 81, max_depth 8, 16
    simulations) with its weights, the tree and the results."""
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.game import vectorized as JV
    from alphagomoku_tpu.game.types import GameRules
    from alphagomoku_tpu.models import create_network
    from alphagomoku_tpu.search import mcts as JM

    net = create_network("FastPolicy", blocks=1, filters=8)
    x = jnp.zeros((1, 9, 9, net.cfg.input_planes), jnp.float32)
    variables = net.init(jax.random.PRNGKey(0), x, train=False)
    board, stm, _ = selfcheck.win_in_one()
    cfg = JM.MCTSConfig(max_nodes=24, max_edges=81, max_depth=8)
    state = jax.jit(lambda v, b, s: JM.run_search(
        lambda v, p: net.apply(v, p, train=False), v, JV.device_tables(GameRules.FREESTYLE),
        cfg, b, s, 16))(variables, jnp.asarray(board), jnp.asarray(stm))
    out = {f"var/{k}": np.asarray(v, np.float32) for k, v in _flatten(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}).items()}
    out.update({f"tree.{n}": np.asarray(getattr(state.tree, n)).astype(np.int64) for n in EXACT})
    out.update({f"tree.{n}": np.asarray(getattr(state.tree, n)).astype(np.float32)
                for n in CLOSE})
    out["select_move"] = np.asarray(JM.select_move(state))
    out["root_visit_distribution"] = np.asarray(JM.root_visit_distribution(state))
    return out


@pytest.fixture(scope="module")
def golden_search():
    golden = torch_golden.load("selfcheck_search")
    variables = _unflatten({k[4:]: v for k, v in golden.items() if k.startswith("var/")})
    net = network_from_flax(variables, "FastPolicy", rows=9, cols=9)
    return golden, selfcheck.search_check(net, "cpu")


def test_search_check_chooses_jax_move_and_root_visits(golden_search):
    golden, state = golden_search
    move = int(TM.select_move(state)[0])
    assert move == int(golden["select_move"][0])
    assert (move // 9, move % 9) in selfcheck.win_in_one()[2]
    assert np.array_equal(TM.root_visit_distribution(state).numpy(),
                          golden["root_visit_distribution"])


def test_search_at_81_edges_matches_jax_tree(golden_search):
    """K = 81 edge slots: every root cell of the 9x9 board is an edge, and
    the whole tree is the JAX package's."""
    golden, state = golden_search
    assert int((state.tree.edge_action[0, 0] >= 0).sum()) > 32
    for n in EXACT:
        assert np.array_equal(getattr(state.tree, n).numpy().astype(np.int64),
                              golden[f"tree.{n}"]), n
    for n in CLOSE:
        assert np.allclose(getattr(state.tree, n).float().numpy(), golden[f"tree.{n}"],
                           rtol=1e-5, atol=0), n


def test_selfcheck_passes_in_process(capsys):
    assert selfcheck.run_selfcheck(isolate=False, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [f"[PASS] {n}" for n in CHECK_NAMES]


def test_pattern_table_digests_are_jax_digests():
    from alphagomoku_tpu.utils.selfcheck import _check_pattern_tables as jax_digests

    assert selfcheck._check_pattern_tables("cpu") == jax_digests()


def test_launcher_selfcheck_exits_0(capsys):
    from alphagomoku_tpu_torch.engine.manager import main

    with pytest.raises(SystemExit) as exit_:
        main(["--selfcheck", "--device", "cpu"])
    assert exit_.value.code == 0
    assert capsys.readouterr().out.count("[PASS]") == len(CHECK_NAMES)
