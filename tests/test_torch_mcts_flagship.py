"""The port's run_search with the real flagship network (6x64
ConvNextPVQMraw, network_23) against the JAX package's (the golden
flagship_search of `jax_flagship_search`, tests/torch_golden)."""

from pathlib import Path

import numpy as np
import torch

from alphagomoku_tpu.game import vectorized as JV
from alphagomoku_tpu.game.types import GameRules, CROSS, CIRCLE
from alphagomoku_tpu.search import mcts as JM

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.models.convert import network_from_flax
from alphagomoku_tpu_torch.ops import convnext_fused as CF
from alphagomoku_tpu_torch.search import mcts as TM
from alphagomoku_tpu_torch.utils import checkpoint
from tests import torch_golden

torch.set_num_threads(1)

CKPT = Path(__file__).resolve().parents[1] / "runs/flagship_r4/checkpoint/network_23.msgpack"


def open_fours():
    """Two open fours, CROSS to move on one and CIRCLE on the other, and
    the winning cells of each."""
    boards = np.zeros((2, 15, 15), np.int8)
    boards[0, 7, 4:8] = CROSS  # CROSS to move, open four
    boards[0, 9, 3:6] = CIRCLE
    boards[1, 3, 2:6] = CIRCLE  # CIRCLE to move, open four
    boards[1, 10, 8:11] = CROSS
    boards[1, 12, 1] = CROSS
    stm = np.array([CROSS, CIRCLE], np.int8)
    wins = ({7 * 15 + 3, 7 * 15 + 8}, {3 * 15 + 1, 3 * 15 + 6})
    return boards, stm, wins


def jax_flagship_search() -> dict:
    """The JAX package's 16-sim search of the open fours with network_23
    (the reference side of the golden flagship_search)."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from alphagomoku_tpu.models import create_network as jax_create_network

    boards, stm, _ = open_fours()
    jcfg = JM.MCTSConfig(max_nodes=24, max_edges=16, max_depth=8)
    net = jax_create_network("ConvNextPVQMraw", blocks=6, filters=64)
    variables = serialization.msgpack_restore(CKPT.read_bytes())
    apply = lambda v, planes: net.apply(v, planes, train=False)
    jtables = JV.RuleTables(pattern=None, threat=None, rules=int(GameRules.FREESTYLE))
    js = jax.jit(lambda v, b, s: JM.run_search(apply, v, jtables, jcfg, b, s, 16))(
        variables, jnp.asarray(boards), jnp.asarray(stm)
    )
    return {"select_move": np.asarray(JM.select_move(js)),
            "root_score": np.asarray(js.tree.node_score[:, 0])}


def test_flagship_search_completes_the_open_four():
    boards, stm, wins = open_fours()
    ref = torch_golden.load("flagship_search")
    weights = CF.pack_weights(network_from_flax(checkpoint.load(CKPT)))
    tcfg = TM.MCTSConfig(max_nodes=24, max_edges=16, max_depth=8)
    ts = TM.run_search(
        CF.fused_apply, weights, TV.device_tables(GameRules.FREESTYLE), tcfg,
        boards, stm, 16, device="cpu",
    )
    tmove = TM.select_move(ts).numpy()
    for b in range(2):
        assert int(ref["select_move"][b]) in wins[b]
        assert int(tmove[b]) in wins[b]
    assert np.array_equal(ref["root_score"], ts.tree.node_score[:, 0].numpy())
