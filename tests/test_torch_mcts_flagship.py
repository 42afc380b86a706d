"""The port's run_search with the real flagship network (6x64
ConvNextPVQMraw, network_23) against the JAX package's."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from alphagomoku_tpu.game import vectorized as JV
from alphagomoku_tpu.game.types import GameRules, CROSS, CIRCLE
from alphagomoku_tpu.models import create_network as jax_create_network
from alphagomoku_tpu.search import mcts as JM

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.models.convert import network_from_flax
from alphagomoku_tpu_torch.ops import convnext_fused as CF
from alphagomoku_tpu_torch.search import mcts as TM
from alphagomoku_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

CKPT = Path(__file__).resolve().parents[1] / "runs/flagship_r4/checkpoint/network_23.msgpack"


def test_flagship_search_completes_the_open_four():
    boards = np.zeros((2, 15, 15), np.int8)
    boards[0, 7, 4:8] = CROSS  # CROSS to move, open four
    boards[0, 9, 3:6] = CIRCLE
    boards[1, 3, 2:6] = CIRCLE  # CIRCLE to move, open four
    boards[1, 10, 8:11] = CROSS
    boards[1, 12, 1] = CROSS
    stm = np.array([CROSS, CIRCLE], np.int8)
    wins = ({7 * 15 + 3, 7 * 15 + 8}, {3 * 15 + 1, 3 * 15 + 6})

    jcfg = JM.MCTSConfig(max_nodes=24, max_edges=16, max_depth=8)
    net = jax_create_network("ConvNextPVQMraw", blocks=6, filters=64)
    variables = serialization.msgpack_restore(CKPT.read_bytes())
    apply = lambda v, planes: net.apply(v, planes, train=False)
    jtables = JV.RuleTables(pattern=None, threat=None, rules=int(GameRules.FREESTYLE))
    js = jax.jit(lambda v, b, s: JM.run_search(apply, v, jtables, jcfg, b, s, 16))(
        variables, jnp.asarray(boards), jnp.asarray(stm)
    )
    jmove = np.asarray(JM.select_move(js))

    weights = CF.pack_weights(network_from_flax(checkpoint.load(CKPT)))
    tcfg = TM.MCTSConfig(max_nodes=24, max_edges=16, max_depth=8)
    ts = TM.run_search(
        CF.fused_apply, weights, TV.device_tables(GameRules.FREESTYLE), tcfg,
        boards, stm, 16, device="cpu",
    )
    tmove = TM.select_move(ts).numpy()
    for b in range(2):
        assert int(jmove[b]) in wins[b]
        assert int(tmove[b]) in wins[b]
    assert np.array_equal(np.asarray(js.tree.node_score[:, 0]), ts.tree.node_score[:, 0].numpy())
