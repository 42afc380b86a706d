"""The port's replay buffer against the JAX package's: both are numpy
stores, and each must read the other's `.npz` files and sample the same
batches from the same `np.random.Generator`."""

from pathlib import Path

import numpy as np
import pytest
import torch

from alphagomoku_tpu.data.replay import ReplayBuffer as JaxReplayBuffer

from alphagomoku_tpu_torch.data import FIELDS, ReplayBuffer
from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.game.types import GameRules
from alphagomoku_tpu_torch.selfplay import selfplay as TSP
from tests.test_torch_selfplay import B, H, W, _configs, torch_stub

torch.set_num_threads(1)

FLAGSHIP = Path(__file__).resolve().parents[1] / "runs/flagship_r4/train_buffer/buffer_0.npz"


def _equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_loads_the_flagship_buffer_as_the_jax_class_does():
    ours, ref = ReplayBuffer(), JaxReplayBuffer()
    ours.load_generation(0, str(FLAGSHIP))
    ref.load_generation(0, str(FLAGSHIP))
    _equal(ours.generations[0], ref.generations[0])
    assert ours.num_samples == ref.num_samples == 4915
    assert ours.stats() == ref.stats()


@pytest.mark.parametrize("sampler", ["visits", "values"])
def test_sample_matches_jax(sampler):
    ours, ref = ReplayBuffer(), JaxReplayBuffer()
    for buf in (ours, ref):
        buf.load_generation(0, str(FLAGSHIP))
        buf.load_generation(1, str(FLAGSHIP))
    _equal(ours.sample(512, np.random.default_rng(3), sampler),
           ref.sample(512, np.random.default_rng(3), sampler))
    a = list(ours.iter_batches(64, 3, np.random.default_rng(4), sampler))
    b = list(ref.iter_batches(64, 3, np.random.default_rng(4), sampler))
    for x, y in zip(a, b, strict=True):
        _equal(x, y)


def test_files_cross_load(tmp_path):
    """A generation the port saves loads in the JAX class, and the
    reverse; the window trims the same way."""
    ours = ReplayBuffer(window_generations=2)
    ours.load_generation(0, str(FLAGSHIP))
    ours.save_generation(0, str(tmp_path / "port" / "buffer_0.npz"))
    ref = JaxReplayBuffer(window_generations=2)
    ref.load_generation(7, str(tmp_path / "port" / "buffer_0.npz"))
    _equal(ref.generations[7], ours.generations[0])
    ref.save_generation(7, str(tmp_path / "jax" / "buffer_7.npz"))
    ours.load_generation(7, str(tmp_path / "jax" / "buffer_7.npz"))
    ours.load_generation(8, str(tmp_path / "jax" / "buffer_7.npz"))
    assert sorted(ours.generations) == [7, 8]


def test_add_generation_takes_the_port_targets():
    """make_targets' torch tensors go in as the JAX class takes their numpy
    arrays: the valid samples of every field."""
    mcfg, scfg = _configs(False)
    result = TSP.play_games(torch_stub, None, TV.device_tables(GameRules.FREESTYLE), mcfg, scfg,
                            torch.Generator().manual_seed(0), B, H, W, device="cpu")
    targets = TSP.make_targets(result, H * W)
    ours, ref = ReplayBuffer(), JaxReplayBuffer()
    n = ours.add_generation(0, targets)
    assert n == ref.add_generation(0, {k: v.numpy() for k, v in targets.items()}) > 0
    _equal(ours.generations[0], ref.generations[0])
    assert tuple(ours.generations[0]) == FIELDS
    wdl = ours.generations[0]["value_wdl"]
    assert np.array_equal(wdl.sum(-1), np.ones(n, np.float32))
