"""The port's flax msgpack writer and `to_flax`, both ways against flax:
flax reads what the port writes and the port reads what flax writes, bit
for bit, for network checkpoints and for the SWA file; the reference
run's own files round-trip byte for byte; the port's SWA of
`runs/flagship_r4/`'s last ten checkpoints is its `network_swa.msgpack`."""

from pathlib import Path

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.models.convert import from_flax, network_from_flax, to_flax
from alphagomoku_tpu_torch.models.networks import create_network, init_random_
from alphagomoku_tpu_torch.training.train import average_params
from alphagomoku_tpu_torch.utils import checkpoint
from tests.test_torch_network import _flatten

torch.set_num_threads(1)

RUN = Path(__file__).resolve().parents[1] / "runs" / "flagship_r4" / "checkpoint"
ARCH = "ConvNextPVQMraw"


def _port_net(seed: int, blocks: int = 2, filters: int = 16):
    return init_random_(create_network(ARCH, blocks=blocks, filters=filters, rows=9, cols=9),
                        torch.Generator().manual_seed(seed))


def _flax_template(blocks: int = 2, filters: int = 16):
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.models import create_network as jax_create_network

    net = jax_create_network(ARCH, blocks=blocks, filters=filters)
    return jax.jit(lambda k: net.init(k, jnp.zeros((1, 9, 9, 8)), train=False))(
        jax.random.PRNGKey(0))


def _equal_trees(a: dict, b: dict):
    fa, fb = _flatten(a), _flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def test_flax_reads_port_checkpoint():
    from flax import serialization

    net = _port_net(0)
    data = checkpoint.to_bytes(to_flax(net.state_dict()))
    restored = serialization.from_bytes(_flax_template(), data)
    host = {c: restored[c] for c in ("params", "batch_stats")}
    back = from_flax(host)
    for k, t in net.state_dict().items():
        assert torch.equal(back[k], t), k
    # and the bytes are flax's own for that tree, in the reference
    # manager's {"params", "batch_stats"} order
    assert serialization.to_bytes(host) == data


def test_port_reads_flax_checkpoint():
    import jax
    from flax import serialization

    variables = _flax_template()
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    data = serialization.to_bytes(variables)
    ours = checkpoint.restore(data)
    _equal_trees(jax.tree_util.tree_map(np.asarray, variables), ours)
    net = network_from_flax(ours, rows=9, cols=9)
    assert checkpoint.to_bytes(to_flax(net.state_dict())) == data


@pytest.mark.parametrize("name", ["network_28.msgpack", "network_swa.msgpack"])
def test_reference_run_files_round_trip(name):
    raw = (RUN / name).read_bytes()
    tree = checkpoint.restore(raw)
    assert checkpoint.to_bytes(tree) == raw
    assert checkpoint.to_bytes(to_flax(network_from_flax(tree).state_dict())) == raw


def test_swa_of_reference_run_is_its_swa_file():
    """The manager's SWA: the mean of the last ten checkpoints' parameters
    (19 to 28) and the last one's statistics, written as the reference
    package writes it."""
    trees = [checkpoint.load(RUN / f"network_{i}.msgpack") for i in range(19, 29)]
    swa = {"params": average_params([t["params"] for t in trees]),
           "batch_stats": trees[-1]["batch_stats"]}
    assert checkpoint.to_bytes(swa) == (RUN / "network_swa.msgpack").read_bytes()


def test_flax_reads_port_swa_file(tmp_path):
    """Three port checkpoints averaged and saved by the port; flax reads
    the file onto a template and gets the JAX package's own average of the
    three, bit for bit."""
    import jax.numpy as jnp
    from flax import serialization
    from alphagomoku_tpu.training.train import average_params as jax_average_params

    trees = [to_flax(_port_net(seed).state_dict()) for seed in range(3)]
    swa = {"params": average_params([t["params"] for t in trees]),
           "batch_stats": trees[-1]["batch_stats"]}
    path = tmp_path / "network_swa.msgpack"
    checkpoint.save(path, swa)
    template = _flax_template()
    restored = serialization.from_bytes(template, path.read_bytes())
    jax_avg = jax_average_params([
        serialization.from_bytes(template, checkpoint.to_bytes(t))["params"] for t in trees])
    _equal_trees({"params": jax_avg}, {"params": restored["params"]})
    _equal_trees({"b": trees[-1]["batch_stats"]}, {"b": restored["batch_stats"]})
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_msgpack_encoding_matches_msgpack_package():
    """Every header size the writer picks is the `msgpack` package's."""
    import msgpack
    from flax import serialization

    values = [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129, -2**15 - 1,
              -2**31 - 1, 1.5, None, True, False, "", "a" * 31, "a" * 32, "a" * 256, "a" * 70000,
              b"", b"x" * 300, b"x" * 70000, [1] * 15, [1] * 16, (1, 2),
              {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
              np.zeros((2, 3), np.float32), np.arange(4, dtype=np.int8), np.zeros(0, np.float32),
              np.ones(1, np.int8), np.float32(2.5)]
    for v in values:
        want = msgpack.packb(v, default=serialization._msgpack_ext_pack, use_bin_type=True)
        assert checkpoint.packb(v) == want, v
        back = checkpoint.unpackb(want)
        if isinstance(v, (np.ndarray, np.generic)):
            assert np.array_equal(back, v) and back.dtype == v.dtype
            assert isinstance(back, np.generic) == isinstance(v, np.generic)
