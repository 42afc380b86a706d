"""The port's network: checkpoint reader, flax weight conversion, and the
plain forward held against flax `net.apply` and the Pallas fused forward
(interpret mode); the CUDA trunk kernel held against the plain trunk on a
machine with a card.

JAX and flax are imported inside the parity tests, so that the card's
tests run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_network.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.models.convert import from_flax, network_from_flax
from alphagomoku_tpu_torch.models.networks import create_network
from alphagomoku_tpu_torch.ops import convnext_fused as CF
from alphagomoku_tpu_torch.utils import checkpoint
from alphagomoku_tpu_torch.utils.bf16 import agreement, ulps

torch.set_num_threads(1)

CKPT = Path(__file__).resolve().parents[1] / "runs/flagship_r4/checkpoint/network_23.msgpack"
HEADS = ("policy_logits", "value_logits", "q_logits", "moves_left_logits")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


def assert_close(ref, out, what):
    """The bf16 tolerance rule of tests/test_ops.py: max |a - b| within
    5% of the largest |a| plus 5e-3."""
    for name in HEADS:
        a = np.asarray(getattr(ref, name), np.float32)
        b = np.asarray(getattr(out, name), np.float32)
        assert a.shape == b.shape, (what, name)
        scale = max(1e-3, float(np.abs(a).max()))
        assert np.abs(a - b).max() <= 0.05 * scale + 5e-3, (what, name)


def _flagship_variables():
    from flax import serialization

    return serialization.msgpack_restore(CKPT.read_bytes())


def test_checkpoint_reader_matches_flax():
    ref = _flagship_variables()
    ours = checkpoint.load(CKPT)

    def walk(a, b, path=""):
        assert isinstance(b, dict) == isinstance(a, dict), path
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert np.array_equal(a, b), path

    walk(ref, ours)


def test_from_flax_covers_every_parameter():
    v = checkpoint.load(CKPT)
    net = create_network("ConvNextPVQMraw", blocks=6, filters=64)
    sd = from_flax(v)
    assert sorted(sd) == sorted(net.state_dict())
    net.load_state_dict(sd)
    dw = net.blocks[2].dw.conv.weight
    assert tuple(dw.shape) == (64, 1, 7, 7)
    assert np.array_equal(
        dw.detach().numpy()[:, 0].transpose(1, 2, 0),
        v["params"]["ConvNextBlock_2"]["Conv_0"]["kernel"][:, :, 0, :],
    )


def _compare(net_jax, variables, batch, seed, block_batch):
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.ops.convnext_fused import make_fused_apply

    rng = np.random.default_rng(seed)
    planes = (rng.random((batch, 15, 15, 8)) < 0.3).astype(np.float32)
    ref = net_jax.apply(variables, jnp.asarray(planes, jnp.bfloat16), train=False)
    pallas = make_fused_apply(net_jax, variables, block_batch=block_batch, interpret=True)(
        variables, jnp.asarray(planes)
    )
    host = jax.tree_util.tree_map(np.asarray, variables)
    net = network_from_flax({"params": host["params"], "batch_stats": host["batch_stats"]})
    weights = CF.pack_weights(net)
    tp = torch.from_numpy(planes)
    ours = {
        "module": net(tp),
        "fused_plain": CF.fused_apply(weights, tp, trunk=CF.fused_trunk_plain),
        "fused_dispatch": CF.fused_apply(weights, tp),
    }
    for what, out in ours.items():
        out_np = out._replace(**{n: getattr(out, n).numpy() for n in HEADS})
        assert_close(ref, out_np, f"{what} vs net.apply")
        assert_close(pallas, out_np, f"{what} vs pallas interpret")


def test_forward_matches_flax_random_2x32():
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.models import create_network as jax_create_network

    net_jax = jax_create_network("ConvNextPVQMraw", blocks=2, filters=32)
    x = jnp.zeros((1, 15, 15, 8), jnp.float32)
    variables = net_jax.init(jax.random.PRNGKey(0), x, train=False)
    _compare(net_jax, variables, batch=6, seed=1, block_batch=6)


def test_forward_matches_flax_flagship_6x64():
    from alphagomoku_tpu.models import create_network as jax_create_network

    net_jax = jax_create_network("ConvNextPVQMraw", blocks=6, filters=64)
    _compare(net_jax, _flagship_variables(), batch=4, seed=2, block_batch=4)


def test_registry_names_and_unported_trunks():
    from alphagomoku_tpu.models import list_architectures as jax_list
    from alphagomoku_tpu_torch.models.networks import list_architectures

    assert list_architectures() == jax_list()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_network("ResnetPV")
    assert create_network("ConvNextPVQMSraw", blocks=1, filters=16).soft_policy is not None


def _without_last(tw, name):
    """Trunk weights with the last block's `name` set to 0: the weights a
    kernel that left out that bias would in effect use."""
    t = getattr(tw, name).clone()
    t[-1] = 0
    return tw._replace(**{name: t})


def _flagship_trunk_input(device, batch, seed):
    net = network_from_flax(checkpoint.load(CKPT)).to(device)
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy((rng.random((batch, 15, 15, 8)) < 0.3).astype(np.float32))
    with torch.no_grad():
        x = net.stem_forward(planes.to(device)).permute(0, 2, 3, 1).contiguous()
    return x, CF.pack_trunk_weights(net)


def test_ulps_counts_one_bf16_step():
    rng = np.random.default_rng(4)
    bits = rng.integers(0x0080, 0x7F7F, size=4096).astype(np.int16)  # finite positive bf16
    a = torch.from_numpy(bits).view(torch.bfloat16)
    b = torch.from_numpy(bits + 1).view(torch.bfloat16)  # the next bf16 up
    # a step up to a power of two is half a step of the power of two
    want = np.where((bits + 1) & 0x7F == 0, 0.5, 1.0)
    assert np.array_equal(ulps(a, b).numpy(), want)
    assert np.array_equal(ulps(-a, -b).numpy(), want)
    assert float(ulps(a, a).max()) == 0.0


@pytest.mark.parametrize("bias", ["b2", "bn_t", "b1", "sb1", "sb2"])
def test_trunk_limits_reject_a_left_out_bias(bias):
    x, tw = _flagship_trunk_input("cpu", batch=4, seed=5)
    ref = CF.fused_trunk_plain(x, tw)
    assert agreement(ref, ref.clone(), **CF.TRUNK_LIMITS)["ok"]
    faulty = agreement(ref, CF.fused_trunk_plain(x, _without_last(tw, bias)), **CF.TRUNK_LIMITS)
    assert not faulty["ok"], faulty


@pytest.mark.cuda
def test_trunk_kernel_matches_plain_on_card(cuda_device):
    """All blocks within TRUNK_LIMITS, and each block alone, fed the plain
    trunk's input to it, within BLOCK_LIMITS."""
    x, tw = _flagship_trunk_input(cuda_device, batch=256, seed=3)
    held = agreement(CF.fused_trunk_plain(x, tw), CF.fused_trunk(x, tw), **CF.TRUNK_LIMITS)
    assert held["ok"], held
    for l in range(tw.dw.shape[0]):
        wl = CF.TrunkWeights(*(t[l:l + 1].contiguous() for t in tw))
        ref = CF.fused_trunk_plain(x, wl)
        held = agreement(ref, CF.fused_trunk(x, wl), **CF.BLOCK_LIMITS)
        assert held["ok"], (l, held)
        x = ref


@pytest.mark.cuda
@pytest.mark.parametrize("bias", ["b2", "bn_t"])
def test_trunk_check_rejects_a_kernel_without_a_bias_on_card(cuda_device, bias):
    x, tw = _flagship_trunk_input(cuda_device, batch=256, seed=3)
    out = CF.fused_trunk(x, _without_last(tw, bias))
    held = agreement(CF.fused_trunk_plain(x, tw), out, **CF.TRUNK_LIMITS)
    assert not held["ok"], held
