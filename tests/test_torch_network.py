"""The port's network: checkpoint reader, flax weight conversion, and the
plain forward held against flax `net.apply` and the Pallas fused forward
(interpret mode); the CUDA trunk kernel held against the plain trunk on a
machine with a card.

JAX and flax are imported inside the parity tests, so that the card's
tests run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_network.py
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.models.convert import from_flax, network_from_flax
from alphagomoku_tpu_torch.models.networks import create_network, init_random_
from alphagomoku_tpu_torch.ops import convnext_fused as CF
from alphagomoku_tpu_torch.utils import checkpoint
from alphagomoku_tpu_torch.utils.bf16 import agreement, ulps
from tests import torch_golden

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


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *scopes, leaf = key.split("/")
        node = tree
        for sc in scopes:
            node = node.setdefault(sc, {})
        node[leaf] = v
    return tree


def _planes(batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((batch, 15, 15, 8)) < 0.3).astype(np.float32)


def _jax_init(blocks, filters):
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.models import create_network as jax_create_network

    net_jax = jax_create_network("ConvNextPVQMraw", blocks=blocks, filters=filters)
    x = jnp.zeros((1, 15, 15, 8), jnp.float32)
    return net_jax, jax.jit(lambda key: net_jax.init(key, x, train=False))(jax.random.PRNGKey(0))


def jax_forward(net_jax, variables, batch, seed, block_batch, with_variables=False) -> dict:
    """flax `net.apply` and the Pallas fused forward (interpret mode) on
    seeded planes: the reference side of the forward_* goldens."""
    import jax.numpy as jnp
    from alphagomoku_tpu.ops.convnext_fused import make_fused_apply

    planes = _planes(batch, seed)
    ref = net_jax.apply(variables, jnp.asarray(planes, jnp.bfloat16), train=False)
    pallas = make_fused_apply(net_jax, variables, block_batch=block_batch, interpret=True)(
        variables, jnp.asarray(planes)
    )
    out = {"planes": planes}
    for name in HEADS:
        out[f"ref.{name}"] = np.asarray(getattr(ref, name), np.float32)
        out[f"pallas.{name}"] = np.asarray(getattr(pallas, name), np.float32)
    if with_variables:
        out.update({f"var/{k}": v for k, v in _flatten(
            {"params": variables["params"], "batch_stats": variables["batch_stats"]}).items()})
    return out


def jax_forward_2x32() -> dict:
    net_jax, variables = _jax_init(2, 32)
    return jax_forward(net_jax, variables, batch=6, seed=1, block_batch=6, with_variables=True)


def jax_forward_6x64() -> dict:
    from alphagomoku_tpu.models import create_network as jax_create_network

    net_jax = jax_create_network("ConvNextPVQMraw", blocks=6, filters=64)
    return jax_forward(net_jax, _flagship_variables(), batch=4, seed=2, block_batch=4)


def _heads(golden: dict, prefix: str):
    return SimpleNamespace(**{n: golden[f"{prefix}.{n}"] for n in HEADS})


def _compare(host_variables: dict, golden: dict):
    """The port's module forward, fused forward with the plain trunk and
    fused forward through the wrapper, each against `net.apply` and the
    Pallas fused forward of the golden."""
    net = network_from_flax(host_variables)
    weights = CF.pack_weights(net)
    tp = torch.from_numpy(golden["planes"])
    ours = {
        "module": net(tp),
        "fused_plain": CF.fused_apply(weights, tp, trunk=CF.fused_trunk_plain),
        "fused_dispatch": CF.fused_apply(weights, tp),
    }
    for what, out in ours.items():
        out_np = out._replace(**{n: getattr(out, n).numpy() for n in HEADS})
        assert_close(_heads(golden, "ref"), out_np, f"{what} vs net.apply")
        assert_close(_heads(golden, "pallas"), out_np, f"{what} vs pallas interpret")


def test_forward_matches_flax_random_2x32():
    golden = torch_golden.load("forward_2x32")
    variables = _unflatten({k[4:]: v for k, v in golden.items() if k.startswith("var/")})
    _compare(variables, golden)


def test_forward_matches_flax_flagship_6x64():
    _compare(checkpoint.load(CKPT), torch_golden.load("forward_6x64"))


def test_forward_matches_flax_random_2x128():
    """A flax-initialised 2x128 net (the 8x128 network's width) carried
    across with from_flax: the port's plain forwards against a live
    `net.apply`."""
    import jax
    import jax.numpy as jnp

    net_jax, variables = _jax_init(2, 128)
    planes = _planes(2, 6)
    ref = jax.jit(lambda v, x: net_jax.apply(v, x, train=False))(
        variables, jnp.asarray(planes, jnp.bfloat16))
    host = jax.tree_util.tree_map(np.asarray, variables)
    net = network_from_flax({"params": host["params"], "batch_stats": host["batch_stats"]})
    assert net.cfg.filters == 128
    tp = torch.from_numpy(planes)
    for what, out in (("module", net(tp)),
                      ("fused_plain", CF.fused_apply(CF.pack_weights(net), tp,
                                                     trunk=CF.fused_trunk_plain))):
        assert_close(ref, out._replace(**{n: getattr(out, n).numpy() for n in HEADS}), what)


def test_init_random_is_seeded_and_keeps_bn_statistics():
    make = lambda seed: init_random_(create_network("ConvNextPVQMraw", blocks=1, filters=16),
                                     torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith("running_mean"):
            assert not pa.any(), name
        elif name.endswith("running_var"):
            assert (pa == 1).all(), name
        else:
            assert not torch.equal(pa, pc) and pa.ne(0).all(), name


def test_registry_names_and_unported_trunks():
    """Every registry name builds in the port (no trunk is left unported),
    with the reference package's trunk, heads and input planes."""
    from alphagomoku_tpu.models import create_network as jax_create_network
    from alphagomoku_tpu.models import list_architectures as jax_list
    from alphagomoku_tpu_torch.models.networks import list_architectures

    assert list_architectures() == jax_list()
    for name in list_architectures():
        net, ref = create_network(name, blocks=1, filters=16), jax_create_network(name)
        assert (net.cfg.trunk, net.cfg.heads, net.cfg.raw_input) == (
            ref.cfg.trunk, ref.cfg.heads, ref.cfg.raw_input), name
        assert (net.unet is None) == (not net.cfg.trunk.startswith("unet")), name
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


def test_ulps_floor_counts_ulps_of_the_floor():
    """Below `floor` a difference counts in ulps of the floor; above it,
    in ulps of the values, as without a floor."""
    a = torch.tensor([0.01, 0.5], dtype=torch.bfloat16)
    b = a + torch.tensor([2.0**-11, 2.0**-8], dtype=torch.bfloat16)
    assert ulps(a, b).tolist() == [8.0, 1.0]  # steps 2^-14 and 2^-8
    assert ulps(a, b, floor=2.0**-4).tolist() == [1.0, 1.0]  # 2^-11 is a step at 1/16
    assert agreement(a, b, **CF.HEAD_LIMITS)["max_ulps"] == 1.0


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


def _seeded_trunk_input(device, batch, seed, blocks=8, filters=128):
    """The 8x128 network of chip_smoke.py (seeded random weights) and its
    stem's output on seeded planes: the trunk kernel's input at C = 128."""
    net = init_random_(create_network("ConvNextPVQMraw", blocks=blocks, filters=filters),
                       torch.Generator().manual_seed(0)).to(device).eval()
    planes = torch.from_numpy(_planes(batch, seed))
    with torch.no_grad():
        x = net.stem_forward(planes.to(device)).permute(0, 2, 3, 1).contiguous()
    return x, CF.pack_trunk_weights(net)


@pytest.mark.parametrize("bias", ["b2", "bn_t", "b1", "sb1", "sb2"])
def test_trunk128_limits_reject_a_left_out_bias(bias):
    x, tw = _seeded_trunk_input("cpu", batch=2, seed=5)
    ref = CF.fused_trunk_plain(x, tw)
    assert agreement(ref, ref.clone(), **CF.TRUNK_LIMITS)["ok"]
    faulty = agreement(ref, CF.fused_trunk_plain(x, _without_last(tw, bias)), **CF.TRUNK_LIMITS)
    assert not faulty["ok"], faulty


@pytest.mark.cuda
def test_trunk128_kernel_matches_plain_on_card(cuda_device):
    """C = 128, L = 8: all blocks within TRUNK_LIMITS, and each block
    alone, fed the plain trunk's input to it, within BLOCK_LIMITS."""
    x, tw = _seeded_trunk_input(cuda_device, batch=256, seed=3)
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
def test_trunk128_check_rejects_a_kernel_without_a_bias_on_card(cuda_device, bias):
    x, tw = _seeded_trunk_input(cuda_device, batch=256, seed=3)
    out = CF.fused_trunk(x, _without_last(tw, bias))
    held = agreement(CF.fused_trunk_plain(x, tw), out, **CF.TRUNK_LIMITS)
    assert not held["ok"], held


# Edges of the kernel's tiling: a lone board, a batch that is no multiple
# of anything, boards whose H*W is not a multiple of 16 (the last m16 tile
# of the products holds rows past H*W, which must not be written back or
# summed into the SE mean), and a trunk of one block.
TRUNK_EDGES = {  # name -> (batch, rows, cols, blocks or None for all)
    "batch1": (1, 15, 15, None),
    "batch133": (133, 15, 15, None),
    "board10x10": (16, 10, 10, None),
    "board13x13": (16, 13, 13, None),
    "one_block": (64, 15, 15, 1),
}


def _edge_trunk_input(device, filters, batch, rows, cols, blocks, seed):
    """The flagship (C = 64) or seeded 8x128 (C = 128) trunk, cut to
    `blocks`, and its stem's output on seeded rows x cols planes."""
    if filters == 64:
        net = network_from_flax(checkpoint.load(CKPT))
    else:
        net = init_random_(create_network("ConvNextPVQMraw", blocks=8, filters=128),
                           torch.Generator().manual_seed(0))
    net = net.to(device).eval()
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy((rng.random((batch, rows, cols, 8)) < 0.3).astype(np.float32))
    with torch.no_grad():
        x = net.stem_forward(planes.to(device)).permute(0, 2, 3, 1).contiguous()
    tw = CF.pack_trunk_weights(net)
    return x, CF.TrunkWeights(*(t[:blocks].contiguous() for t in tw))


@pytest.mark.cuda
@pytest.mark.parametrize("filters", [64, 128])
@pytest.mark.parametrize("edge", sorted(TRUNK_EDGES))
def test_trunk_kernel_edges_on_card(cuda_device, filters, edge):
    """All blocks within TRUNK_LIMITS and each block alone, fed the plain
    trunk's input to it, within BLOCK_LIMITS."""
    batch, rows, cols, blocks = TRUNK_EDGES[edge]
    x, tw = _edge_trunk_input(cuda_device, filters, batch, rows, cols, blocks, seed=7)
    held = agreement(CF.fused_trunk_plain(x, tw), CF.fused_trunk(x, tw), **CF.TRUNK_LIMITS)
    assert held["ok"], held
    for l in range(tw.dw.shape[0]):
        wl = CF.TrunkWeights(*(t[l:l + 1].contiguous() for t in tw))
        ref = CF.fused_trunk_plain(x, wl)
        held = agreement(ref, CF.fused_trunk(x, wl), **CF.BLOCK_LIMITS)
        assert held["ok"], (l, held)
        x = ref


@pytest.mark.cuda
@pytest.mark.parametrize("filters", [64, 128])
def test_trunk_occupancy_on_card(cuda_device, filters):
    """Two CTAs per SM at C = 64 and one at C = 128, each of 256 threads
    within the SM's 65,536 registers."""
    occ = CF.trunk_occupancy(filters)
    assert occ["ctas_per_sm"] == (2 if filters == 64 else 1), occ
    assert occ["ctas_per_sm"] * 256 * occ["registers"] <= 65536, occ
    assert occ["smem_bytes"] * occ["ctas_per_sm"] <= 228 * 1024, occ
