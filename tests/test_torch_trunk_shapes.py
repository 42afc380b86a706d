"""The trunk kernel's shapes: every convnext width up to 128 and every board
up to 20x20 (`ops/convnext_fused.py` `trunk_plan`).

- On the CPU: the plain trunk on inputs and weights padded with zero
  channels to the kernel's width (`pad_trunk`), cut back to C, equals the
  plain trunk at C (as values: a sum of -0 terms may come out +0), for
  C = 8, 16, 32 and 96 on 9x9 at L = 2; the padded fused forward of the
  2x32 network meets the JAX golden `forward_2x32` (flax `net.apply` and
  the Pallas fused forward) under `HEAD_LIMITS`; `trunk_plan` picks, for
  every C <= 128 and every board up to 20x20, the width, the entry and a
  shared memory within the card's opt-in limit per CTA, and C above 128
  raises naming its ROADMAP entry.
- On the card (`cuda`): each padded width and the cluster entry (C = 128
  on 16x16 to 20x20) against the plain trunk within TRUNK_LIMITS (all
  blocks) and BLOCK_LIMITS (each block alone), a left-out bias rejected,
  and what the cluster entry gets from the card.
"""

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.models.convert import network_from_flax
from alphagomoku_tpu_torch.models.networks import create_network, init_random_
from alphagomoku_tpu_torch.ops import convnext_fused as CF
from alphagomoku_tpu_torch.utils.bf16 import agreement
from tests import torch_golden

torch.set_num_threads(1)

HEADS = ("policy_logits", "value_logits", "q_logits", "moves_left_logits")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


def _trunk_input(device, filters, blocks, batch, rows, cols, seed):
    """A seeded network of `filters` x `blocks` for rows x cols boards and
    its stem's output on seeded planes, with its trunk packed (on the
    card: padded to the kernel's width)."""
    net = init_random_(create_network("ConvNextPVQMraw", blocks, filters, rows, cols),
                       torch.Generator().manual_seed(seed)).to(device).eval()
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy((rng.random((batch, rows, cols, 8)) < 0.3).astype(np.float32))
    with torch.no_grad():
        x = net.stem_forward(planes.to(device)).permute(0, 2, 3, 1).contiguous()
    return x, CF.pack_trunk_weights(net)


@pytest.mark.parametrize("filters", [8, 16, 32, 96])
def test_padded_plain_trunk_equals_unpadded(filters):
    x, tw = _trunk_input("cpu", filters, 2, 2, 9, 9, seed=filters)
    assert tw.dw.shape[-1] == filters  # the CPU pack is not padded
    width = CF.kernel_width(filters)
    xp, wp = CF.pad_trunk(x, tw, width)
    assert xp.shape[-1] == width and all(t.shape[-1] == width for t in wp)
    out = CF.fused_trunk_plain(xp, wp)
    assert not out[..., filters:].float().any()  # the padded channels stay 0
    ref = CF.fused_trunk_plain(x, tw)
    assert ref.float().abs().max() > 0
    assert bool((out[..., :filters].float() == ref.float()).all())
    # weights padded alone: the plain trunk pads the input and cuts it back
    assert bool((CF.fused_trunk_plain(x, wp).float() == ref.float()).all())


def test_padded_forward_meets_the_2x32_golden():
    """The fused forward with the 2x32 trunk padded to 64 channels: equal to
    the unpadded one, within HEAD_LIMITS of the Pallas fused forward (it
    comes out bit-equal), and within tests/test_ops.py's 5% rule of flax's
    `net.apply` (which no bf16 backend meets HEAD_LIMITS of: PERF.md §6,
    ROADMAP.md §3)."""
    from tests.test_torch_network import _heads, _unflatten, assert_close

    golden = torch_golden.load("forward_2x32")
    variables = _unflatten({k[4:]: v for k, v in golden.items() if k.startswith("var/")})
    net = network_from_flax(variables)
    assert net.cfg.filters == 32
    planes = torch.from_numpy(golden["planes"])
    padded = CF.FusedWeights(net, CF.pad_trunk_weights(CF.pack_trunk_weights(net), 64))
    assert padded.trunk.w1.shape[-1] == 64
    out = CF.fused_apply(padded, planes, trunk=CF.fused_trunk_plain)
    plain = CF.fused_apply(CF.pack_weights(net), planes, trunk=CF.fused_trunk_plain)
    for name in HEADS:
        assert torch.equal(getattr(out, name), getattr(plain, name)), name
        held = agreement(torch.from_numpy(golden[f"pallas.{name}"]), getattr(out, name),
                         **CF.HEAD_LIMITS)
        assert held["ok"], (name, held)
    assert_close(_heads(golden, "ref"), out._replace(**{n: getattr(out, n).numpy()
                                                        for n in HEADS}), "padded vs net.apply")


def test_trunk_plan_takes_every_width_and_board():
    """Every C <= 128 on every board up to 20x20: the next built width, one
    CTA a board where its shared memory fits the card, else (C = 128 above
    252 cells) a cluster of two, each CTA within the opt-in limit."""
    entries = {}
    for c in range(1, 129):
        width = 64 if c <= 64 else 128
        assert CF.kernel_width(c) == width
        for h in range(1, 21):
            for w in range(1, 21):
                plan = CF.trunk_plan(c, h, w)
                assert plan.width == width
                assert plan.smem_bytes <= CF.SM90_SMEM_OPTIN
                assert CF.trunk_smem_bytes(c, h, w) == plan.smem_bytes
                cluster = width == 128 and h * w > 252
                assert plan.entry == ("convnext_trunk_cluster_kernel" if cluster
                                      else "convnext_trunk_kernel"), (c, h, w, plan)
                assert plan.ctas == (2 if cluster else 1)
                entries[plan.entry] = entries.get(plan.entry, 0) + 1
    big = sum(h * w > 252 for h in range(1, 21) for w in range(1, 21))  # 13x20 .. 20x20
    assert big == 39
    assert entries == {"convnext_trunk_kernel": 128 * 400 - 64 * big,
                       "convnext_trunk_cluster_kernel": 64 * big}
    # the sizes the kernels' own bytes() give
    assert CF.trunk_smem_bytes(64, 20, 20) == 146304
    assert CF.trunk_smem_bytes(128, 15, 15) == 217376
    assert CF.trunk_smem_bytes(128, 16, 16) == 178176
    assert CF.trunk_smem_bytes(128, 20, 20) == 220608
    assert CF.trunk_plan(16, 15, 15) == CF.TrunkPlan("convnext_trunk_kernel", 64, 1, 95904)


@pytest.mark.parametrize("filters", [129, 256])
def test_trunk_above_128_raises_naming_its_roadmap_entry(filters):
    with pytest.raises(NotImplementedError, match="ROADMAP.md §2 item 3"):
        CF.trunk_plan(filters, 15, 15)
    x = torch.zeros((1, 15, 15, filters), dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP.md §2 item 3"):
        CF.fused_trunk(x, None)


# on the card: (filters, blocks, batch, rows, cols) -> the entry it runs
CARD_SHAPES = {
    "c16_15x15": (16, 2, 16, 15, 15),
    "c96_15x15": (96, 2, 16, 15, 15),
    "c8_20x20": (8, 2, 4, 20, 20),
    "c128_16x16": (128, 8, 8, 16, 16),
    "c128_20x20": (128, 8, 8, 20, 20),
    "c128_19x20": (128, 2, 5, 19, 20),  # halves of 10 and 9 rows
    "c128_17x15": (128, 2, 5, 17, 15),  # 15 wide: the fixed-width depthwise
    "c100_13x20": (100, 2, 3, 13, 20),  # the fewest rows that take the cluster
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_trunk_kernel_shapes_on_card(cuda_device, shape):
    """All blocks within TRUNK_LIMITS of the plain trunk, and each block
    alone, fed the plain trunk's input to it, within BLOCK_LIMITS."""
    filters, blocks, batch, rows, cols = CARD_SHAPES[shape]
    x, tw = _trunk_input(cuda_device, filters, blocks, batch, rows, cols, seed=11)
    assert tw.dw.shape[-1] == CF.kernel_width(filters)
    before = CF.fused_trunk.launches
    out = CF.fused_trunk(x, tw)
    assert CF.fused_trunk.launches == before + 1 and out.shape == x.shape
    held = agreement(CF.fused_trunk_plain(x, tw), out, **CF.TRUNK_LIMITS)
    assert held["ok"], held
    for l in range(blocks):
        wl = CF.TrunkWeights(*(t[l:l + 1].contiguous() for t in tw))
        ref = CF.fused_trunk_plain(x, wl)
        held = agreement(ref, CF.fused_trunk(x, wl), **CF.BLOCK_LIMITS)
        assert held["ok"], (l, held)
        x = ref


@pytest.mark.cuda
@pytest.mark.parametrize("bias", ["b2", "bn_t"])
def test_cluster_check_rejects_a_kernel_without_a_bias_on_card(cuda_device, bias):
    x, tw = _trunk_input(cuda_device, 128, 8, 8, 20, 20, seed=11)
    t = getattr(tw, bias).clone()
    t[-1] = 0
    out = CF.fused_trunk(x, tw._replace(**{bias: t}))
    held = agreement(CF.fused_trunk_plain(x, tw), out, **CF.TRUNK_LIMITS)
    assert not held["ok"], held


@pytest.mark.cuda
@pytest.mark.parametrize("board", [16, 20])
def test_cluster_occupancy_on_card(cuda_device, board):
    occ = CF.trunk_occupancy(128, board, board)
    assert occ["entry"] == "convnext_trunk_cluster_kernel", occ
    assert occ["ctas_per_sm"] == 1 and occ["clusters"] >= 1, occ
    assert occ["smem_bytes"] <= CF.SM90_SMEM_OPTIN, occ
