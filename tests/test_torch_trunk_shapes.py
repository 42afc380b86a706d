"""The trunk kernel's shapes: every convnext width and every board up to
20x20 (`ops/convnext_fused.py` `trunk_plan`).

- On the CPU: the plain trunk on inputs and weights padded with zero
  channels to the kernel's width (`pad_trunk`), cut back to C, equals the
  plain trunk at C (as values: a sum of -0 terms may come out +0), for
  C = 8, 16, 32 and 96 on 9x9 at L = 2 and C = 136, 200, 264 and 300 at
  L = 1; the padded fused forward of the 2x32, 1x136 and 1x300 networks
  meets the JAX goldens `forward_2x32`, `forward_1x136` and
  `forward_1x300` (flax `net.apply` and the Pallas fused forward) under
  `HEAD_LIMITS`; `trunk_plan` picks, for every C <= 256 and every board up
  to 20x20, the width, the entry, the CTAs a board and a shared memory
  within the card's opt-in limit per CTA, and for every C in 257..1024 the
  streamed entry at the next multiple of 64.
- On the card (`cuda`): each padded width, the cluster entry (C = 128 on
  16x16 to 20x20), the wide entry (C = 129 to 256) and the streamed entry
  (C above 256) against the plain trunk within TRUNK_LIMITS (all blocks)
  and BLOCK_LIMITS (each block alone), a left-out bias rejected, and what
  the cluster, wide and streamed entries get from the card.
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


@pytest.mark.parametrize("filters", [8, 16, 32, 96, 136, 200, 264, 300])
def test_padded_plain_trunk_equals_unpadded(filters):
    blocks = 2 if filters <= 128 else 1
    x, tw = _trunk_input("cpu", filters, blocks, 2, 9, 9, seed=filters)
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


def _padded_forward_meets_golden(name: str, filters: int, width: int):
    """The fused forward of the golden's network (for its planes' board)
    with its trunk padded to `width` channels: equal to the unpadded one,
    within HEAD_LIMITS of the Pallas fused forward, and within
    tests/test_ops.py's 5% rule of flax's `net.apply` (which no bf16
    backend meets HEAD_LIMITS of: PERF.md §6, ROADMAP.md §3)."""
    from tests.test_torch_network import _heads, _unflatten, assert_close

    golden = torch_golden.load(name)
    variables = _unflatten({k[4:]: v for k, v in golden.items() if k.startswith("var/")})
    planes = torch.from_numpy(golden["planes"])
    net = network_from_flax(variables, rows=planes.shape[1], cols=planes.shape[2])
    assert net.cfg.filters == filters
    padded = CF.FusedWeights(net, CF.pad_trunk_weights(CF.pack_trunk_weights(net), width))
    assert padded.trunk.w1.shape[-1] == width == CF.kernel_width(filters)
    out = CF.fused_apply(padded, planes, trunk=CF.fused_trunk_plain)
    plain = CF.fused_apply(CF.pack_weights(net), planes, trunk=CF.fused_trunk_plain)
    for name in HEADS:
        assert torch.equal(getattr(out, name), getattr(plain, name)), name
        held = agreement(torch.from_numpy(golden[f"pallas.{name}"]), getattr(out, name),
                         **CF.HEAD_LIMITS)
        assert held["ok"], (name, held)
    assert_close(_heads(golden, "ref"), out._replace(**{n: getattr(out, n).numpy()
                                                        for n in HEADS}), "padded vs net.apply")


def test_padded_forward_meets_the_2x32_golden():
    """The 2x32 trunk padded to 64 channels (the Pallas forward comes out
    bit-equal)."""
    _padded_forward_meets_golden("forward_2x32", 32, 64)


def test_padded_forward_meets_the_1x136_golden():
    """A 1x136 network, a width the wide entry runs on zero channels padded
    to 256."""
    _padded_forward_meets_golden("forward_1x136", 136, 256)


def test_padded_forward_meets_the_1x300_golden():
    """A 1x300 network on 9x9 boards, a width the streamed entry runs on
    zero channels padded to 320."""
    _padded_forward_meets_golden("forward_1x300", 300, 320)


def jax_forward_1x136() -> dict:
    """The JAX side of the `forward_1x136` golden: a flax-initialised 1x136
    ConvNextPVQMraw through `net.apply` and the Pallas fused forward in
    interpret mode, on 4 seeded boards."""
    from tests.test_torch_network import _jax_init, jax_forward

    net_jax, variables = _jax_init(1, 136)
    return jax_forward(net_jax, variables, batch=4, seed=3, block_batch=4, with_variables=True)


def jax_forward_1x300() -> dict:
    """The JAX side of the `forward_1x300` golden: a flax-initialised 1x300
    ConvNextPVQMraw on 9x9 boards through `net.apply` and the Pallas fused
    forward in interpret mode, on 2 seeded boards, its parameters rounded
    to bf16 values."""
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.models import create_network as jax_create_network
    from alphagomoku_tpu.ops.convnext_fused import make_fused_apply
    from tests.test_torch_network import _flatten

    net_jax = jax_create_network("ConvNextPVQMraw", blocks=1, filters=300)
    planes = (np.random.default_rng(4).random((2, 9, 9, 8)) < 0.3).astype(np.float32)
    variables = jax.jit(lambda key: net_jax.init(key, jnp.zeros((1, 9, 9, 8)), train=False))(
        jax.random.PRNGKey(0))
    # the parameters on bf16 values (the forward casts them to bf16 anyway),
    # which keeps the golden's file near 1.5 MB
    variables = dict(variables, params=jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), variables["params"]))
    ref = net_jax.apply(variables, jnp.asarray(planes, jnp.bfloat16), train=False)
    pallas = make_fused_apply(net_jax, variables, block_batch=2, interpret=True)(
        variables, jnp.asarray(planes))
    out = {"planes": planes}
    for name in HEADS:
        out[f"ref.{name}"] = np.asarray(getattr(ref, name), np.float32)
        out[f"pallas.{name}"] = np.asarray(getattr(pallas, name), np.float32)
    out.update({f"var/{k}": v for k, v in _flatten(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}).items()})
    return out


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


def test_wide_trunk_plan_takes_every_width_and_board():
    """Every C in 129..256 on every board up to 20x20: width 256 on the wide
    entry, the fewest CTAs a board (at most 8) whose CTAs each hold at most
    128 cells and fit the card's opt-in limit, each CTA at least one row."""
    plans = {(h, w): CF.trunk_plan(256, h, w) for h in range(1, 21) for w in range(1, 21)}
    for (h, w), plan in plans.items():
        assert plan.entry == "convnext_trunk_wide_kernel" and plan.width == 256, (h, w, plan)
        n = plan.ctas
        assert 1 <= n <= CF.WIDE_MAX_CTAS and n <= h, (h, w, plan)
        rows = CF._wide_rows(h, n)
        assert min(b - a for a, b in zip(rows, rows[1:])) >= 1
        assert -(-h // n) * w <= CF.WIDE_MAX_CELLS
        assert plan.smem_bytes == CF._wide_cta_bytes(256, h, w, n) <= CF.SM90_SMEM_OPTIN
        # the fewest CTAs: one fewer does not fit
        if n > 1:
            assert (-(-h // (n - 1)) * w > CF.WIDE_MAX_CELLS
                    or CF._wide_cta_bytes(256, h, w, n - 1) > CF.SM90_SMEM_OPTIN), (h, w, plan)
    for c in range(129, 257):
        assert CF.kernel_width(c) == 256
        for h in (1, 7, 15, 16, 19, 20):
            for w in (1, 9, 15, 20):
                assert CF.trunk_plan(c, h, w) == plans[(h, w)]
    assert max(p.ctas for p in plans.values()) == 5
    # the sizes the kernel's own Wide<256>::bytes() gives
    assert CF.trunk_plan(256, 15, 15) == CF.TrunkPlan("convnext_trunk_wide_kernel", 256, 2,
                                                      226768)
    assert CF.trunk_plan(256, 20, 20) == CF.TrunkPlan("convnext_trunk_wide_kernel", 256, 5,
                                                      224128)
    assert CF.trunk_plan(136, 16, 16) == CF.TrunkPlan("convnext_trunk_wide_kernel", 256, 3,
                                                      219904)
    assert CF.trunk_smem_bytes(200, 9, 9) == 161824  # one CTA a board


def test_streamed_trunk_plan_takes_every_width_above_256():
    """Every C in 257..1024 on boards of 1, 7, 15, 16, 19 and 20 rows and
    columns: the streamed entry at the next multiple of 64, one launch
    group a call (no cluster), every kernel's shared memory within the
    card's opt-in limit."""
    boards = (1, 7, 15, 16, 19, 20)
    for c in range(257, 1025):
        width = -(-c // 64) * 64
        assert CF.kernel_width(c) == width
        for h in boards:
            for w in boards:
                smem = max(CF._streamed_bytes(width, h, w).values())
                assert smem <= CF.SM90_SMEM_OPTIN
                assert CF.trunk_plan(c, h, w) == CF.TrunkPlan("convnext_trunk_streamed", width,
                                                              1, smem), (c, h, w)
    # the sizes the kernels' own Streamed::*_bytes() give: the depthwise's
    # board with its halo, the product's two stages, norms and list, the
    # SE's partial sums of a board
    assert CF._streamed_bytes(384, 20, 20) == {"depthwise": 99840, "product1": 51472,
                                               "product2": 51472, "se": 32256, "scale": 0}
    assert CF.trunk_smem_bytes(384, 15, 15) == 69760
    assert CF._streamed_bytes(1024, 9, 9)["se"] == CF._streamed_bytes(512, 20, 20)["se"] == 32768
    assert CF.trunk_plan(300, 16, 16) == CF.TrunkPlan("convnext_trunk_streamed", 320, 1, 75264)
    # a board past 20x20 runs the depthwise in tiles of at most 20 x 20;
    # widths past the SE's splits keep their partial sums in registers
    assert CF._streamed_bytes(384, 40, 21)["depthwise"] == CF._streamed_bytes(
        384, 20, 11)["depthwise"]
    assert CF._streamed_bytes(8192, 20, 20)["se"] == 0 and CF.kernel_width(8193) == 8256


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
    # the wide entry
    "c256_15x15": (256, 8, 8, 15, 15),  # 2 CTAs a board
    "c256_20x20": (256, 8, 8, 20, 20),  # 5 CTAs a board
    "c136_16x16": (136, 2, 5, 16, 16),  # padded to 256, 3 CTAs a board
    "c200_9x9": (200, 2, 4, 9, 9),  # padded to 256, one CTA a board
    "c256_7x19": (256, 2, 3, 7, 19),  # 2 CTAs of 3 and 4 rows, 19 wide
    "c256_17x17": (256, 2, 3, 17, 17),  # 4 CTAs a board
    "c256_1x1": (256, 2, 3, 1, 1),  # the smallest board, one CTA
    "c256_20x1": (256, 2, 3, 20, 1),  # one column, one CTA
    # the streamed entry
    "c384_15x15": (384, 8, 8, 15, 15),
    "c384_20x20": (384, 2, 8, 20, 20),
    "c512_20x20": (512, 2, 4, 20, 20),
    "c300_16x16": (300, 2, 5, 16, 16),  # padded to 320
    "c1024_9x9": (1024, 1, 4, 9, 9),  # the SE's partial sums split 2 ways
    "c384_1x1": (384, 2, 3, 1, 1),  # one cell: a product tile of one row
    "c384_20x1": (384, 2, 3, 20, 1),  # one column: a strip of one cell
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
    wide, streamed = CF.fused_trunk.wide_launches, CF.fused_trunk.streamed_launches
    out = CF.fused_trunk(x, tw)
    assert CF.fused_trunk.launches == before + 1 and out.shape == x.shape
    entry = CF.trunk_plan(filters, rows, cols).entry
    assert CF.fused_trunk.wide_launches == wide + (entry == "convnext_trunk_wide_kernel")
    assert CF.fused_trunk.streamed_launches == streamed + (entry == "convnext_trunk_streamed")
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


@pytest.mark.cuda
@pytest.mark.parametrize("bias", ["b2", "bn_t"])
def test_wide_check_rejects_a_kernel_without_a_bias_on_card(cuda_device, bias):
    x, tw = _trunk_input(cuda_device, 256, 8, 8, 15, 15, seed=11)
    t = getattr(tw, bias).clone()
    t[-1] = 0
    before = CF.fused_trunk.wide_launches
    out = CF.fused_trunk(x, tw._replace(**{bias: t}))
    assert CF.fused_trunk.wide_launches == before + 1
    held = agreement(CF.fused_trunk_plain(x, tw), out, **CF.TRUNK_LIMITS)
    assert not held["ok"], held


@pytest.mark.cuda
@pytest.mark.parametrize("board", [9, 15, 20])
def test_wide_occupancy_on_card(cuda_device, board):
    plan = CF.trunk_plan(256, board, board)
    occ = CF.trunk_occupancy(256, board, board)
    assert occ["entry"] == "convnext_trunk_wide_kernel" and occ["ctas"] == plan.ctas, occ
    assert occ["ctas_per_sm"] == 1 and occ["clusters"] >= 1, occ
    assert occ["smem_bytes"] == plan.smem_bytes <= CF.SM90_SMEM_OPTIN, occ


@pytest.mark.cuda
@pytest.mark.parametrize("bias", ["b2", "bn_t"])
def test_streamed_check_rejects_a_kernel_without_a_bias_on_card(cuda_device, bias):
    x, tw = _trunk_input(cuda_device, 384, 8, 8, 15, 15, seed=11)
    t = getattr(tw, bias).clone()
    t[-1] = 0
    before = CF.fused_trunk.streamed_launches
    out = CF.fused_trunk(x, tw._replace(**{bias: t}))
    assert CF.fused_trunk.streamed_launches == before + 1
    held = agreement(CF.fused_trunk_plain(x, tw), out, **CF.TRUNK_LIMITS)
    assert not held["ok"], held


@pytest.mark.cuda
@pytest.mark.parametrize("filters", [320, 384, 1024])
def test_streamed_occupancy_on_card(cuda_device, filters):
    """Each kernel of the streamed entry fits an SM with the shared memory
    `_streamed_bytes` gives it, the products two CTAs an SM."""
    occ = CF.trunk_occupancy(filters, 20, 20)
    assert occ["entry"] == "convnext_trunk_streamed" and set(occ["kernels"]) == set(
        CF.STREAMED_KERNELS), occ
    smem = CF._streamed_bytes(filters, 20, 20)
    for name, k in occ["kernels"].items():
        assert k["ctas_per_sm"] >= 1 and k["smem_bytes"] >= smem[name], (name, occ)
    assert occ["kernels"]["product1"]["ctas_per_sm"] >= 2, occ
    assert occ["kernels"]["product2"]["ctas_per_sm"] >= 2, occ
    assert occ["smem_bytes"] <= CF.SM90_SMEM_OPTIN, occ
