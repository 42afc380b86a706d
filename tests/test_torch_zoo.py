"""The network zoo in the port against the JAX package: every trunk family
(resnet, bottleneck v1-v3, transformer, unet, unet_transformer,
convnext_moe, and convnext with the soft-policy head) at 1 block and 8
filters on 9x9 boards, from one flax init carried across by `from_flax`.

- inference: the port's bfloat16 `forward` against a live, eager flax
  `net.apply(train=False)` (flax rounds each op to bfloat16, as the port
  does; XLA's compiled forward may keep float32 across fused elementwise
  ops), every head within `CF.HEAD_LIMITS`, but the two families of
  SE_FAMILIES (see there);
- train mode: `forward_train` and the BatchNorm statistics it updates
  against `apply(train=True, mutable=["batch_stats"])`, both networks at a
  float32 compute dtype, within 1e-3 of the largest magnitude.  In
  bfloat16 a train-mode forward is chaotic where a trunk is deep: batch
  statistics normalise small batches, so one bf16 rounding that an f32
  sum taken in another order turns (one element in 1,600 in the unet's
  seventh ConvBN) spreads to a third of the unet's logits, at 1 or 2 ulps
  each, in either framework;
- the checkpoint: `to_flax` + the port's msgpack writer give flax's own
  bytes;
- one train step per family (resnet, bottleneck_v2, transformer, unet,
  convnext_moe) held to the golden `zoo_train_steps` under the rule of
  tests/test_torch_train.py: in float32 against JAX's float64 step (see
  `jax_zoo_train_steps`), in bfloat16 against JAX's bfloat16 noise
  (`_check_bf16`);
- `network_apply` (and `net_apply_for`) picks the fused trunk for the convnext
  trunk only.
"""

import functools

import numpy as np
import pytest
import torch

from alphagomoku_tpu.game.types import GameRules

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.models import networks as TN
from alphagomoku_tpu_torch.models.convert import from_flax, network_from_flax, to_flax
from alphagomoku_tpu_torch.models.forward import module_apply, net_apply_for, network_apply
from alphagomoku_tpu_torch.ops import convnext_fused as CF
from alphagomoku_tpu_torch.training import train as T
from alphagomoku_tpu_torch.utils import checkpoint
from alphagomoku_tpu_torch.utils.bf16 import agreement
from tests import torch_golden
from tests.test_torch_mcts import jax_tables
from tests.test_torch_network import _flatten, _unflatten
from tests import test_torch_train as TT

torch.set_num_threads(1)

H = W = 9
FILTERS = 8
# one configuration per trunk family, heads chosen to cover every head
FAMILIES = {
    "resnet": dict(trunk="resnet", heads="pvq", raw_input=True),
    "bottleneck_v1": dict(trunk="bottleneck_v1", heads="pv", raw_input=True),
    "bottleneck_v2": dict(trunk="bottleneck_v2", heads="pvm", raw_input=False),
    "bottleneck_v3": dict(trunk="bottleneck_v3", heads="pv", raw_input=True),
    "transformer": dict(trunk="transformer", heads="pvqm", raw_input=False),
    "unet": dict(trunk="unet", heads="pv", raw_input=False),
    "unet_transformer": dict(trunk="unet_transformer", heads="pv", raw_input=False),
    "convnext_moe": dict(trunk="convnext_moe", heads="pvqm", raw_input=True),
    "convnext": dict(trunk="convnext", heads="pvqms", raw_input=True),
}
# the families whose blocks end in squeeze-excitation: its gate is
# torch.sigmoid, one rounding to bfloat16, where eager flax rounds each of
# 1 / (1 + exp(-x))'s steps; the gate scales a whole channel, so a gate an
# ulp apart moves every cell of it (about half the logits differ, by up to
# 6 ulps of 1/16).  The one-rounding gate is the ConvNext block's too,
# and tests/test_torch_train.py's bfloat16 gradient band holds it
# (the four-step gate puts one SE bias gradient outside it).  These two
# are held by tests/test_torch_network.py's rule for the module forward.
SE_FAMILIES = ("convnext", "convnext_moe")
TRAIN_FAMILIES = ("resnet", "bottleneck_v2", "transformer", "unet", "convnext_moe")
TRAIN_KEY = 1  # PRNGKey of the golden train step
TRAIN_BLOCKS = 2  # the train steps' block-stack depth (convnext_moe: a ConvNext and the MoE)


def _jax_net(family, dtype="bfloat16", blocks=1):
    import jax.numpy as jnp
    from alphagomoku_tpu.models.networks import AGNetwork, ModelConfig

    return AGNetwork(ModelConfig(**FAMILIES[family], blocks=blocks, filters=FILTERS,
                                 dtype=getattr(jnp, dtype)))


def _port_net(family, dtype=torch.bfloat16, blocks=1):
    cfg = TN.ModelConfig(**FAMILIES[family], blocks=blocks, filters=FILTERS, dtype=dtype)
    return TN.AGNetwork(cfg, H, W)


def _planes(family, seed=0):
    c = 8 if FAMILIES[family]["raw_input"] else 32
    return (np.random.default_rng(seed).random((4, H, W, c)) < 0.3).astype(np.float32)


def _jax_init(net):
    """flax's init of `net` from PRNGKey(0) (float32 parameters whatever
    the compute dtype)."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((1, H, W, net.cfg.input_planes), jnp.float32)
    v = jax.jit(lambda k: net.init(k, x, train=False))(jax.random.PRNGKey(0))
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


@functools.lru_cache(maxsize=None)
def _flax_init(family):
    """The 1-block network's flax init, shared by the family's tests."""
    return _jax_init(_jax_net(family))


def _host(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_flax(family):
    import jax
    import jax.numpy as jnp

    net = _jax_net(family)
    variables = _flax_init(family)
    x = _planes(family)
    ref = net.apply(variables, jnp.asarray(x), train=False)
    port = _port_net(family)
    port.load_state_dict(from_flax(_host(variables)))
    out = port(torch.from_numpy(x))
    for name in ref._fields:
        want = getattr(ref, name)
        assert (want is None) == (getattr(out, name) is None), name
        if want is None:
            continue
        want = np.asarray(want, np.float32)
        if family in SE_FAMILIES:
            scale = max(1e-3, float(np.abs(want).max()))
            assert np.abs(want - getattr(out, name).numpy()).max() <= 0.05 * scale + 5e-3, name
        else:
            stats = agreement(torch.from_numpy(want), getattr(out, name), **CF.HEAD_LIMITS)
            assert stats["ok"], (name, stats)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_forward_and_batch_stats_match_flax(family):
    import jax
    import jax.numpy as jnp

    net = _jax_net(family, "float32")
    variables = _flax_init(family)
    x = _planes(family, seed=1)
    ref, updated = jax.jit(lambda v, x: net.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    port = _port_net(family, torch.float32)
    port.load_state_dict(from_flax(_host(variables)))
    out = port.forward_train(torch.from_numpy(x))
    for name in ref._fields:
        want = getattr(ref, name)
        if want is not None:
            want = np.asarray(want)
            got = getattr(out, name).detach().numpy()
            assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), name
    want_stats = _flatten(_host(updated["batch_stats"]))
    got_stats = _flatten(to_flax(port.state_dict())["batch_stats"])
    assert sorted(want_stats) == sorted(got_stats)
    for key, want in want_stats.items():
        assert np.abs(got_stats[key] - want).max() <= 1e-3 * max(1.0, np.abs(want).max()), key
    assert any(not np.array_equal(v, _flatten(_host(variables["batch_stats"]))[k])
               for k, v in want_stats.items())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoint_bytes_are_flax_bytes(family):
    from flax import serialization

    host = _host(_flax_init(family))
    variables = {"params": host["params"], "batch_stats": host["batch_stats"]}
    port = _port_net(family)
    port.load_state_dict(from_flax(variables))
    assert checkpoint.to_bytes(to_flax(port.state_dict())) == serialization.to_bytes(variables)


def test_every_registry_name_builds_and_counts_its_blocks():
    for name in TN.list_architectures():
        net = TN.create_network(name, blocks=2, filters=FILTERS, rows=H, cols=W)
        flax_tree = to_flax(net.state_dict())
        back = network_from_flax(flax_tree, name, rows=H, cols=W)
        assert len(back.blocks) == len(net.blocks), name
        assert sorted(back.state_dict()) == sorted(net.state_dict()), name


def test_network_apply_picks_the_fused_trunk_for_convnext_only():
    for family in ("convnext", "convnext_moe", "resnet", "unet"):
        net = _port_net(family)
        apply, variables = network_apply(net)
        assert apply is net_apply_for(net.cfg)
        if family == "convnext":
            assert apply is CF.fused_apply and isinstance(variables, CF.FusedWeights)
        else:
            assert apply is module_apply and variables is not net
            assert not any(p.requires_grad for p in variables.parameters())
            x = torch.from_numpy(_planes(family))
            for got, want in zip(apply(variables, x), net(x)):
                assert (got is None and want is None) or torch.equal(got, want)


# ---------------------------------------------------------------------------
# One train step per family, held to the golden zoo_train_steps
# ---------------------------------------------------------------------------


EXACT = "float64"  # the reference of the port's float32 step
ZOO_DTYPES = ("bfloat16", EXACT)


def jax_zoo_train_steps() -> dict:
    """The golden zoo_train_steps: for each family of TRAIN_FAMILIES, one
    JAX train step (key TRAIN_KEY) from one flax init (PRNGKey(0)) of a
    TRAIN_BLOCKS x FILTERS network on tests/test_torch_train.py's
    `sample_batch()`, in bfloat16 and in float64: the modes it draws, its
    losses, gradients, parameters and BatchNorm statistics after it.  The
    exact step is JAX's in float64 because XLA's own float32 step is not
    exact enough to hold the port's to: on the resnet family its
    gradients are 3% to 7% (relative L2) from the float64 ones, the
    port's float32 gradients within 1e-4."""
    import jax
    import jax.numpy as jnp
    import optax
    from alphagomoku_tpu.training import train as JT

    tables = jax_tables(GameRules.FREESTYLE)
    key = jax.random.PRNGKey(TRAIN_KEY)
    out = {"modes": np.asarray(jax.random.randint(key, (TT.B,), 0, 8))}
    randint = jax.random.randint

    def randint32(key, shape, lo, hi, dtype=jnp.int32):
        """The step's symmetry draw at int32 under x64 too: the same modes."""
        return randint(key, shape, lo, hi, dtype)

    for family in TRAIN_FAMILIES:
        variables = _jax_init(_jax_net(family, blocks=TRAIN_BLOCKS))
        out.update({f"{family}.init/{k}": v for k, v in _flatten(_host(variables)).items()})
        for dtype in ZOO_DTYPES:
            with jax.enable_x64(dtype == EXACT):
                jax.random.randint = randint32
                net = _jax_net(family, dtype, TRAIN_BLOCKS)
                wide = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
                v = wide(variables) if dtype == EXACT else variables
                batch = {k: jnp.asarray(a) for k, a in TT.sample_batch().items()}
                cfg = JT.TrainConfig()
                inner = optax.chain(optax.add_decayed_weights(cfg.l2_regularization),
                                    optax.radam(cfg.learning_rate))
                tx = optax.GradientTransformation(
                    lambda p: (inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
                    lambda g, s, p=None: (lambda u, s0: (u, (s0, g)))(*inner.update(g, s[0], p)),
                )
                state = JT.TrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                                      jnp.zeros((), jnp.int32))
                try:
                    state, parts = jax.jit(JT.make_train_step(net, tx, tables, cfg))(
                        state, batch, key)
                finally:
                    jax.random.randint = randint
                out.update({f"{family}.{dtype}.loss.{k}": np.asarray(x, np.float32)
                            for k, x in parts.items()})
                out.update({f"{family}.{dtype}/{k}": x for k, x in _flatten(_host(
                    {"params": state.params, "batch_stats": state.batch_stats,
                     "grads": state.opt_state[1]})).items()})
    return out


def _zoo_step(family, dtype, golden, ref):
    init = TT._sub(golden, f"{family}.init/")
    net = _port_net(family, getattr(torch, dtype), TRAIN_BLOCKS)
    net.load_state_dict(from_flax(_unflatten(init)))
    cfg = T.TrainConfig()
    state, tx = T.create_train_state(net, cfg)
    step = T.make_train_step(net, tx, TV.device_tables(GameRules.FREESTYLE), cfg)
    _, parts = step(state, TT._torch_batch(), torch.from_numpy(golden["modes"]))
    TT._check_losses(TT._sub(golden, f"{family}.{ref}.loss."), parts)
    return net, init


@pytest.mark.parametrize("family", TRAIN_FAMILIES)
def test_train_step_matches_jax(family):
    """float32 against JAX's float64 step at the math's tolerances
    (tests/test_torch_train.py's `_check_f32`), and bfloat16 against JAX's
    bfloat16 noise (`_check_bf16`)."""
    golden = torch_golden.load("zoo_train_steps")
    exact = TT._sub(golden, f"{family}.{EXACT}/")
    net, init = _zoo_step(family, "float32", golden, EXACT)
    TT._check_f32(exact, init, net)
    net, _ = _zoo_step(family, "bfloat16", golden, "bfloat16")
    _check_bf16(TT._sub(golden, f"{family}.bfloat16/"), exact, net)


def _check_bf16(want: dict, exact: dict, net):
    """bfloat16: tests/test_torch_train.py's statistics bound (1e-2 of
    JAX's) and its bound over all tensors (the port's gradients within 1.25
    times JAX's bfloat16 distance from the exact ones).  Its per-tensor
    band (twice JAX's distance) was set on the 2x16 convnext and does not
    carry to these 1 to 2 block, 8-filter networks, whose tensors hold a few
    channels each: there JAX's own per-tensor distances reach 0.45 (unet),
    and the port, which rounds every op to bfloat16 where XLA's compiled
    step keeps float32 across fused elementwise ops, reaches 0.80 on one BN
    bias of 4 channels (bottleneck_v2) where JAX has 0.24.  The float32
    check holds each tensor."""
    ours = TT._port_flat(net)
    assert sorted(ours) == sorted(want)
    for k, v in TT._part(want, "batch_stats").items():
        assert TT._rel(v, ours[k]) <= 1e-2, (k, TT._rel(v, ours[k]))
    grads = sorted(TT._part(want, "grads"))
    flat = lambda t: np.concatenate([t[k].ravel() for k in grads])
    d_jax, d_port = TT._rel(flat(exact), flat(want)), TT._rel(flat(exact), flat(ours))
    assert d_port <= 1.25 * d_jax, (d_port, d_jax)


# ---------------------------------------------------------------------------
# The entry points take any architecture
# ---------------------------------------------------------------------------


def test_manager_trains_a_resnet_distilled_from_a_unet(tmp_path):
    """The trainer with a resnet network: its searches' pair is
    `module_apply` on a fresh snapshot, and a train iteration distils it
    from a ConvUnet teacher of another architecture (on tests/
    test_torch_train.py's batch, as one generation of the buffer)."""
    from alphagomoku_tpu_torch.training import manager as TMGR

    teacher = TN.init_flax_(TN.create_network("ConvUnet", filters=FILTERS, rows=H, cols=W),
                            torch.Generator().manual_seed(1))
    checkpoint.save(str(tmp_path / "teacher.msgpack"), to_flax(teacher.state_dict()))
    cfg = TMGR.ManagerConfig(
        working_dir=str(tmp_path / "run"), rows=H, cols=W, architecture="ResnetPVraw", blocks=1,
        filters=FILTERS, train_steps_per_iteration=2, train_batch_size=8,
        distill_from=str(tmp_path / "teacher.msgpack"), distill_architecture="ConvUnet",
        distill_filters=FILTERS)
    mgr = TMGR.TrainingManager(cfg, device="cpu")
    snap = mgr._host_vars()
    assert mgr._apply is module_apply and snap is not mgr.net
    batch = TT.sample_batch()
    B = len(batch["stm"])
    mgr.buffer.add_generation(0, dict(batch, root_value=np.zeros(B, np.float32),
                                      played_move=np.zeros(B, np.int32)))
    before = {k: v.clone() for k, v in mgr.net.state_dict().items()}
    losses = mgr.train_iteration(1)
    assert mgr._distill[1].cfg.trunk == "unet" and np.isfinite(list(losses.values())).all()
    assert mgr.metadata["learning_steps"] == 2
    assert any(not torch.equal(before[k], v) for k, v in mgr.net.state_dict().items())
    assert all(torch.equal(before[k], v) for k, v in snap.state_dict().items())
    back = network_from_flax(checkpoint.load(mgr.checkpoint_path(1)), "ResnetPVraw", H, W)
    for k, v in mgr.net.state_dict().items():
        assert torch.equal(back.state_dict()[k], v.float()), k


def test_nn_benchmark_measures_a_unet(tmp_path):
    from alphagomoku_tpu_torch.engine.benchmark import run_benchmark

    report = run_benchmark("TransformerUnet", 1, FILTERS, H, W, seconds_per_point=0.01,
                           output_path=str(tmp_path / "benchmark.json"), batch_sizes=(1, 2),
                           device="cpu")
    assert report["architecture"] == "TransformerUnet"
    assert [r["batch_size"] for r in report["results"]] == [1, 2]
    assert all(r["samples_per_second"] > 0 for r in report["results"])
