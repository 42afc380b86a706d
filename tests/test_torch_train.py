"""The port's training step held against the JAX package's: the RAdam
optimizer against optax (live), the schedules and the SWA average (live),
and the train, eval and distill steps of a ConvNextPVQMraw 2x16 on 9x9
boards from one flax init (goldens `train_steps`, `distill_step`, with the
symmetry modes JAX draws from its keys injected into the port).

The steps are held twice.  In float32 (both networks built with a float32
compute dtype) at the tolerances of the math: per-head losses within
1e-2 max(1, |loss|); each gradient tensor within 3e-2 relative L2; the
BatchNorm statistics after a step within 1e-2 relative L2; the parameters
after each step within 3e-2 of their change, relative L2 (norms floored at
1e-3 of the largest tensor's: a gradient that sums to 0 in exact
arithmetic, as the policy output's bias, has no relative precision).  In
bfloat16, the networks that train, at the same loss and statistics
tolerances, but the gradients only as close to the float32 ones as the
JAX package's own bfloat16 gradients are: rounding a 2x16 trunk's
activations to bfloat16 moves the gradients by 5% to 40% per tensor in
either framework (14% over all tensors in JAX), so no bfloat16 port can
sit within 3e-2 of JAX's bfloat16 gradients (`_check_bf16`).  Top-k accuracies within one
sample (a bfloat16 near-tie between two logits may order them otherwise).
"""

import numpy as np
import pytest
import torch

from alphagomoku_tpu.game.types import CIRCLE, CROSS, GameRules

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.models.convert import from_flax, to_flax
from alphagomoku_tpu_torch.models.networks import create_network
from alphagomoku_tpu_torch.training import train as T
from tests import torch_golden
from tests.test_torch_mcts import jax_tables
from tests.test_torch_network import _flatten, _unflatten

torch.set_num_threads(1)

H = W = 9
B = 16
ARCH = "ConvNextPVQMraw"
STEP_KEYS = (1, 2)  # PRNGKey of each train step
DTYPES = ("bfloat16", "float32")
DISTILL_KEY = 4


def sample_batch(seed: int = 0) -> dict:
    """B training samples as `make_targets` gives them: boards of 2 to 30
    alternating stones, a visit distribution over some empty cells (all
    zero on two samples, as on proven roots), one-hot value targets, Q
    targets on a mask of empty cells, moves-left buckets; two samples not
    valid."""
    rng = np.random.default_rng(seed)
    board = np.zeros((B, H, W), np.int8)
    stm = np.zeros(B, np.int8)
    for i in range(B):
        n = int(rng.integers(2, 31))
        cells = rng.choice(H * W, size=n, replace=False)
        board[i].flat[cells] = np.where(np.arange(n) % 2 == 0, CROSS, CIRCLE)
        stm[i] = CROSS if n % 2 == 0 else CIRCLE
    empty = board == 0
    visits = np.where(empty & (rng.random((B, H, W)) < 0.2), rng.integers(1, 50, (B, H, W)), 0)
    visits[:2] = 0
    policy = (visits / np.maximum(visits.sum((1, 2), keepdims=True), 1)).astype(np.float32)
    win = rng.random((B, H, W)).astype(np.float32)
    draw = ((1 - win) * rng.random((B, H, W))).astype(np.float32)
    valid = np.ones(B, bool)
    valid[[5, 11]] = False
    return {
        "board": board, "stm": stm, "policy": policy,
        "value_wdl": np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)],
        "q_value": np.stack([win, draw], -1),
        "q_mask": empty & (rng.random((B, H, W)) < 0.3),
        "moves_left": rng.integers(0, H * W, B).astype(np.int32),
        "valid": valid,
    }


def _jax_setup(blocks: int = 2, seed: int = 0, dtype: str = "bfloat16"):
    import jax
    import jax.numpy as jnp
    import optax
    from alphagomoku_tpu.models import create_network as jax_create_network
    from alphagomoku_tpu.training import train as JT

    net = jax_create_network(ARCH, blocks=blocks, filters=16, dtype=getattr(jnp, dtype))
    variables = jax.jit(lambda k: net.init(k, jnp.zeros((1, H, W, 8)), train=False))(
        jax.random.PRNGKey(seed))
    cfg = JT.TrainConfig()
    inner = optax.chain(optax.add_decayed_weights(cfg.l2_regularization),
                        optax.radam(cfg.learning_rate))
    # the real transformation, with each step's gradients kept in its state
    tx = optax.GradientTransformation(
        lambda p: (inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        lambda g, s, p=None: (lambda u, s0: (u, (s0, g)))(*inner.update(g, s[0], p)),
    )
    state = JT.TrainState(variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    return net, variables, cfg, tx, state


def _host(tree) -> dict:
    import jax

    return _flatten(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree))


def jax_train_steps() -> dict:
    """The golden train_steps: for each compute dtype, two JAX train steps
    (keys STEP_KEYS) from one flax init (PRNGKey(0)) on `sample_batch()`:
    the modes each step draws, its losses, gradients, parameters and
    BatchNorm statistics after it; and the bfloat16 eval step on the init."""
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.training import train as JT

    tables = jax_tables(GameRules.FREESTYLE)
    batch = {k: jnp.asarray(v) for k, v in sample_batch().items()}
    out = {}
    for dtype in DTYPES:
        net, variables, cfg, tx, state = _jax_setup(dtype=dtype)
        out.update({f"init/{k}": v for k, v in _host(
            {"params": variables["params"], "batch_stats": variables["batch_stats"]}).items()})
        if dtype == "bfloat16":
            evals = jax.jit(JT.make_eval_step(net, tables, cfg))(state, batch)
            out.update({f"eval.{k}": np.asarray(v) for k, v in evals.items()})
        step = jax.jit(JT.make_train_step(net, tx, tables, cfg))
        for i, seed in enumerate(STEP_KEYS):
            key = jax.random.PRNGKey(seed)
            out[f"step{i}.modes"] = np.asarray(jax.random.randint(key, (B,), 0, 8))
            state, parts = step(state, batch, key)
            out.update({f"{dtype}.step{i}.loss.{k}": np.asarray(v) for k, v in parts.items()})
            out.update({f"{dtype}.step{i}/{k}": v for k, v in _host(
                {"params": state.params, "batch_stats": state.batch_stats,
                 "grads": state.opt_state[1]}).items()})
    return out


def jax_distill_step() -> dict:
    """The golden distill_step: for each compute dtype, one JAX
    distillation step (key DISTILL_KEY) of the 2x16 student from the same
    init toward a 1x16 teacher (flax init PRNGKey(3)) on `sample_batch()`."""
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.training import train as JT

    tables = jax_tables(GameRules.FREESTYLE)
    batch = {k: jnp.asarray(v) for k, v in sample_batch().items()}
    key = jax.random.PRNGKey(DISTILL_KEY)
    out = {"modes": np.asarray(jax.random.randint(key, (B,), 0, 8))}
    for dtype in DTYPES:
        net, _, cfg, tx, state = _jax_setup(dtype=dtype)
        teacher, t_vars, *_ = _jax_setup(blocks=1, seed=3, dtype=dtype)
        out.update({f"teacher/{k}": v for k, v in _host(
            {"params": t_vars["params"], "batch_stats": t_vars["batch_stats"]}).items()})
        step = jax.jit(JT.make_distill_step(net, teacher, tx, tables, cfg))
        state, parts = step(state, t_vars, batch, key)
        out.update({f"{dtype}.loss.{k}": np.asarray(v) for k, v in parts.items()})
        out.update({f"{dtype}/{k}": v for k, v in _host(
            {"params": state.params, "batch_stats": state.batch_stats,
             "grads": state.opt_state[1]}).items()})
    return out


def _sub(golden: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in golden.items() if k.startswith(prefix)}


def _net(variables: dict, blocks: int = 2, dtype: str = "bfloat16"):
    net = create_network(ARCH, blocks=blocks, filters=16, rows=H, cols=W,
                         dtype=getattr(torch, dtype))
    net.load_state_dict(from_flax(variables))
    return net


def _torch_batch() -> dict:
    return {k: torch.from_numpy(v) for k, v in sample_batch().items()}


def _floor(tree: dict) -> float:
    """1e-3 of the largest tensor norm of `tree`: the floor of the norms
    that relative errors divide by."""
    return 1e-3 * max(float(np.linalg.norm(v)) for v in tree.values())


def _rel(a: np.ndarray, b: np.ndarray, scale: np.ndarray | None = None,
         floor: float = 1e-30) -> float:
    den = np.linalg.norm(a if scale is None else scale)
    return float(np.linalg.norm(a.astype(np.float64) - b) / max(den, floor))


def _check_losses(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-2 * max(1.0, abs(float(v))), (k, got[k], v)


def _port_flat(net) -> dict:
    """The port's parameters, statistics and gradients under the flax
    tree's flat keys."""
    grads = to_flax({k: p.grad for k, p in net.named_parameters()})["params"]
    return _flatten({**to_flax(net.state_dict()), "grads": grads})


def _part(tree: dict, coll: str) -> dict:
    return {k: v for k, v in tree.items() if k.startswith(coll + "/")}


def _check_f32(want: dict, before: dict, net):
    """float32: gradients within 3e-2, statistics within 1e-2, parameters
    within 3e-2 of their change, each tensor relative L2."""
    ours = _port_flat(net)
    assert sorted(ours) == sorted(want)
    floors = {c: _floor(_part(want, c)) for c in ("grads", "batch_stats", "params")}
    for k, v in want.items():
        coll = k.split("/")[0]
        if coll == "params":
            change = v.astype(np.float64) - before[k]
            if not np.abs(change).any():  # a head the loss does not read
                assert np.array_equal(v, ours[k]), k
                continue
            err = _rel(v, ours[k], change, 1e-3 * floors[coll])
        else:
            err = _rel(v, ours[k], floor=floors[coll])
        assert err <= (1e-2 if coll == "batch_stats" else 3e-2), (k, err)


BF16_GRAD_FLOOR = 0.1  # a tensor's distance from float32 always allowed
BF16_GRAD_CAP = 0.5  # a tensor's distance from float32 never allowed


def _check_bf16(want: dict, exact: dict, net):
    """bfloat16: statistics within 1e-2 of JAX's; the gradients no farther
    from the float32 ones (`exact`) than JAX's bfloat16 gradients are: over
    all tensors within 1.25 times JAX's distance; each tensor, whose
    distance is one draw of the rounding noise, within twice JAX's,
    at least BF16_GRAD_FLOOR and at most BF16_GRAD_CAP.  On this golden
    the port's per-tensor distances reach 0.28 and JAX's 0.79 (two head
    biases, whose port distances are 0.07 to 0.09), so the cap is what
    binds where JAX's own gradient is that noisy; a bound on the direct
    distance from JAX's bfloat16 gradient would have to allow 0.6 there.
    A wrong gradient is off by about its whole norm, a distance near 1."""
    ours = _port_flat(net)
    assert sorted(ours) == sorted(want)
    for k, v in _part(want, "batch_stats").items():
        assert _rel(v, ours[k]) <= 1e-2, (k, _rel(v, ours[k]))
    grads = sorted(_part(want, "grads"))
    floor = _floor(_part(exact, "grads"))
    for k in grads:
        d_jax, d_port = _rel(exact[k], want[k], floor=floor), _rel(exact[k], ours[k], floor=floor)
        assert d_port <= min(max(2 * d_jax, BF16_GRAD_FLOOR), BF16_GRAD_CAP), (k, d_port, d_jax)
    flat = lambda t: np.concatenate([t[k].ravel() for k in grads])
    d_jax, d_port = _rel(flat(exact), flat(want)), _rel(flat(exact), flat(ours))
    assert d_port <= 1.25 * d_jax, (d_port, d_jax)


def _train(dtype: str, golden: dict):
    net = _net(_unflatten(_sub(golden, "init/")), dtype=dtype)
    cfg = T.TrainConfig()
    state, tx = T.create_train_state(net, cfg)
    return net, state, T.make_train_step(net, tx, TV.device_tables(GameRules.FREESTYLE), cfg)


def test_train_steps_match_jax_float32():
    golden = torch_golden.load("train_steps")
    net, state, step = _train("float32", golden)
    batch = _torch_batch()
    before = _sub(golden, "init/")
    for i in range(len(STEP_KEYS)):
        modes = torch.from_numpy(golden[f"step{i}.modes"])
        assert len(set(modes.tolist())) >= 5  # the batch takes most symmetries
        state, parts = step(state, batch, modes)
        _check_losses(_sub(golden, f"float32.step{i}.loss."), parts)
        after = _sub(golden, f"float32.step{i}/")
        _check_f32(after, before, net)
        before = {k: v for k, v in after.items() if not k.startswith("grads/")}
    assert state.step == len(STEP_KEYS) and state.opt_state.count == len(STEP_KEYS)
    assert net.training


def test_train_steps_match_jax_bfloat16():
    golden = torch_golden.load("train_steps")
    net, state, step = _train("bfloat16", golden)
    batch = _torch_batch()
    for i in range(len(STEP_KEYS)):
        state, parts = step(state, batch, torch.from_numpy(golden[f"step{i}.modes"]))
        _check_losses(_sub(golden, f"bfloat16.step{i}.loss."), parts)
        _check_bf16(_sub(golden, f"bfloat16.step{i}/"), _sub(golden, f"float32.step{i}/"), net)
    assert net.training


def test_eval_step_matches_jax():
    golden = torch_golden.load("train_steps")
    net = _net(_unflatten(_sub(golden, "init/")))
    cfg = T.TrainConfig()
    state, _ = T.create_train_state(net, cfg)
    parts = T.make_eval_step(net, TV.device_tables(GameRules.FREESTYLE), cfg)(
        state, _torch_batch())
    want = _sub(golden, "eval.")
    assert sorted(parts) == sorted(want)
    n_valid = int(sample_batch()["valid"].sum())
    for k, v in want.items():
        if k.endswith("accuracy"):
            assert abs(float(parts[k]) - float(v)) <= 1.0 / n_valid + 1e-6, (k, parts[k], v)
        else:
            assert abs(float(parts[k]) - float(v)) <= 1e-2 * max(1.0, abs(float(v))), k
    # the statistics are the running ones: eval moves nothing
    assert torch.equal(net.blocks[0].bn.running_mean, torch.zeros(16))


@pytest.mark.parametrize("dtype", DTYPES)
def test_distill_step_matches_jax(dtype):
    golden = torch_golden.load("distill_step")
    init = _sub(torch_golden.load("train_steps"), "init/")
    net = _net(_unflatten(init), dtype=dtype)
    teacher = _net(_unflatten(_sub(golden, "teacher/")), blocks=1, dtype=dtype)
    cfg = T.TrainConfig()
    state, tx = T.create_train_state(net, cfg)
    step = T.make_distill_step(net, teacher, tx, TV.device_tables(GameRules.FREESTYLE), cfg)
    state, parts = step(state, teacher, _torch_batch(), torch.from_numpy(golden["modes"]))
    _check_losses(_sub(golden, f"{dtype}.loss."), parts)
    if dtype == "float32":
        _check_f32(_sub(golden, "float32/"), init, net)
    else:
        _check_bf16(_sub(golden, "bfloat16/"), _sub(golden, "float32/"), net)


def test_losses_mask_illegal_cells_without_nan():
    """A zero target on an illegal cell contributes 0 (the logits are
    masked with -1e9, not -inf), also for an all-zero policy row."""
    from alphagomoku_tpu_torch.models.networks import NetOutput

    bsz = 3
    logits = torch.zeros((bsz, H, W), requires_grad=True)
    legal = torch.zeros((bsz, H, W), dtype=torch.bool)
    legal[:, :2] = True
    policy = torch.zeros((bsz, H, W))
    policy[0, 0, 0] = 1.0
    out = NetOutput(logits, torch.zeros((bsz, 3)), None, None, logits * 1.0)
    batch = {"policy": policy, "value_wdl": torch.eye(3), "valid": torch.ones(bsz, dtype=bool)}
    total, parts = T._losses(out, batch, T.TrainConfig(), legal)
    total.backward()
    assert all(torch.isfinite(v) for v in parts.values())
    assert torch.isfinite(logits.grad).all()
    assert float(parts["policy"].detach()) == pytest.approx(np.log(2 * W) / bsz, rel=1e-6)


def test_radam_matches_optax():
    """The port's optimizer against optax.chain(add_decayed_weights(1e-4),
    radam(1e-3)) on the same gradients for 10 steps: the rectifier turns
    on at step 6 (ro >= 5), where float32's cancellation moves it by about
    1% from float64's; each tensor within 1e-6 relative."""
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    shapes = [(16, 8, 3, 3), (16,), (81, 128)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
              for s in shapes] for _ in range(10)]
    tx = optax.chain(optax.add_decayed_weights(1e-4), optax.radam(1e-3))
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    ours = [torch.from_numpy(p.copy()) for p in params]
    radam = T.RAdam(1e-3, 1e-4)
    st = radam.init(ours)
    rectified = []
    for g in grads:
        u, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
        st = radam.step(ours, [torch.from_numpy(x) for x in g], st)
        rectified.append(radam._scalars(st.count)[2] is not None)
        for a, b in zip(jp, ours):
            a = np.asarray(a)
            assert _rel(a, b.numpy()) <= 1e-6
            assert np.abs(a - b.numpy()).max() <= 1e-6 * np.abs(a).max()
    assert rectified == [False] * 5 + [True] * 5


def test_radam_schedule_reads_count_from_zero():
    seen = []
    radam = T.RAdam(lambda c: seen.append(c) or 1e-3)
    p = [torch.ones(3)]
    st = radam.init(p)
    for _ in range(3):
        st = radam.step(p, [torch.ones(3)], st)
    assert seen == [0, 1, 2]


@pytest.mark.parametrize("interpolation", ["none", "linear", "cosine"])
def test_schedule_matches_jax(interpolation):
    from alphagomoku_tpu.training import train as JT

    points = [(0, 1e-3), (100, 5e-4), (250, 1e-4), (400, 1e-4)]
    jf = JT.schedule(points, interpolation)
    tf = T.schedule(points, interpolation)
    for step in (-5, 0, 1, 37, 99.5, 100, 101, 180, 250, 399, 400, 1000):
        a, b = float(jf(step)), float(tf(step))
        assert b == pytest.approx(a, rel=1e-6, abs=1e-12), (step, a, b)


def test_average_params_matches_jax():
    import jax.numpy as jnp
    from alphagomoku_tpu.training import train as JT

    rng = np.random.default_rng(1)
    trees = [{"a": {"k": rng.normal(size=(4, 3)).astype(np.float32)},
              "b": rng.normal(size=(5,)).astype(np.float32)} for _ in range(3)]
    want = JT.average_params([{"a": {"k": jnp.asarray(t["a"]["k"])}, "b": jnp.asarray(t["b"])}
                              for t in trees])
    got = T.average_params(trees)
    assert np.array_equal(np.asarray(want["a"]["k"]), got["a"]["k"])
    assert np.array_equal(np.asarray(want["b"]), got["b"])
    tensors = T.average_params([{k: torch.from_numpy(v) for k, v in _flatten(t).items()}
                                for t in trees])
    assert np.array_equal(tensors["b"].numpy(), got["b"])


def test_draw_modes_are_seeded_and_in_range():
    a = T.draw_modes(torch.Generator().manual_seed(0), 64, 15, 15)
    b = T.draw_modes(torch.Generator().manual_seed(0), 64, 15, 15)
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) == 7
    assert int(T.draw_modes(torch.Generator().manual_seed(0), 64, 12, 15).max()) == 3
