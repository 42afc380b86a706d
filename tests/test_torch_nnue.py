"""The port's NNUE (`models/nnue.py`) held against the JAX package's on the
same numpy-seeded inputs: `nnue_features` and `nnue_policy_planes`
bit-equal (freestyle and renju), `quantize` and the two int32
accumulators bit-equal, the f32 tail within 2e-6 relative, the f32 models
read from flax variables within float32's summation noise of flax's
forward (and the policy model's train-mode batch statistics); the int8
products exact past 2^24; training lowers the loss and the quantized net
agrees with its f32 model as the JAX package's test asks.  The blended
search is `tests/test_torch_search_options.py`'s golden `options_nnue`.
"""

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.game.types import CIRCLE, CROSS, GameRules
from alphagomoku_tpu_torch.models import nnue as TN

torch.set_num_threads(1)

H = W = 9
REL = 2e-6


def random_boards(n, seed=0, rows=H, cols=W):
    """The JAX package's test generator: 0-29 alternating stones."""
    rng = np.random.default_rng(seed)
    boards = np.zeros((n, rows, cols), np.int8)
    for b in range(n):
        k = rng.integers(0, 30)
        cells = rng.choice(rows * cols, size=k, replace=False)
        boards[b].flat[cells] = np.where(np.arange(k) % 2 == 0, CROSS, CIRCLE)
    stm = np.where(rng.random(n) < 0.5, CROSS, CIRCLE).astype(np.int8)
    return boards, stm


def seeded_variables(features: int, hidden: int, seed: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    dims = ((features, hidden), (hidden, hidden), (hidden, 3))
    return {"params": {f"Dense_{i}": {
        "kernel": (rng.standard_normal(d) / np.sqrt(d[0])).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(d[1])).astype(np.float32)}
        for i, d in enumerate(dims)}}


@pytest.mark.parametrize("rules", [GameRules.FREESTYLE, GameRules.RENJU])
def test_features_and_policy_planes_bit_equal(rules):
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.models import nnue as JN
    from tests.test_torch_mcts import jax_tables

    boards, stm = random_boards(24, seed=1)
    boards[0] = 0
    boards[0, 4, 3:6] = CROSS  # an open three: OPEN_4 cells for cross
    jt, tt = jax_tables(rules), TV.device_tables(rules)
    jb, js = jnp.asarray(boards), jnp.asarray(stm)
    want = np.asarray(jax.jit(lambda b, s: JN.nnue_features(jt, b, s))(jb, js))
    got = TN.nnue_features(tt, torch.from_numpy(boards), torch.from_numpy(stm)).numpy()
    assert got.shape == (24, TN.num_features(H, W)) and np.array_equal(got, want)
    assert got[0, 1 + (4 * W + 2) * 16 + 5] == 1.0
    want = np.asarray(jax.jit(lambda b, s: JN.nnue_policy_planes(jt, b, s))(jb, js))
    got = TN.nnue_policy_planes(tt, torch.from_numpy(boards), torch.from_numpy(stm)).numpy()
    assert got.shape == (24, H, W, 16) and np.array_equal(got, want)
    assert got[..., :14].sum() > 0


def _jax_accumulators(q, feats):
    """The int32 accumulators of the JAX package's quantized_apply (its
    `int8_dense`, a closure, transcribed on the same arrays)."""
    import jax
    import jax.numpy as jnp

    def int8_dense(x, w, s, b):
        a_scale = jnp.maximum(jnp.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
        x_q = jnp.round(x / a_scale).astype(jnp.int8)
        acc = jax.lax.dot_general(x_q, jnp.asarray(w), (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        return acc.astype(jnp.float32) * a_scale * jnp.asarray(s)[None] + jnp.asarray(b)[None], acc

    x, acc0 = int8_dense(jnp.asarray(feats), q.w0, q.s0, q.b0)
    _, acc1 = int8_dense(jax.nn.relu(x), q.w1, q.s1, q.b1)
    return np.asarray(acc0), np.asarray(acc1)


@pytest.mark.parametrize("rows", [9, 15])
def test_quantize_accumulators_and_tail_match_jax(rows):
    import jax.numpy as jnp
    from alphagomoku_tpu.models import nnue as JN

    variables = seeded_variables(TN.num_features(rows, rows), 32)
    jq, tq = JN.quantize(variables), TN.quantize(variables)
    for name in jq._fields:
        a, b = getattr(jq, name), getattr(tq, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    boards, stm = random_boards(16, seed=2, rows=rows, cols=rows)
    feats = TN.nnue_features(TV.device_tables(GameRules.FREESTYLE), torch.from_numpy(boards),
                             torch.from_numpy(stm))
    acc0, acc1, logits = TN.quantized_accumulators(tq.to("cpu"), feats)
    want0, want1 = _jax_accumulators(jq, feats.numpy())
    assert acc0.dtype == torch.int32 and np.array_equal(acc0.numpy(), want0)
    assert np.array_equal(acc1.numpy(), want1)
    want = np.asarray(JN.quantized_apply(jq, jnp.asarray(feats.numpy())))
    assert np.allclose(logits.numpy(), want, rtol=REL, atol=REL)
    ev = TN.evaluate_features(tq, feats).numpy()
    assert np.allclose(ev, np.asarray(JN.evaluate_features(jq, jnp.asarray(feats.numpy()))),
                       rtol=REL, atol=REL)


def test_int8_products_accumulate_exactly_past_2_24():
    """At 15x15 (F = 3,601) a sum of int8 products reaches 127 * 127 *
    3,601 = 58,080,529 > 2^24: exact, where a float32 sum would round."""
    f = TN.num_features(15, 15)
    w = np.full((f, 4), 127, np.int8)
    w[::7, 1] = -128
    x = torch.ones((3, f))
    x[1, ::3] = 0.5
    _, acc = TN._int8_dense(x, torch.from_numpy(w), torch.ones(4), torch.zeros(4))
    x_q = torch.round(x / (x.abs().amax(-1, keepdim=True) / 127.0)).to(torch.int64)
    want = x_q.numpy() @ w.astype(np.int64)
    assert want.max() > 2**24 and np.array_equal(acc.numpy(), want)


def test_models_match_flax_forward():
    """NNUEModel and NNUEPolicyModel read from flax variables: the flax
    forward's outputs within 1e-5 (f32 sums in another order), and the
    policy model's train-mode step moves its batch statistics as flax's."""
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.models import nnue as JN

    boards, stm = random_boards(16, seed=3)
    tables = TV.device_tables(GameRules.FREESTYLE)
    feats = TN.nnue_features(tables, torch.from_numpy(boards), torch.from_numpy(stm))
    jmodel = JN.NNUEModel(16)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(1), feats[:1].numpy()))
    want = np.asarray(jmodel.apply(variables, feats.numpy()))
    model = TN.NNUEModel.from_variables(variables)
    assert np.allclose(model(feats).detach().numpy(), want, rtol=1e-5, atol=1e-5)
    back = model.variables()
    assert all(np.array_equal(back["params"][k][n], variables["params"][k][n])
               for k in back["params"] for n in ("kernel", "bias"))

    planes = TN.nnue_policy_planes(tables, torch.from_numpy(boards), torch.from_numpy(stm))
    jp = JN.NNUEPolicyModel((8, 8, 1))
    pv = jax.tree_util.tree_map(np.asarray, jp.init(jax.random.PRNGKey(2), planes[:1].numpy()))
    pmodel = TN.NNUEPolicyModel.from_variables(pv, (8, 8, 1))
    want = np.asarray(jp.apply(pv, planes.numpy()))
    assert np.allclose(pmodel(planes).detach().numpy(), want, rtol=1e-5, atol=1e-5)
    want_t, upd = jp.apply(pv, planes.numpy(), train=True, mutable=["batch_stats"])
    got_t = pmodel(planes, train=True).detach().numpy()
    assert np.allclose(got_t, np.asarray(want_t), rtol=1e-4, atol=1e-4)
    stats = pmodel.variables()["batch_stats"]
    for scope, d in upd["batch_stats"].items():
        for n in ("mean", "var"):
            assert np.allclose(stats[scope][n], np.asarray(d[n]), rtol=1e-5, atol=1e-6)


def test_training_and_quantized_agreement():
    """The JAX package's test on the port: fit a synthetic threat-margin
    target, then the quantized net agrees with the f32 model."""
    tables = TV.device_tables(GameRules.FREESTYLE)
    boards, stm = random_boards(256, seed=1)
    feats = TN.nnue_features(tables, torch.from_numpy(boards), torch.from_numpy(stm))
    cells = feats[:, 1:].reshape(feats.shape[0], -1, 16).numpy()
    margin = (cells[:, :, 0:7].sum((1, 2)) - cells[:, :, 7:14].sum((1, 2))) / 4.0
    win = 1 / (1 + np.exp(-margin))
    targets = torch.from_numpy(np.stack([win, np.full_like(win, 0.05), 1 - win - 0.05], -1))
    variables, loss = TN.train_nnue(feats, targets.float(), steps=300)
    fp = TN.NNUEModel.from_variables(variables)(feats).detach().numpy()
    q = TN.quantize(variables)
    ql = TN.quantized_apply(q, feats).numpy()
    assert (fp.argmax(-1) == ql.argmax(-1)).mean() > 0.85
    assert np.corrcoef(fp[:, 0], ql[:, 0])[0, 1] > 0.98
    pred = torch.softmax(torch.from_numpy(ql), -1)[:, 0].numpy()
    assert np.corrcoef(pred, win)[0, 1] > 0.7
    q2, loss2 = TN.train_from_replay(tables, boards[:8], stm[:8], targets[:8].float(), steps=5)
    assert np.isfinite(loss2) and q2.w0.dtype == np.int8


def test_policy_nnue_training_lowers_the_loss():
    b = np.zeros((1, H, W), np.int8)
    b[0, 4, 2:5] = CROSS
    b[0, 0, 0] = CIRCLE
    tgt = np.zeros((1, H, W), np.float32)
    tgt[0, 4, 1] = tgt[0, 4, 5] = 0.5
    variables, loss = TN.train_nnue_policy(
        TV.device_tables(GameRules.FREESTYLE), torch.from_numpy(b),
        torch.tensor([CROSS], dtype=torch.int8), torch.from_numpy(tgt), steps=60, arch=(16, 1),
        lr=3e-3)
    assert np.isfinite(loss) and loss < 4.0  # uniform is log(81) ~ 4.39
    assert set(variables["params"]) == {"Conv_0", "BatchNorm_0", "Conv_1"}
