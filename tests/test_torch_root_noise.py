"""Root noise and temperature sampling of the port's search, against the
JAX package.

The mixing (`apply_root_noise`) is held against the JAX package's
`_apply_root_noise` with JAX's own draws injected, for the three noise
types.  The mixed priors before the renormalization are bit-equal; the
renormalization's row sum is added left to right by XLA on the CPU and in
another order by torch, so the results are held within stated f32 ulps of
JAX's: dirichlet 4, gumbel 16 (its softmax also takes an exp); custom
within 1e-4 relative, since XLA's cumulative product of the
stick-breaking is an associative scan, not torch's left-to-right product.
The samplers, which draw from a torch.Generator and cannot reproduce
jax.random, are held to their distributions.  The Gumbel-max sampling of
`select_move` is held against `jax.random.categorical` on the same key's
Gumbel draw."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.search import mcts as JM

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.game.types import GameRules
from alphagomoku_tpu_torch.search import mcts as TM
from tests.test_torch_mcts import TORCH_CFG, boards_and_stm, torch_stub

torch.set_num_threads(1)

B, K = 64, 32


def within_ulps(got: np.ndarray, want: np.ndarray, ulps: int) -> bool:
    """|got - want| <= `ulps` f32 ulps of `want`, elementwise."""
    return bool((np.abs(got - want) <= ulps * np.spacing(np.abs(want))).all())


def jax_draws(cfg, key) -> np.ndarray:
    """The noise tensor the JAX package draws from `key` inside
    `_apply_root_noise`: its Dirichlet rows, its Gumbel draw, or its
    custom noise."""
    if cfg.noise_type == "gumbel":
        return np.array(jax.random.gumbel(key, (B, K)))
    if cfg.noise_type == "custom":
        raise ValueError("custom noise is injected as (u, perm), see custom_draws")
    return np.array(jax.random.dirichlet(key, jnp.full((K,), cfg.noise_alpha), (B,)))


def custom_draws(key):
    """The custom noise's uniform draws and per-row permutations, as the
    JAX package draws them from `key`."""
    ku, kp = jax.random.split(key)
    u = np.array(jax.random.uniform(ku, (B, K)))
    perm = np.array(jax.vmap(lambda k: jax.random.permutation(k, K))(
        jax.random.split(kp, B)))
    return u, perm


def priors_and_actions(seed: int):
    """Renormalized f32 priors [B, K] with a random number of empty slots
    per row (a row of no edges among them)."""
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(0, K + 1, size=B)
    n_valid[0], n_valid[1] = 0, K
    valid = np.arange(K)[None, :] < n_valid[:, None]
    actions = np.where(valid, rng.integers(0, 225, size=(B, K)), -1).astype(np.int32)
    priors = np.where(valid, rng.random((B, K)) ** 3, 0.0).astype(np.float32)
    priors /= np.maximum(priors.sum(-1, keepdims=True), 1e-12)
    return priors.astype(np.float32), actions


@pytest.mark.parametrize("noise_type", ["dirichlet", "gumbel", "custom"])
def test_mixing_matches_jax_with_its_draws(noise_type):
    """`apply_root_noise` on JAX's draws against `_apply_root_noise` on
    their key, with the tolerances of the module docstring."""
    cfg_kw = dict(noise_weight=0.25, noise_alpha=0.1, noise_type=noise_type, max_edges=K)
    jcfg, tcfg = JM.MCTSConfig(**cfg_kw), TM.MCTSConfig(**cfg_kw)
    priors, actions = priors_and_actions(int(len(noise_type)))
    key = jax.random.PRNGKey(3)
    want = np.asarray(JM._apply_root_noise(jcfg, jnp.asarray(priors), jnp.asarray(actions),
                                           key))
    if noise_type == "custom":
        u, perm = custom_draws(key)
        noise = TM.custom_noise(torch.from_numpy(u), torch.from_numpy(perm))
    else:
        noise = torch.from_numpy(jax_draws(jcfg, key))
    got = TM.apply_root_noise(tcfg, torch.from_numpy(priors), torch.from_numpy(actions),
                              noise).numpy()
    if noise_type == "custom":
        assert np.allclose(got, want, rtol=1e-4, atol=0)
    else:
        assert within_ulps(got, want, 16 if noise_type == "gumbel" else 4)
    assert np.array_equal(got == 0, want == 0)
    rows = (actions != -1).any(-1)
    assert np.allclose(got[rows].sum(-1), 1.0, atol=1e-6) and not got[~rows].any()
    assert not np.allclose(got, priors)  # the noise moved the priors


def test_no_noise_keeps_priors():
    priors, actions = priors_and_actions(0)
    cfg = TM.MCTSConfig(noise_weight=0.25, max_edges=K)
    p = torch.from_numpy(priors)
    assert TM.apply_root_noise(cfg, p, torch.from_numpy(actions), None) is p
    noise = torch.rand(B, K)
    assert TM.apply_root_noise(cfg._replace(noise_weight=0.0), p, torch.from_numpy(actions),
                               noise) is p


def test_dirichlet_sampler_moments():
    """Dirichlet(0.1) over K = 32 from 10^5 rows: per-slot mean alpha / a0
    and variance alpha (a0 - alpha) / (a0^2 (a0 + 1)) within 5% (each about
    5 standard errors of its estimate), rows that sum to 1, no NaN and no
    row of zeros, although alpha 0.1 underflows f32 gamma draws."""
    rows = 100_000
    cfg = TM.MCTSConfig(noise_weight=0.25, noise_alpha=0.1, max_edges=K)
    x = TM.sample_root_noise(cfg, rows, torch.Generator().manual_seed(0)).double()
    assert x.shape == (rows, K) and not torch.isnan(x).any()
    assert (x.amax(-1) > 0).all()
    assert torch.allclose(x.sum(-1), torch.ones(rows, dtype=torch.float64), atol=1e-5)
    a, a0 = 0.1, 0.1 * K
    mean, var = a / a0, a * (a0 - a) / (a0 * a0 * (a0 + 1))
    assert torch.allclose(x.mean(0), torch.full((K,), mean, dtype=torch.float64), rtol=0.05)
    assert abs(float(x.var(0).mean()) / var - 1) < 0.05
    again = TM.sample_root_noise(cfg, rows, torch.Generator().manual_seed(0))
    assert torch.equal(again, x.float())


def test_log_gamma_sampler_moments():
    """log Gamma(alpha) draws: E[log G] = digamma(alpha) and Var = trigamma
    (alpha) within 2%, at the boosted alpha 0.1 and at 2.5."""
    for alpha, digamma, trigamma in ((0.1, -10.4237549, 101.4332991),
                                     (2.5, 0.7031566, 0.4903578)):
        x = TM.sample_log_gamma(alpha, (200_000,), torch.Generator().manual_seed(1)).double()
        assert torch.isfinite(x).all()
        assert abs(float(x.mean()) - digamma) < 0.02 * abs(digamma)
        assert abs(float(x.var()) / trigamma - 1) < 0.02


def test_gumbel_and_custom_samplers():
    gen = torch.Generator().manual_seed(2)
    g = TM.sample_gumbel((200_000,), gen).double()
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772157) < 0.01
    assert abs(float(g.var()) / (math.pi ** 2 / 6) - 1) < 0.02
    cfg = TM.MCTSConfig(noise_weight=0.25, noise_type="custom", max_edges=K)
    x = TM.sample_root_noise(cfg, 20_000, gen)
    s = x.sum(-1)
    assert ((s > 0) & (s <= 1 + 1e-6)).all()
    # the shuffle spreads the stick-breaking pieces evenly over the slots
    slot_mean = x.mean(0)
    assert float(slot_mean.std() / slot_mean.mean()) < 0.05


def test_select_move_gumbel_max_matches_jax_categorical():
    """select_move's temperature sampling is jax.random.categorical: the
    first argmax of the key's Gumbel draw plus the logits."""
    boards, stm = boards_and_stm()
    tables = TV.device_tables(GameRules.FREESTYLE)
    ts = TM.run_search(torch_stub, None, tables, TORCH_CFG, boards, stm, 32, device="cpu")
    rb = torch.arange(len(boards))
    visits = TM.edge_stats(ts.tree, rb, ts.root_node).visits.float()
    actions = ts.tree.edge_action[rb, ts.root_node]
    for seed, temperature in ((0, 1.0), (1, 1.0), (2, 0.5)):
        key = jax.random.PRNGKey(seed)
        logits = jnp.where(jnp.asarray(actions.numpy()) != -1,
                           jnp.log(jnp.maximum(jnp.asarray(visits.numpy()), 1e-9)) / temperature,
                           -jnp.inf)
        slot = np.asarray(jax.random.categorical(key, logits, axis=-1))
        want = np.clip(actions.numpy()[np.arange(len(boards)), slot], 0, 224)
        g = torch.from_numpy(np.array(jax.random.gumbel(key, actions.shape)))
        got = TM.select_move(ts, temperature=temperature, gumbel=g)
        assert np.array_equal(got.numpy(), want)
