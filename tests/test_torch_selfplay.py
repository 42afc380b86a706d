"""The port's self-play held against the JAX package's, with a stub
network whose outputs both frameworks compute bit for bit, and JAX's own
draws injected move by move (its Dirichlet root noise and the Gumbel draw
of its temperature sampling, from the keys `play_games` splits).

Why an exact stub: a game turns on PUCT's argmax at the root, where an
ulp of a noisy prior can flip a near tie, and XLA's exp and sums round
otherwise than torch's.  This stub's softmaxes take exp(0) = 1 and
exp(-1e4) = 0 only: the policy is 1/16 on the 16 empty cells of highest
fixed priority (so the K = 8 edge priors are 1/8 exactly) and the value
is a one-hot win, draw or loss by the sign of an integer stone weighting.

B = 4 games from the empty board, 16 sims a move (max_nodes 64, so the
tree is reused for two moves in three), noise weight 0.25, temperature on
the first 4 plies, and a draw horizon of 10 stones that ends every game
within the 12 moves played.  Compared bit for bit, floats too: the
records of the live samples, which samples are live, the outcomes, the
game lengths and `make_targets` on its valid samples.  The JAX sides are
the goldens selfplay_reuse, selfplay_fresh and selfplay_resumed;
`make_targets` is also compared live."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.game.types import GameRules
from alphagomoku_tpu.models.networks import NetOutput as JaxNetOutput
from alphagomoku_tpu.search import mcts as JM
from alphagomoku_tpu.selfplay import selfplay as JSP
from alphagomoku_tpu.utils.misc import get_simulations_for_move as jax_get_simulations_for_move
from alphagomoku_tpu.utils.misc import zfill as jax_zfill

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.models.networks import NetOutput
from alphagomoku_tpu_torch.search import mcts as TM
from alphagomoku_tpu_torch.selfplay import selfplay as TSP
from alphagomoku_tpu_torch.utils.misc import get_simulations_for_move, zfill
from tests import torch_golden
from tests.test_torch_mcts import jax_tables

torch.set_num_threads(1)

B, H, W = 4, 15, 15
MCFG = dict(max_nodes=64, max_edges=8, max_depth=8)
SCFG = dict(num_simulations=16, temperature_moves=4, noise_weight=0.25, noise_alpha=0.1,
            max_moves=12, draw_after=10)
CHUNK = 4
RECORD = TSP.GameRecord._fields

PREFERRED = 16
_PRI = np.random.default_rng(9).permutation(H * W).astype(np.float32).reshape(H, W)
_WS = np.random.default_rng(10).integers(-1, 2, size=(H, W)).astype(np.float32)


def jax_stub(_, planes):
    p = planes.astype(jnp.float32)
    bsz = p.shape[0]
    score = jnp.where(p[..., 1] + p[..., 2] == 0, _PRI, -1.0).reshape(bsz, -1)
    thr = jnp.sort(score, -1)[:, -PREFERRED]
    s = (p[..., 1] * _WS).sum((1, 2)) - (p[..., 2] * _WS).sum((1, 2))
    return JaxNetOutput(
        policy_logits=jnp.where(score >= thr[:, None], 0.0, -1e4).reshape(bsz, H, W),
        value_logits=jnp.where(jnp.stack([s > 0, s == 0, s < 0], -1), 0.0, -1e4),
        q_logits=None, moves_left_logits=None, soft_policy_logits=None,
    )


def torch_stub(_, planes):
    p = planes.float()
    bsz = p.shape[0]
    score = torch.where(p[..., 1] + p[..., 2] == 0, torch.from_numpy(_PRI), -1.0).reshape(bsz, -1)
    thr = torch.sort(score, -1).values[:, -PREFERRED]
    s = (p[..., 1] * torch.from_numpy(_WS)).sum((1, 2)) - (p[..., 2] * torch.from_numpy(_WS)).sum(
        (1, 2))
    return NetOutput(
        policy_logits=torch.where(score >= thr[:, None], 0.0, -1e4).reshape(bsz, H, W),
        value_logits=torch.where(torch.stack([s > 0, s == 0, s < 0], -1), 0.0, -1e4),
        q_logits=None, moves_left_logits=None, soft_policy_logits=None,
    )


def jax_draws(seed: int) -> dict:
    """Each move's noise and Gumbel draw as JAX's `play_games` draws them
    from PRNGKey(seed): [M, B, K] each."""
    k = MCFG["max_edges"]
    noise, gumbel = [], []
    for key in jax.random.split(jax.random.PRNGKey(seed), SCFG["max_moves"]):
        k_noise, k_sample = jax.random.split(key)
        noise.append(jax.random.dirichlet(k_noise, jnp.full((k,), SCFG["noise_alpha"]), (B,)))
        gumbel.append(jax.random.gumbel(k_sample, (B, k)))
    return {"draws.noise": np.stack(noise), "draws.gumbel": np.stack(gumbel)}


def _to_np(result) -> dict:
    out = {f"record.{f}": np.asarray(getattr(result.record, f)) for f in RECORD}
    out["outcome"] = np.asarray(result.outcome)
    out["game_length"] = np.asarray(result.game_length)
    return out


def jax_selfplay(tree_reuse: bool, seed: int = 0, resumed: bool = False) -> dict:
    """JAX's play_games (or, with `resumed`, play_games_resumable stopped
    after its first chunk of CHUNK moves and resumed) and its draws."""
    jt = jax_tables(GameRules.FREESTYLE)
    mcfg = JM.MCTSConfig(**MCFG)
    scfg = JSP.SelfplayConfig(tree_reuse=tree_reuse, **SCFG)
    key = jax.random.PRNGKey(seed)
    if not resumed:
        result = jax.jit(lambda k: JSP.play_games(jax_stub, None, jt, mcfg, scfg, k, B, H, W))(key)
    else:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            snap = os.path.join(tmp, "snap.npz")
            run = lambda stop: JSP.play_games_resumable(
                jax_stub, None, jt, mcfg, scfg, key, B, H, W, chunk_moves=CHUNK,
                should_stop=stop, snapshot_path=snap)
            assert run(lambda: True) is None
            result = run(None)
    return {**_to_np(result), **jax_draws(seed)}


def _draws(ref: dict) -> list:
    return [TSP.MoveDraws(torch.from_numpy(n), torch.from_numpy(g))
            for n, g in zip(ref["draws.noise"], ref["draws.gumbel"])]


def _configs(tree_reuse: bool):
    return TM.MCTSConfig(**MCFG), TSP.SelfplayConfig(tree_reuse=tree_reuse, **SCFG)


def _play(tree_reuse: bool, ref: dict):
    mcfg, scfg = _configs(tree_reuse)
    return TSP.play_games(torch_stub, None, TV.device_tables(GameRules.FREESTYLE), mcfg, scfg,
                          None, B, H, W, draws=_draws(ref), device="cpu")


def _resumed(tree_reuse: bool, ref: dict, tmp_path):
    mcfg, scfg = _configs(tree_reuse)
    snap = str(tmp_path / "snap.npz")
    run = lambda stop: TSP.play_games_resumable(
        torch_stub, None, TV.device_tables(GameRules.FREESTYLE), mcfg, scfg, None, B, H, W,
        chunk_moves=CHUNK, should_stop=stop, snapshot_path=snap, draws=_draws(ref),
        device="cpu")
    assert run(lambda: True) is None and os.path.exists(snap)
    result = run(None)
    assert not os.path.exists(snap)
    return result


def check_result(ref: dict, result) -> None:
    """The live samples' records, the live flags, the outcomes and game
    lengths, and the targets of the valid samples, equal to JAX's."""
    ours = _to_np(result)
    alive = ref["record.alive"]
    assert np.array_equal(ours["record.alive"], alive)
    assert alive.any() and not alive[-1].any()  # every game ended
    for name in ("outcome", "game_length"):
        assert np.array_equal(ours[name], ref[name]), name
    searched = alive.any(1)
    assert np.array_equal(ours["record.phase_counters"][searched],
                          ref["record.phase_counters"][searched])
    for f in RECORD:
        if f in ("alive", "phase_counters"):
            continue
        name = f"record.{f}"
        assert ours[name].dtype == ref[name].dtype, name
        assert np.array_equal(ref[name][alive], ours[name][alive]), name
    want = JSP.make_targets(JSP.SelfplayResult(
        JSP.GameRecord(*[jnp.asarray(ref[f"record.{f}"]) for f in RECORD]),
        jnp.asarray(ref["outcome"]), jnp.asarray(ref["game_length"])), H * W)
    got = TSP.make_targets(result, H * W)
    valid = np.asarray(want["valid"])
    assert np.array_equal(got["valid"].numpy(), valid) and valid.any()
    for name, a in want.items():
        b = got[name].numpy()
        assert b.dtype == np.asarray(a).dtype, name
        assert np.array_equal(np.asarray(a)[valid], b[valid]), name


@pytest.mark.parametrize("tree_reuse", [True, False], ids=["reuse", "fresh"])
def test_play_games_matches_jax(tree_reuse):
    ref = torch_golden.load("selfplay_reuse" if tree_reuse else "selfplay_fresh")
    result = _play(tree_reuse, ref)
    check_result(ref, result)
    assert result.record.move.shape == (SCFG["max_moves"], B)


def test_play_games_resumable_matches_jax(tmp_path):
    """Stopped after the first chunk and resumed from the snapshot, as the
    JAX run was (the tree is not saved, so the resumed run's first move
    searches a fresh tree)."""
    check_result(torch_golden.load("selfplay_resumed"),
                 _resumed(True, torch_golden.load("selfplay_resumed"), tmp_path))


def test_resumed_without_reuse_equals_the_uninterrupted_run(tmp_path):
    """Without tree reuse a stop and a resume change nothing: the JAX
    run that was never stopped."""
    ref = torch_golden.load("selfplay_fresh")
    resumed = _resumed(False, ref, tmp_path)
    check_result(ref, resumed)
    # the resumable run stops after the chunk in which every game ended
    assert resumed.record.move.shape[0] == CHUNK * -(-int(ref["game_length"].max()) // CHUNK)


def test_generator_draws_resume_as_uninterrupted(tmp_path):
    """Drawing from a torch.Generator, a stopped and resumed run (whose
    snapshot holds the generator's state) plays what an uninterrupted run
    plays, without tree reuse; and the same seed plays the same games."""
    mcfg, scfg = _configs(False)
    tables = TV.device_tables(GameRules.FREESTYLE)
    seed = lambda: torch.Generator().manual_seed(5)
    whole = TSP.play_games_resumable(torch_stub, None, tables, mcfg, scfg, seed(), B, H, W,
                                     chunk_moves=CHUNK, device="cpu")
    snap = str(tmp_path / "snap.npz")
    gen = seed()
    run = lambda stop: TSP.play_games_resumable(
        torch_stub, None, tables, mcfg, scfg, gen, B, H, W, chunk_moves=CHUNK,
        should_stop=stop, snapshot_path=snap, device="cpu")
    assert run(lambda: True) is None
    gen.manual_seed(99)  # the snapshot's state replaces it
    resumed = run(None)
    for a, b in zip(whole, resumed):
        for x, y in zip(a if isinstance(a, tuple) else [a], b if isinstance(b, tuple) else [b]):
            assert torch.equal(x, y)


def test_on_stats_and_on_move():
    mcfg, scfg = _configs(True)
    stats, moves = [], []
    TSP.play_games_resumable(
        torch_stub, None, TV.device_tables(GameRules.FREESTYLE), mcfg, scfg,
        torch.Generator().manual_seed(0), B, H, W, chunk_moves=CHUNK, on_stats=stats.append,
        on_move=lambda i, carry: moves.append((i, bool((carry.search.root_node > 0).any()))),
        device="cpu")
    assert [s["moves"] for s in stats] == [4, 8, 12][:len(stats)]
    assert all(s["sims"] > 0 and s["avg_depth"] > 0 for s in stats[:-1])
    assert [i for i, _ in moves] == list(range(len(moves)))
    assert moves[0][1] is False and any(r for _, r in moves)  # move 0 has nothing to reuse


def test_get_simulations_for_move():
    """The port's copy equals the JAX package's function over a grid of
    draw rates (below, at and past the 0.75 threshold) and budgets."""
    rates = (0.0, 0.5, 0.75, 0.8, 0.875, 0.9, 0.99, 1.0)
    budgets = ((100, 25), (64, 16), (800, 100), (16, 16))
    for rate in rates:
        for max_sims, min_sims in budgets:
            assert get_simulations_for_move(rate, max_sims, min_sims) == \
                jax_get_simulations_for_move(rate, max_sims, min_sims), (rate, max_sims, min_sims)


def test_zfill():
    """The port's copy equals the JAX package's on signs, widths and
    numbers longer than the width."""
    for value in (0, 7, -7, 42, 12345, -100000):
        for length in (0, 1, 3, 6):
            assert zfill(value, length) == jax_zfill(value, length), (value, length)
