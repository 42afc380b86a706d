"""The port's paired-game match held against the JAX package's: a
`play_match` between two exact stub networks (the self-play tests' stub,
and one with other cell priorities and stone weights) on two random
openings, 8 sims a move, cut at 12 plies so that both nets adjudicate the
unfinished games (golden `match_stub`: outcomes, pentanomial, score, Elo,
game lengths and the truncated count, all equal); `_score_pairs`,
`_adjudicate_pair`, `random_openings` and `elo_from_winrate` live."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.eval import match as JMATCH
from alphagomoku_tpu.game.types import GameOutcome, GameRules
from alphagomoku_tpu.models.networks import NetOutput as JaxNetOutput
from alphagomoku_tpu.search import mcts as JM

from alphagomoku_tpu_torch.eval import match as TMATCH
from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.models.networks import NetOutput
from alphagomoku_tpu_torch.search import mcts as TM
from tests import torch_golden
from tests.test_torch_mcts import jax_tables

torch.set_num_threads(1)

H = W = 15
GAMES = 2  # openings, so 4 games
SIMS = 8
MAX_MOVES = 4 + 12
MCFG = dict(max_nodes=SIMS + 8, max_edges=8, max_depth=8)
PREFERRED = 16


def _stub_tables(seed: int):
    pri = np.random.default_rng(seed).permutation(H * W).astype(np.float32).reshape(H, W)
    ws = np.random.default_rng(seed + 1).integers(-1, 2, size=(H, W)).astype(np.float32)
    return pri, ws


def jax_stub(seed: int):
    """An exact stub: policy 1/16 on the 16 preferred empty cells, a
    one-hot value by the sign of a stone weighting (the self-play tests'
    construction, seeded)."""
    pri, ws = _stub_tables(seed)

    def apply(_, planes):
        p = planes.astype(jnp.float32)
        bsz = p.shape[0]
        score = jnp.where(p[..., 1] + p[..., 2] == 0, pri, -1.0).reshape(bsz, -1)
        thr = jnp.sort(score, -1)[:, -PREFERRED]
        s = (p[..., 1] * ws).sum((1, 2)) - (p[..., 2] * ws).sum((1, 2))
        return JaxNetOutput(
            policy_logits=jnp.where(score >= thr[:, None], 0.0, -1e4).reshape(bsz, H, W),
            value_logits=jnp.where(jnp.stack([s > 0, s == 0, s < 0], -1), 0.0, -1e4),
            q_logits=None, moves_left_logits=None, soft_policy_logits=None,
        )

    return apply


def torch_stub(seed: int):
    pri, ws = (torch.from_numpy(a) for a in _stub_tables(seed))

    def apply(_, planes):
        p = planes.float()
        bsz = p.shape[0]
        score = torch.where(p[..., 1] + p[..., 2] == 0, pri, -1.0).reshape(bsz, -1)
        thr = torch.sort(score, -1).values[:, -PREFERRED]
        s = (p[..., 1] * ws).sum((1, 2)) - (p[..., 2] * ws).sum((1, 2))
        return NetOutput(
            policy_logits=torch.where(score >= thr[:, None], 0.0, -1e4).reshape(bsz, H, W),
            value_logits=torch.where(torch.stack([s > 0, s == 0, s < 0], -1), 0.0, -1e4),
            q_logits=None, moves_left_logits=None, soft_policy_logits=None,
        )

    return apply


STUB_A, STUB_B = 9, 21


def _openings() -> np.ndarray:
    return JMATCH.random_openings(np.random.default_rng(5), GAMES, H, W)


def _as_dict(res) -> dict:
    return {"outcomes": np.asarray(res.outcomes), "pentanomial": np.asarray(res.pentanomial),
            "score_a": np.float64(res.score_a), "elo_a": np.float64(res.elo_a),
            "game_lengths": np.asarray(res.game_lengths), "truncated": np.int64(res.truncated)}


def jax_match() -> dict:
    """The golden match_stub: JAX's play_match of stub A against stub B."""
    res = JMATCH.play_match(
        jax_stub(STUB_A), None, jax_stub(STUB_B), None, jax_tables(GameRules.FREESTYLE),
        JM.MCTSConfig(**MCFG), SIMS, _openings(), max_moves=MAX_MOVES)
    return {**_as_dict(res), "openings": _openings()}


def test_play_match_matches_jax():
    ref = torch_golden.load("match_stub")
    assert np.array_equal(ref["openings"], _openings())
    plies = []
    res = TMATCH.play_match(
        torch_stub(STUB_A), None, torch_stub(STUB_B), None,
        TV.device_tables(GameRules.FREESTYLE), TM.MCTSConfig(**MCFG), SIMS, _openings(),
        max_moves=MAX_MOVES, device="cpu", on_ply=lambda env, moves: plies.append(
            (env.board.flatten(1).gather(1, moves[:, None])[:, 0] == 0)
            | (env.outcome != int(GameOutcome.UNKNOWN))),
    )
    ours = _as_dict(res)
    for k, v in ref.items():
        if k != "openings":
            assert np.array_equal(np.asarray(ours[k]), v), (k, ours[k], v)
    # the cut left games to adjudicate, and every live move was on an empty cell
    assert res.truncated > 0 and len(plies) == MAX_MOVES - 4
    assert all(bool(p.all()) for p in plies)
    assert int(res.pentanomial.sum()) == GAMES


def _outcomes(rng, n):
    return rng.choice([int(o) for o in GameOutcome], size=n).astype(np.int8)


@pytest.mark.parametrize("seed", range(4))
def test_score_pairs_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g = 6
    outcomes = _outcomes(rng, 2 * g)
    adjudicated = _outcomes(rng, 2 * g)
    exclude = rng.random(2 * g) < 0.3
    for adj, exc in ((None, None), (adjudicated, None), (None, exclude),
                     (None, np.ones(2 * g, bool))):
        want = JMATCH._score_pairs(outcomes, g, adj, exc)
        got = TMATCH._score_pairs(outcomes, g, adj, exc)
        assert np.array_equal(want[0], got[0]) and want[1] == got[1]
    # no pair left: 0.5, as the JAX package scores it (ROADMAP §3)
    assert TMATCH._score_pairs(outcomes, g, None, np.ones(2 * g, bool))[1] == 0.5


def test_adjudicate_random_openings_and_elo_match_jax():
    rng = np.random.default_rng(3)
    a, b = rng.random(64).astype(np.float32), rng.random(64).astype(np.float32)
    assert np.array_equal(JMATCH._adjudicate_pair(a, b), TMATCH._adjudicate_pair(a, b))
    for games, stones in ((5, 4), (3, 6)):
        want = JMATCH.random_openings(np.random.default_rng(7), games, H, W, stones)
        got = TMATCH.random_openings(np.random.default_rng(7), games, H, W, stones)
        assert np.array_equal(want, got)
    for wr in (0.0, 0.25, 0.5, 0.8125, 1.0):
        assert TMATCH.elo_from_winrate(wr) == JMATCH.elo_from_winrate(wr)
