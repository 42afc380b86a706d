"""The port's anchor opponent (`eval/anchor.py`) held against the JAX
package's: `anchor_apply`'s float32 logits bit-equal on random planes at
9x9 and 15x15, the pinned search configurations equal, and an AnchorV1
match (golden `anchor_match`: a seeded FastPolicy 1x8 in float32 against
the anchor, 9x9, one pair of games, 4 sims a move under the anchor's
VCT configuration, cut at 10 plies) with the same final boards, outcomes,
pentanomial and score.  The cut leaves the games unfinished, and the
anchor's uniform value cannot adjudicate them, so the pair is excluded and
the block scores 0.5, as the JAX package scores it (ROADMAP.md §3).  Also
`tools/rate_vs_anchor.py` on the CPU at a cut size."""

import json

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.eval import anchor as TA
from alphagomoku_tpu_torch.eval import match as TMATCH
from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.game.types import GameRules
from alphagomoku_tpu_torch.models.convert import to_flax
from alphagomoku_tpu_torch.models.forward import network_apply
from alphagomoku_tpu_torch.models.networks import create_network, init_random_
from tests import torch_golden

torch.set_num_threads(1)

H = W = 9
PAIRS = 1
SIMS = 4
PLIES = 10
ARCH = dict(arch="FastPolicy", blocks=1, filters=8)


@pytest.mark.parametrize("size", [9, 15])
def test_anchor_apply_bit_equal(size):
    import jax.numpy as jnp

    from alphagomoku_tpu.eval import anchor as JA

    planes = (np.random.default_rng(size).random((6, size, size, 8)) < 0.3).astype(np.float32)
    planes[0] = 0.0  # an empty board: the centre prior alone
    ref = JA.anchor_apply({}, jnp.asarray(planes))
    ours = TA.anchor_apply({}, torch.from_numpy(planes).to(torch.bfloat16))
    for name in ("policy_logits", "value_logits"):
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a.view(np.int32),
                                                                   b.view(np.int32)), name
    assert ours.q_logits is None and ours.moves_left_logits is None
    assert ours.soft_policy_logits is None


def test_anchor_configs_equal_jax():
    from alphagomoku_tpu.eval import anchor as JA

    assert TA.ANCHOR_MCFG._asdict() == JA.ANCHOR_MCFG._asdict()
    assert TA.ANCHOR_V2_MCFG._asdict() == JA.ANCHOR_V2_MCFG._asdict()
    for version in (TA.ANCHOR_VERSION, TA.ANCHOR_V2_VERSION):
        ours, ref = TA.anchor_opponent(version), JA.anchor_opponent(version)
        assert ours.mcfg._asdict() == ref.mcfg._asdict()
        assert (ours.name, ours.raw_input, ours.calibrated_value) == (
            ref.name, ref.raw_input, ref.calibrated_value) == (version, True, False)
        assert ours.net_apply is TA.anchor_apply


def _candidate():
    """The seeded candidate: FastPolicy 1x8 in float32 (no bf16 rounding
    for the two packages to round apart)."""
    net = create_network(ARCH["arch"], ARCH["blocks"], ARCH["filters"], H, W,
                         dtype=torch.float32)
    return init_random_(net, torch.Generator().manual_seed(11)).eval()


def _openings() -> np.ndarray:
    return TMATCH.random_openings(np.random.default_rng(2), PAIRS, H, W, stones=4)


def _capture_final_boards(module, monkeypatch=None):
    """Wrap `module._expectation_cross`, which the match calls on the final
    boards of unfinished games: returns the list it appends them to."""
    seen = []
    inner = module._expectation_cross

    def spy(net_apply, variables, tables, boards, stm, raw):
        seen.append(np.asarray(boards.cpu() if torch.is_tensor(boards) else boards))
        return inner(net_apply, variables, tables, boards, stm, raw)

    if monkeypatch is not None:
        monkeypatch.setattr(module, "_expectation_cross", spy)
    else:
        module._expectation_cross = spy
    return seen, inner


def _as_dict(res, boards) -> dict:
    return {"outcomes": np.asarray(res.outcomes), "pentanomial": np.asarray(res.pentanomial),
            "score_a": np.float64(res.score_a), "game_lengths": np.asarray(res.game_lengths),
            "truncated": np.int64(res.truncated), "final_boards": boards}


def jax_anchor_match() -> dict:
    """The golden anchor_match: the JAX package's play_multi_match of the
    candidate (its weights converted by `to_flax`) against AnchorV1."""
    import jax.numpy as jnp

    from alphagomoku_tpu.eval import anchor as JA
    from alphagomoku_tpu.eval import match as JMATCH
    from alphagomoku_tpu.models import create_network as jax_network
    from tests.test_torch_mcts import jax_tables

    net = jax_network(ARCH["arch"], ARCH["blocks"], ARCH["filters"], dtype=jnp.float32)
    variables = to_flax(_candidate().state_dict())
    seen, inner = _capture_final_boards(JMATCH)
    try:
        res = JMATCH.play_multi_match(
            lambda v, p: net.apply(v, p, train=False), variables, [JA.anchor_opponent()],
            jax_tables(GameRules.FREESTYLE), JA.ANCHOR_MCFG, SIMS, _openings(),
            max_moves=4 + PLIES, raw_input_a=True)[0]
    finally:
        JMATCH._expectation_cross = inner
    return {**_as_dict(res, seen[0]), "openings": _openings()}


def test_anchor_match_matches_golden(monkeypatch):
    ref = torch_golden.load("anchor_match")
    assert np.array_equal(ref["openings"], _openings())
    seen, _ = _capture_final_boards(TMATCH, monkeypatch)
    apply, weights = network_apply(_candidate())
    res = TMATCH.play_multi_match(
        apply, weights, [TA.anchor_opponent()], TV.device_tables(GameRules.FREESTYLE),
        TA.ANCHOR_MCFG, SIMS, _openings(), max_moves=4 + PLIES, device="cpu")[0]
    ours = _as_dict(res, seen[0])
    for k, v in ref.items():
        if k != "openings":
            assert np.array_equal(np.asarray(ours[k]), v), (k, ours[k], v)
    # every game was cut, the anchor cannot adjudicate: no pair is scored
    assert res.truncated == 2 * PAIRS and res.score_a == 0.5 and res.pentanomial.sum() == 0
    assert ((seen[0] != 0).sum((1, 2)) == 4 + PLIES).all()


def test_rate_vs_anchor_tool_on_cpu(capsys, tmp_path):
    from alphagomoku_tpu_torch.tools import rate_vs_anchor
    from alphagomoku_tpu_torch.utils import checkpoint

    net = create_network("ConvNextPVQMraw", 1, 16, H, W)
    init_random_(net, torch.Generator().manual_seed(0))
    path = tmp_path / "network_1.msgpack"
    checkpoint.save(str(path), to_flax(net.state_dict()))
    rate_vs_anchor.main(["--checkpoint", str(path), "--blocks", "1", "--filters", "16",
                         "--pairs", "1", "--sims", "2", "--size", str(H), "--max-moves", "6",
                         "--cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["anchor"] == "AnchorV1" and line["checkpoint"] == str(path)
    assert (line["sims"], line["pairs"], line["unfinished"]) == (2, 1, 2)
    assert line["pentanomial"] == [0, 0, 0, 0, 0] and line["score_vs_anchor"] == 0.5
    assert line["seconds"] >= 0
