"""The solver's tables and primitives in the port, held bit-exact against
the JAX package: the threat table and `threat_type`, `classify` with
`THREAT_KINDS`, the defensive-move tables and `get_moves_batched` (JAX
side from the goldens defensive_tables / defensive_moves, whose JAX build
takes seconds per rule), and `search/lockstep.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.game import vectorized as JV
from alphagomoku_tpu.game.types import GameRules, CROSS, CIRCLE
from alphagomoku_tpu.patterns import bitwise as JB
from alphagomoku_tpu.patterns import tables as JT
from alphagomoku_tpu.search import lockstep as JL
from alphagomoku_tpu.search import vct_batched as JVB

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.patterns import bitwise as TB
from alphagomoku_tpu_torch.patterns import defensive as TD
from alphagomoku_tpu_torch.patterns import tables as TT
from alphagomoku_tpu_torch.search import lockstep as TL
from alphagomoku_tpu_torch.search import vct_batched as TVB
from tests import torch_golden

torch.set_num_threads(1)

NON_RENJU = [GameRules.FREESTYLE, GameRules.STANDARD, GameRules.CARO5, GameRules.CARO6]
THREATS = [TT.PT_FIVE, TT.PT_OPEN_4, TT.PT_DOUBLE_4, TT.PT_HALF_OPEN_4, TT.PT_OPEN_3]


def random_boards(seed, n=8, h=15, w=15):
    """Boards from sparse to dense, with both stones."""
    rng = np.random.default_rng(seed)
    density = rng.uniform(0.1, 0.5, size=(n, 1, 1))
    filled = rng.random((n, h, w)) < density
    return np.where(filled, rng.integers(1, 3, size=(n, h, w)), 0).astype(np.int8)


def random_ext_windows(seed, n=4096):
    """26-bit extended windows: random cells, half of them with a threat
    shape of the defensive tables planted at its offset, so every dispatch
    branch is hit; and a random defender sign for each."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(4, size=(n, 13), p=[0.5, 0.2, 0.2, 0.1])
    shapes = []
    for masks, offsets, lengths in (
        (TD._FIVE_MASKS, TD._FIVE_OFFSETS, [5] * 5),
        (TD._OPEN4_MASKS, TD._OPEN4_OFFSETS, [6] * 4),
        (TD._D4_MASKS, TD._D4_OFFSETS, TD._D4_LENGTHS),
        (TD._HO4_MASKS, TD._HO4_OFFSETS, [5] * 20),
        (TD._OPEN3_MASKS, TD._OPEN3_OFFSETS, [6] * 12),
    ):
        for sign in (CROSS, CIRCLE):
            shapes += [(m, o, ln) for m, o, ln in zip(masks[sign], offsets, lengths)]
    for i in range(0, n, 2):
        mask, begin, length = shapes[rng.integers(len(shapes))]
        for k in range(length):
            cells[i, begin + k] = (mask >> (2 * k)) & 3
    windows = (cells.astype(np.int64) << (2 * np.arange(13))).sum(-1)
    return windows, rng.random(n) < 0.5


def jax_defensive_tables() -> dict:
    from alphagomoku_tpu.patterns import defensive as JD

    out = {}
    for rules in NON_RENJU:
        tabs = JD.get_tables(rules)
        for name in ("five", "open_four", "double_four"):
            out[f"{rules.name}.{name}"] = getattr(tabs, name)
    return out


def jax_defensive_moves() -> dict:
    from alphagomoku_tpu.patterns import defensive as JD

    windows, circle = random_ext_windows(0)
    out = {}
    for rules in NON_RENJU:
        for threat in THREATS:
            fn = jax.jit(lambda p, c: JD.get_moves_batched(rules, p, c, threat))
            res = fn(jnp.asarray(windows.astype(np.uint32)), jnp.asarray(circle))
            out[f"{rules.name}.{threat}"] = np.asarray(res).astype(np.int64)
    return out


@pytest.mark.parametrize("rules", NON_RENJU)
def test_threat_table_matches_jax(rules):
    assert np.array_equal(TT._build_threat_table(rules), JT._build_threat_table(rules))


@pytest.mark.parametrize("rules", NON_RENJU)
def test_defensive_tables_match_jax(rules):
    ref = torch_golden.load("defensive_tables")
    tabs = TD.get_tables(rules)
    for name in ("five", "open_four", "double_four"):
        assert np.array_equal(getattr(tabs, name), ref[f"{rules.name}.{name}"]), name


@pytest.mark.parametrize("rules", NON_RENJU)
def test_get_moves_batched_matches_jax(rules):
    ref = torch_golden.load("defensive_moves")
    windows, circle = random_ext_windows(0)
    for threat in THREATS:
        ours = TD.get_moves_batched(rules, torch.from_numpy(windows), torch.from_numpy(circle),
                                    threat)
        want = ref[f"{rules.name}.{threat}"]
        assert np.array_equal(ours.numpy().astype(np.int64), want), threat
        assert (want != 0).mean() > 0.01, threat  # the dispatch hit real shapes


@pytest.mark.parametrize("rules", [GameRules.FREESTYLE, GameRules.CARO5])
def test_threat_planes_and_lockstep_match_jax(rules):
    """On random boards: classify with THREAT_KINDS and the ThreatType of
    every cell for both signs; and lockstep's hash_boards, actor_planes,
    five_plane_of and the extended windows at one cell (one JAX compile
    per rule)."""
    boards = random_boards(40 + int(rules), n=12)
    rng = np.random.default_rng(int(rules))
    stm = rng.integers(1, 3, size=len(boards)).astype(np.int8)
    rows = rng.integers(0, 15, size=len(boards)).astype(np.int32)
    cols = rng.integers(0, 15, size=len(boards)).astype(np.int32)
    jt = JV.RuleTables(pattern=None, threat=jnp.asarray(JT._build_threat_table(rules)),
                       rules=int(rules))

    @jax.jit
    def jax_side(b, s, r, c):
        px, po = JL.classify(b, rules, JB.THREAT_KINDS)
        circle = s == CIRCLE
        own = jnp.where(circle[:, None, None, None], po, px)
        mine = JL.actor_planes(own, b == 0, (~circle)[:, None, None], False)
        return (px, po, JV.threat_type(jt, px, False), JV.threat_type(jt, po, True),
                *JL.hash_boards(b), *(mine[k] for k in ("five", "four", "win3", "three", "n3")),
                JL.five_plane_of(b, rules, circle), JVB._ext_windows_at_one(b, r, c))

    tt = TV.device_tables(rules)
    tb, ts = torch.from_numpy(boards), torch.from_numpy(stm)
    px, po = TL.classify(tb, rules, TB.THREAT_KINDS)
    circle = ts == CIRCLE
    own = torch.where(circle[:, None, None, None], po, px)
    mine = TL.actor_planes(own, tb == 0)
    h1, h2 = TL.hash_boards(tb)
    ours = (px, po, TV.threat_type(tt, px, False), TV.threat_type(tt, po, True), h1, h2,
            *(mine[k] for k in ("five", "four", "win3", "three", "n3")),
            TL.five_plane_of(tb, rules, circle),
            TVB._ext_windows_at_one(tb, torch.from_numpy(rows), torch.from_numpy(cols)))
    ref = jax_side(jnp.asarray(boards), jnp.asarray(stm), jnp.asarray(rows), jnp.asarray(cols))
    for i, (a, b) in enumerate(zip(ref, ours)):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64)), i
    assert len(set(h1.tolist())) == len(boards)
    assert (px == TT.PT_OPEN_3).any() and mine["four"].any()


@pytest.mark.parametrize("rules", NON_RENJU)
def test_threat_kinds_match_jax(rules):
    """`classify` with THREAT_KINDS on random windows: the bit math equals
    the JAX package's, the pattern-table lookup equals the bit math (for
    any subset of kinds), and only the half-open threes of the full
    classification read as 0."""
    rng = np.random.default_rng(int(rules))
    wins = rng.integers(0, 1 << 22, size=(4096,), dtype=np.uint32) & np.uint32(0x3FF3FF)
    tw = torch.from_numpy(wins.astype(np.int64))
    jx, jo = JB.classify(jnp.asarray(wins), rules, JB.THREAT_KINDS)
    bits = TB.classify(tw, rules, TB.THREAT_KINDS)
    table = TB.classify_by_table(tw, rules, TB.THREAT_KINDS)
    full = TB.classify(tw, rules)
    for j, b, t, f in zip((jx, jo), bits, table, full):
        assert np.array_equal(np.asarray(j), b.numpy())
        assert torch.equal(b, t)
        assert torch.equal(b, torch.where(f == TT.PT_HALF_OPEN_3, 0, f))
    assert (full[0] == TT.PT_HALF_OPEN_3).any() and (bits[0] == TT.PT_OPEN_3).any()
    some = ("five", "open_three")  # not a prefix of the priority order
    for b, t in zip(TB.classify(tw, rules, some), TB.classify_by_table(tw, rules, some)):
        assert torch.equal(b, t)


def test_lockstep_frame_access_ignores_out_of_range():
    """Reads outside the stack or board give 0 / False and writes there
    change nothing, as the JAX package's one-hot versions do."""
    arr = torch.arange(12).reshape(2, 6)
    ply = torch.tensor([-1, 6])
    assert TL.col_at(arr, ply).tolist() == [0, 0]
    TL.set_col(arr, ply, torch.tensor([True, True]), 99)
    assert torch.equal(arr, torch.arange(12).reshape(2, 6))
    board = torch.zeros((2, 3, 3), dtype=torch.int8)
    out = TL.place(board, torch.tensor([True, True]), torch.tensor([-1, 4]), CROSS)
    assert out.flatten(1).tolist() == [[0] * 9, [0, 0, 0, 0, CROSS, 0, 0, 0, 0]]
    assert not board.any()  # place copies
