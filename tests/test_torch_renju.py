"""Renju's forbidden moves in the port, held bit-exact against the JAX
package: `windows_at` with overlays, `promotion_masks`, `_straight_four`,
`is_forbidden_u` at depths 0 to 2 with and without overlays,
`forbidden_plane_u` (plane and certificate, the escalation included, and
the global cap's overflow), the renju `outcome_after`, feature bit 6 of
`encode`, the renju threat and defensive-move tables, and the solver's
renju threat planes.  The compiled JAX sides are the goldens
renju_forbidden, renju_checks and renju_defensive (tests/torch_golden);
the exact host recursion `alphagomoku_tpu.game.rules.is_forbidden` is
checked live.  The last tests show that every `lax.cond` gate of the
reference package, taken or skipped here, gives the same result on an
input where its predicate is false."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphagomoku_tpu.game import rules as host_rules
from alphagomoku_tpu.game import vectorized as JV
from alphagomoku_tpu.game.types import GameRules, GameOutcome, CROSS, CIRCLE, NONE, Move
from alphagomoku_tpu.patterns import tables as JT

from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.patterns import bitwise as TB
from alphagomoku_tpu_torch.patterns import defensive as TD
from alphagomoku_tpu_torch.patterns import features as TF
from alphagomoku_tpu_torch.patterns import tables as TT
from alphagomoku_tpu_torch.search import lockstep as TL
from tests import torch_golden
from tests.test_torch_threats import THREATS, random_ext_windows

torch.set_num_threads(1)

RENJU = GameRules.RENJU
SIZE = 15
TABLES = TV.device_tables(RENJU)


def jax_tables():
    # the batched paths classify by bit math: only the threat table is read
    return JV.RuleTables(pattern=None, threat=jnp.asarray(JT._build_threat_table(RENJU)),
                         rules=int(RENJU))


def clustered(seed=7, n=32, lo=8, hi=30):
    """Random-walk clusters of black-heavy stones around the center, as in
    tests/test_vectorized_rules.py (forks are rare in uniform noise)."""
    rng = np.random.default_rng(seed)
    boards = np.zeros((n, SIZE, SIZE), np.int8)
    for i in range(n):
        r, c = SIZE // 2, SIZE // 2
        for s in range(rng.integers(lo, hi)):
            boards[i, r, c] = CROSS if s % 3 != 2 else CIRCLE
            r = int(np.clip(r + rng.integers(-2, 3), 0, SIZE - 1))
            c = int(np.clip(c + rng.integers(-2, 3), 0, SIZE - 1))
    return boards


def overflow_boards(fork_rich: bool):
    """256 copies of one board: the 40-stone walk of
    tests/test_vectorized_rules.py:102-130 (seed 11), or (`fork_rich`) the
    first clustered board with three or more naive fork cells, which puts
    more fork cells in the batch than the global cap of 128."""
    if fork_rich:
        boards = clustered()
        base = boards[np.argmax(naive_forks(boards).sum((1, 2)) >= 3)]
        return np.broadcast_to(base, (256, SIZE, SIZE)).copy()
    rng = np.random.default_rng(11)
    base = np.zeros((SIZE, SIZE), np.int8)
    r, c = SIZE // 2, SIZE // 2
    for s in range(40):
        base[r, c] = CROSS if s % 3 != 2 else CIRCLE
        r = int(np.clip(r + rng.integers(-2, 3), 0, SIZE - 1))
        c = int(np.clip(c + rng.integers(-2, 3), 0, SIZE - 1))
    return np.broadcast_to(base, (256, SIZE, SIZE)).copy()


def naive_forks(boards: np.ndarray) -> np.ndarray:
    """[B, H, W] empty cells whose naive ThreatType for cross is a 3x3
    fork (the cells the recursion resolves), by the port's classifier."""
    tb = torch.from_numpy(boards)
    pts, _ = TB.classify(TV.windows_all(tb).movedim(1, -1), RENJU)
    return ((TV.threat_type(TABLES, pts, False) == TT.TT_FORK_3x3) & (tb == NONE)).numpy()


def queries(boards: np.ndarray):
    """Six query cells per board, the first naive fork cells first, and two
    overlay stones per query (random cells, empty or not)."""
    rng = np.random.default_rng(1)
    n = len(boards)
    rows, cols = rng.integers(0, SIZE, size=(2, n, 6))
    forks = naive_forks(boards)
    for i in range(n):
        for j, (r, c) in enumerate(np.argwhere(forks[i])[:3]):
            rows[i, j], cols[i, j] = r, c
    ovr, ovc = rng.integers(0, SIZE, size=(2, n, 6, 2))
    return rows, cols, ovr, ovc


def moves(boards: np.ndarray):
    """One move per board, on a naive fork cell where the board has one
    (every other board), black on three boards of four; the boards with
    the move played, its cell, sign and stone count."""
    rng = np.random.default_rng(2)
    boards = boards.copy()
    n = len(boards)
    forks = naive_forks(boards)
    rows, cols = np.zeros(n, np.int64), np.zeros(n, np.int64)
    signs = np.where(np.arange(n) % 4 == 3, CIRCLE, CROSS).astype(np.int8)
    for i in range(n):
        cells = np.argwhere(forks[i]) if i % 2 == 0 else np.empty((0, 2))
        if not len(cells):
            cells = np.argwhere(boards[i] == NONE)
        rows[i], cols[i] = cells[rng.integers(len(cells))]
        boards[i, rows[i], cols[i]] = signs[i]
    return boards, rows, cols, signs, (boards != NONE).sum((1, 2)).astype(np.int32)


PLANE_CASES = {
    "default": {},
    "depth1": dict(depth=1, escalate_depth=2),
    "depth0": dict(depth=0, escalate_depth=1, escalate_cap=4),
}
QUERY_CASES = [(d, ov, mf) for d in (0, 1, 2) for ov in (False, True) for mf in (8, None, 1)]
OUTCOME_DEPTHS = (0, 1, 2)


def jax_renju_forbidden() -> dict:
    jt = jax_tables()
    out = {}
    boards = jnp.asarray(clustered())
    for name, kw in PLANE_CASES.items():
        plane, res = jax.jit(lambda b: JV.forbidden_plane_u(jt, b, **kw))(boards)
        out[f"{name}.plane"], out[f"{name}.residual"] = np.asarray(plane), np.asarray(res)
    for name in ("fixture", "forks"):
        plane, res = jax.jit(lambda b: JV.forbidden_plane_u(jt, b))(
            jnp.asarray(overflow_boards(name == "forks")))
        out[f"overflow.{name}.plane"] = np.asarray(plane)
        out[f"overflow.{name}.residual"] = np.asarray(res)
    return out


def jax_renju_checks() -> dict:
    jt = jax_tables()
    out = {}
    boards = clustered()
    rows, cols, ovr, ovc = (jnp.asarray(a) for a in queries(boards))
    for depth, use_ov, mf in QUERY_CASES:
        ov = (ovr, ovc) if use_ov else (None, None)
        f, u = jax.jit(lambda b, r, c, o1, o2: JV.is_forbidden_u(
            jt, b, r, c, depth, o1, o2, max_forks=mf))(jnp.asarray(boards), rows, cols, *ov)
        out[f"query.{depth}.{use_ov}.{mf}.forbidden"] = np.asarray(f)
        out[f"query.{depth}.{use_ov}.{mf}.uncertain"] = np.asarray(u)
    played, r, c, signs, count = moves(boards)
    for depth in OUTCOME_DEPTHS:
        for movers in ("mixed", "circle"):
            s = signs if movers == "mixed" else np.full_like(signs, CIRCLE)
            o = jax.jit(lambda b, r_, c_, s_, n_: JV.outcome_after(jt, b, r_, c_, s_, n_, 225,
                                                                  depth))(
                jnp.asarray(played), jnp.asarray(r), jnp.asarray(c), jnp.asarray(s),
                jnp.asarray(count))
            out[f"outcome.{depth}.{movers}"] = np.asarray(o)
    from alphagomoku_tpu.patterns import features as JF

    stm = np.where(np.arange(len(boards)) % 2 == 0, CROSS, CIRCLE).astype(np.int8)
    out["encode"] = np.asarray(jax.jit(lambda b, s: JF.encode(jt, b, s))(
        jnp.asarray(boards), jnp.asarray(stm))).astype(np.int64)
    return out


def jax_renju_defensive() -> dict:
    from alphagomoku_tpu.patterns import defensive as JD

    tabs = JD.get_tables(RENJU)
    out = {f"tables.{name}": getattr(tabs, name) for name in ("five", "open_four", "double_four")}
    windows, circle = random_ext_windows(0)
    for threat in THREATS:
        res = jax.jit(lambda p, c: JD.get_moves_batched(RENJU, p, c, threat))(
            jnp.asarray(windows.astype(np.uint32)), jnp.asarray(circle))
        out[f"moves.{threat}"] = np.asarray(res).astype(np.int64)
    return out


@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_forbidden_plane_matches_jax(case):
    """Plane and certificate equal the JAX package's; at the default depths
    the certificate is clear and every cell equals the exact host
    recursion; the shallower cases leave cells uncertain and escalate."""
    ref = torch_golden.load("renju_forbidden")
    boards = clustered()
    plane, residual = TV.forbidden_plane_u(TABLES, torch.from_numpy(boards), **PLANE_CASES[case])
    assert np.array_equal(plane.numpy(), ref[f"{case}.plane"])
    assert np.array_equal(residual.numpy(), ref[f"{case}.residual"])
    if case != "default":
        assert residual.any() or case == "depth1"
        return
    assert not residual.any() and plane.any()
    for i, board in enumerate(boards):
        for r, c in np.argwhere(board == NONE):
            assert plane[i, r, c] == host_rules.is_forbidden(board, Move(int(r), int(c), CROSS))
    assert not plane[torch.from_numpy(boards) != NONE].any()


@pytest.mark.parametrize("name", ["fixture", "forks"])
def test_forbidden_plane_overflow_matches_jax(name):
    """256 copies of one board.  Past the global cap of 128 fork cells the
    uncovered ones keep the (forbidden) upper bound, flagged uncertain, and
    the first 32 of them escalate: the plane and the certificate equal the
    JAX package's (the cells resolved are chosen in the same order), and
    row 0, whose fork cells come first, is exact."""
    boards = overflow_boards(name == "forks")
    ref = torch_golden.load("renju_forbidden")
    plane, residual = TV.forbidden_plane_u(TABLES, torch.from_numpy(boards))
    assert np.array_equal(plane.numpy(), ref[f"overflow.{name}.plane"])
    assert np.array_equal(residual.numpy(), ref[f"overflow.{name}.residual"])
    exact = np.array([[host_rules.is_forbidden(boards[0], Move(r, c, CROSS))
                       if boards[0, r, c] == NONE else False for c in range(SIZE)]
                      for r in range(SIZE)])
    assert np.array_equal(plane[0].numpy(), exact)
    if name == "forks":
        assert naive_forks(boards).sum() > 128 + 32
        assert residual.any() and not residual[0].any()


@pytest.mark.parametrize("case", QUERY_CASES, ids=lambda c: "-".join(map(str, c)))
def test_is_forbidden_u_matches_jax(case):
    depth, use_ov, mf = case
    ref = torch_golden.load("renju_checks")
    boards = clustered()
    rows, cols, ovr, ovc = (torch.from_numpy(a) for a in queries(boards))
    ov = (ovr, ovc) if use_ov else (None, None)
    f, u = TV.is_forbidden_u(TABLES, torch.from_numpy(boards), rows, cols, depth, *ov,
                             max_forks=mf)
    assert np.array_equal(f.numpy(), ref[f"query.{depth}.{use_ov}.{mf}.forbidden"])
    assert np.array_equal(u.numpy(), ref[f"query.{depth}.{use_ov}.{mf}.uncertain"])
    assert f.any()


def test_windows_promotion_straight_four_match_jax():
    """`windows_at` with overlay stones equals both of the JAX package's
    versions; the promotion masks and the straight-four scan of them too."""
    boards = clustered()
    rows, cols, ovr, ovc = queries(boards)
    args = [jnp.asarray(a) for a in (boards, rows, cols, ovr, ovc)]
    ours = TV.windows_at(*(torch.from_numpy(a) for a in (boards, rows, cols, ovr, ovc)))
    for fn in (JV.windows_at, JV.windows_at_sel):
        assert np.array_equal(np.asarray(fn(*args)).astype(np.int64), ours.numpy())
    plain = TV.windows_at(*(torch.from_numpy(a) for a in (boards, rows, cols)))
    assert not torch.equal(plain, ours)
    jw = JV.windows_at(*args)
    assert np.array_equal(np.asarray(JV.promotion_masks(jw)).astype(np.int64),
                          TV.promotion_masks(ours).numpy())
    assert np.array_equal(np.asarray(JV._straight_four(jw)), TV._straight_four(ours).numpy())
    assert TV.promotion_masks(ours).any() and TV._straight_four(ours).any()


@pytest.mark.parametrize("depth", OUTCOME_DEPTHS)
def test_outcome_after_matches_jax(depth):
    """The renju outcome: a black move on a forbidden cell loses unless it
    makes a five; shallow checks escalate their uncertain boards."""
    ref = torch_golden.load("renju_checks")
    played, r, c, signs, count = moves(clustered())
    for movers in ("mixed", "circle"):
        s = signs if movers == "mixed" else np.full_like(signs, CIRCLE)
        out = TV.outcome_after(TABLES, *(torch.from_numpy(a) for a in (played, r, c, s, count)),
                               225, depth)
        assert np.array_equal(out.numpy(), ref[f"outcome.{depth}.{movers}"]), movers
        if movers == "mixed":
            # a black move that loses on a forbidden cell
            lost = (out.numpy() == int(GameOutcome.CIRCLE_WIN)) & (signs == CROSS)
            assert lost.any()


def test_encode_bit6_matches_jax():
    """Feature bit 6 marks the cells forbidden for cross, on the boards
    where cross is to move only."""
    ref = torch_golden.load("renju_checks")["encode"]
    boards = clustered()
    stm = np.where(np.arange(len(boards)) % 2 == 0, CROSS, CIRCLE).astype(np.int8)
    ours = TF.encode(TABLES, torch.from_numpy(boards), torch.from_numpy(stm)).numpy()
    assert np.array_equal(ours, ref)
    bit6 = (ours >> 6) & 1
    assert bit6[0::2].any() and not bit6[1::2].any()


def test_renju_tables_and_threat_planes_match_jax():
    """The renju threat table, the defensive-move tables and their lookup
    (golden renju_defensive), and the solver's renju threat planes."""
    assert np.array_equal(TT._build_threat_table(RENJU), JT._build_threat_table(RENJU))
    ref = torch_golden.load("renju_defensive")
    tabs = TD.get_tables(RENJU)
    for name in ("five", "open_four", "double_four"):
        assert np.array_equal(getattr(tabs, name), ref[f"tables.{name}"]), name
    windows, circle = random_ext_windows(0)
    for threat in THREATS:
        ours = TD.get_moves_batched(RENJU, torch.from_numpy(windows), torch.from_numpy(circle),
                                    threat)
        assert np.array_equal(ours.numpy().astype(np.int64), ref[f"moves.{threat}"]), threat

    from alphagomoku_tpu.patterns import bitwise as JB
    from alphagomoku_tpu.search import lockstep as JL

    boards = clustered()
    circle_b = np.arange(len(boards)) % 3 == 0
    keys = ("five", "four", "win3", "three", "n3", "certain_forb", "maybe_forb")

    @jax.jit
    def jax_side(b, circ):
        px, po = JL.classify(b, RENJU, JB.THREAT_KINDS)
        own = jnp.where(circ[:, None, None, None], po, px)
        planes = JL.actor_planes(own, b == 0, (~circ)[:, None, None], True)
        return [planes[k] for k in keys]

    tb, tc = torch.from_numpy(boards), torch.from_numpy(circle_b)
    px, po = TL.classify(tb, RENJU, TB.THREAT_KINDS)
    planes = TL.actor_planes(torch.where(tc[:, None, None, None], po, px), tb == 0,
                             (~tc)[:, None, None], True)
    for k, want in zip(keys, jax_side(jnp.asarray(boards), jnp.asarray(circle_b))):
        assert np.array_equal(np.asarray(want).astype(np.int64), planes[k].numpy().astype(
            np.int64)), k
    assert planes["maybe_forb"].any() and planes["certain_forb"].any()


# ---------------------------------------------------------------------------
# The reference's lax.cond gates: each branch, run on a false predicate,
# returns the value of the branch not taken, so a gate may run always or
# be tested on the host.
# ---------------------------------------------------------------------------

def _naive(wins, rq, cq):
    """The depth-0 check of flat queries [B, Q]: windows, cross
    PatternTypes, naive verdict, naive 3x3 fork."""
    windows = TV._windows_at(wins, SIZE, rq, cq, None)
    pts, _ = TB.classify_by_table(windows, RENJU, TB.THREAT_KINDS)
    threat = TV.threat_type(TABLES, pts, False)
    return windows, pts, TV._naive_forbidden(threat), threat == TT.TT_FORK_3x3


def _no_fork_queries():
    """The query cells of `queries` with every naive fork moved to a
    quiet corner: boards, their windows, flat rows and cols [B, 6]."""
    boards = clustered()
    rows, cols, _, _ = queries(boards)
    tb = torch.from_numpy(boards)
    wins = TV.windows_all(tb).reshape(len(boards), 4, -1)
    rq, cq = torch.from_numpy(rows), torch.from_numpy(cols)
    fork = _naive(wins, rq, cq)[3]
    assert fork.any()
    rq, cq = torch.where(fork, 0, rq), torch.where(fork, 0, cq)
    return tb, wins, rq, cq


def test_gate_resolve_is_a_no_op_without_forks():
    """is_forbidden_u's resolve gate (host-tested): on queries without a
    fork the resolve branch, applied as the gated form applies it, gives
    the naive verdict the skipped branch gives."""
    tb, wins, rq, cq = _no_fork_queries()
    windows, pts, naive, is_fork = _naive(wins, rq, cq)
    assert not is_fork.any()
    resolved, res_unc = TV._resolve(TABLES, tb, wins, rq, cq, None, 2, windows, pts)
    assert torch.equal(torch.where(is_fork, resolved, naive), naive)
    assert not (is_fork & res_unc).any()
    f, u = TV.is_forbidden_u(TABLES, tb, rq, cq, 2)
    assert torch.equal(f, naive) and not u.any()


def test_gate_compaction_is_a_no_op_without_forks():
    """is_forbidden_u's compaction gate (host-tested): the compacted
    resolve on queries without a fork returns the naive verdict, certain."""
    tb, wins, rq, cq = _no_fork_queries()
    _, _, naive, is_fork = _naive(wins, rq, cq)
    assert not is_fork.any()
    forb, unc = TV._resolve_compacted(TABLES, tb, wins, rq, cq, None, 2, 1, naive, is_fork)
    assert torch.equal(forb, naive) and not unc.any()
    f, u = TV.is_forbidden_u(TABLES, tb, rq, cq, 2, max_forks=1)
    assert torch.equal(f, naive) and not u.any()


def test_gate_escalations_are_no_ops_without_uncertainty():
    """The escalation gates of outcome_after and forbidden_plane_u
    (host-tested): with nothing uncertain both branches return their
    inputs."""
    boards = clustered()
    played, r, c, _, _ = moves(boards)
    tb = torch.from_numpy(played)
    forb = torch.from_numpy(np.arange(len(boards)) % 3 == 0)
    none = torch.zeros_like(forb)
    assert torch.equal(TV._escalate_boards(TABLES, tb, torch.from_numpy(r),
                                           torch.from_numpy(c), forb, none, 3), forb)
    flat = torch.from_numpy(naive_forks(boards).reshape(-1))
    none = torch.zeros_like(flat)
    f, u = TV._escalate_forbidden(TABLES, torch.from_numpy(boards), flat, none, 3, 32)
    assert torch.equal(f, flat) and not u.any()


def test_gates_always_taken_match_the_skipped_branch():
    """outcome_after's any(black mover) gate and forbidden_plane_u's
    any(fork) gate always run their branch here: with circle movers only
    the renju outcome equals the JAX package's (which skipped it) and the
    plain five/draw outcome; on a board without forks the plane is the
    outright-forbidden one (overlines and 4x4 forks), certain."""
    played, r, c, signs, count = moves(clustered())
    args = [torch.from_numpy(a) for a in (played, r, c, np.full_like(signs, CIRCLE), count)]
    renju = TV.outcome_after(TABLES, *args, 225)
    free = TV.outcome_after(TV.device_tables(GameRules.FREESTYLE), *args, 225)
    assert torch.equal(renju, free)
    quiet = np.zeros((1, SIZE, SIZE), np.int8)
    quiet[0, 7, 3:6] = CROSS  # (7, 6) makes fours in two directions
    quiet[0, 4:7, 6] = CROSS
    quiet[0, 12, 12] = CIRCLE
    assert not naive_forks(quiet).any()
    plane, residual = TV.forbidden_plane_u(TABLES, torch.from_numpy(quiet))
    assert plane.sum() >= 1 and plane[0, 7, 6] and not residual.any()
    assert all(plane[0, r, c] == host_rules.is_forbidden(quiet[0], Move(r, c, CROSS))
               for r in range(SIZE) for c in range(SIZE) if quiet[0, r, c] == NONE)
