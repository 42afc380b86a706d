"""Batched game rules on `[B, H, W]` int8 boards: the search path's subset.

Port of the reference package's `game/vectorized.py` for all five rules:
line-window extraction, the outcome check after a move, the ThreatType
lookup, and renju's forbidden-move check for black (`is_forbidden_u`,
`forbidden_plane_u`).  Windows are packed 22-bit values (2 bits per cell
over 11 cells, the center masked to NONE) carried in int64.

Renju's fake-three resolution is recursive in the reference
(src/game/rules.cpp:134-173: each level hypothetically places one stone).
As in the reference package, the hypothetical stones ride along as an
overlay patched into the gathered windows, each recursion level is one
batched call over a query axis widened x16, the depth is bounded, and
every place where the bound could change the answer is tracked as an
uncertainty certificate, which an escalation pass at a greater depth
re-resolves.

The reference package gates the costly branches of that recursion with
`lax.cond(any(predicate), branch, default)`; every branch, run on a false
predicate, returns the default's value.  Here each gate either runs its
branch always (no host sync) or tests the predicate on the host
(`host_gate`, one sync each); the choice is stated at each gate.  Its
`top_k` compactions are stable descending sorts, which keep the lowest
index first among equal values as `lax.top_k` does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .types import CROSS, CIRCLE, ILLEGAL, NONE, DIRECTION_STEPS, GameRules, GameOutcome
from ..patterns import bitwise
from ..patterns import tables as T

PAD = T.CENTER  # 5

# window cell offsets along a direction, center excluded
_OFFSETS = [i for i in range(-PAD, PAD + 1) if i != 0]

CAND = 16  # promotion candidates kept per fork cell (an open three has <= 3 per direction)


class RuleTables(NamedTuple):
    """The rule variant the batched functions run under.  The port
    classifies with bit math, so no lookup tables ride along."""

    rules: int  # GameRules


def device_tables(rules: GameRules) -> RuleTables:
    return RuleTables(rules=int(GameRules(rules)))


def host_gate(pred: torch.Tensor) -> bool:
    """`bool(pred.any())`: one host sync, counted in `host_gate.syncs`."""
    host_gate.syncs += 1
    return bool(pred.any())


host_gate.syncs = 0


def pad_board(board: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H+10, W+10] padded with ILLEGAL."""
    bsz, h, w = board.shape
    out = torch.full(
        (bsz, h + 2 * PAD, w + 2 * PAD), ILLEGAL, dtype=board.dtype, device=board.device
    )
    out[:, PAD : PAD + h, PAD : PAD + w] = board
    return out


def windows_all(board: torch.Tensor) -> torch.Tensor:
    """Packed 22-bit windows for EVERY cell: [B, H, W] -> [B, 4, H, W] int64
    (one gather of the 40 window cells of every cell from the padded
    board)."""
    bsz, h, w = board.shape
    idx, shifts = _all_window_index(h, w, board.device)
    cells = pad_board(board).reshape(bsz, -1).to(torch.int64)[:, idx]  # [B, 4, 10, HW]
    return (cells << shifts[:, None]).sum(2).reshape(bsz, 4, h, w)  # disjoint fields: sum == OR


@functools.lru_cache(maxsize=None)
def _all_window_index(h: int, w: int, device: torch.device):
    """Flat indices [4, 10, H*W] into the padded board of the window cells
    of every cell, and the cells' bit shifts [10]."""
    pw = w + 2 * PAD
    r = torch.arange(h)[:, None] + PAD
    c = torch.arange(w)[None, :] + PAD
    idx = torch.stack([
        torch.stack([((r + i * dr) * pw + c + i * dc).reshape(-1) for i in _OFFSETS])
        for dr, dc in DIRECTION_STEPS
    ])
    shifts = 2 * (torch.tensor(_OFFSETS) + PAD)
    return idx.to(device), shifts.to(device)


def windows_at_one(
    board: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    """Packed windows for ONE in-bounds query cell per board:
    [B, H, W] + [B] -> [B, 4] int64 (one gather of the 40 window cells)."""
    bsz, h, w = board.shape
    idx, shifts = _all_window_index(h, w, board.device)
    cell = rows.long() * w + cols.long()
    sel = idx[:, :, cell].permute(2, 0, 1).reshape(bsz, -1)  # [B, 40]
    cells = pad_board(board).reshape(bsz, -1).to(torch.int64).gather(1, sel)
    return (cells.reshape(bsz, 4, -1) << shifts).sum(-1)  # disjoint bit fields: sum == OR


def windows_at(
    board: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    overlay_rows: torch.Tensor | None = None, overlay_cols: torch.Tensor | None = None,
) -> torch.Tensor:
    """Packed windows at in-bounds query cells [B, *S] -> [B, *S, 4] int64,
    with optional hypothetical CROSS stones [B, *S, K] patched in.

    The reference package has two versions, `windows_at` (gathers) and
    `windows_at_sel` (one-hot selects, the overlay patched with bit
    arithmetic); they agree on in-bounds queries, and this is both: the
    windows of `windows_all` gathered at the query cells, the overlay
    stones patched in with bit arithmetic."""
    bsz, h, w = board.shape
    wins = windows_all(board).reshape(bsz, 4, h * w)
    return _windows_at(wins, w, *_flat_queries(rows, cols, overlay_rows, overlay_cols)).reshape(
        rows.shape + (4,))


def _flat_queries(rows, cols, overlay_rows, overlay_cols):
    """Query cells [B, *S] as int64 [B, Q], overlays [B, *S, K] as a pair
    of [B, Q, K] (or None)."""
    bsz = rows.shape[0]
    rq, cq = rows.reshape(bsz, -1).long(), cols.reshape(bsz, -1).long()
    if overlay_rows is None:
        return rq, cq, None
    k = overlay_rows.shape[-1]
    return rq, cq, (overlay_rows.reshape(bsz, -1, k).long(),
                    overlay_cols.reshape(bsz, -1, k).long())


@functools.lru_cache(maxsize=None)
def _direction_steps(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    steps = torch.tensor(DIRECTION_STEPS, dtype=torch.int64, device=device)
    return steps[:, 0], steps[:, 1]


def _windows_at(wins: torch.Tensor, w: int, rq: torch.Tensor, cq: torch.Tensor,
                ov: tuple[torch.Tensor, torch.Tensor] | None) -> torch.Tensor:
    """`windows_at` on flat queries: the board's windows `wins` [B, 4, HW],
    query cells [B, Q], overlays [B, Q, K] -> [B, Q, 4]."""
    bsz, _, hw = wins.shape
    flat = rq * w + cq
    inb = (flat >= 0) & (flat < hw)
    acc = wins.gather(2, flat.clamp(0, hw - 1)[:, None, :].expand(bsz, 4, -1))
    acc = torch.where(inb[:, None], acc, 0).transpose(1, 2)  # [B, Q, 4]
    if ov is None:
        return acc
    sr, sc = _direction_steps(wins.device)
    dr = (ov[0] - rq[..., None])[..., None]  # [B, Q, K, 1]
    dc = (ov[1] - cq[..., None])[..., None]
    # the overlay stone's offset along each direction, where it lies on
    # that direction's line through the query cell
    i = torch.where(sr != 0, dr * sr, dc * sc)  # [B, Q, K, 4]
    aligned = torch.where(sr != 0, dc == i * sc, dr == 0)
    ok = aligned & (i >= -PAD) & (i <= PAD) & (i != 0)
    shift = 2 * (i + PAD).clamp(0, 2 * PAD)
    clear = torch.where(ok, 3 << shift, 0)
    setc = torch.where(ok, CROSS << shift, 0)
    for k in range(ov[0].shape[-1]):  # fold the K stones into one mask
        acc = (acc & ~clear[:, :, k]) | setc[:, :, k]
    return acc


def promotion_masks(windows: torch.Tensor) -> torch.Tensor:
    """Open-three promotion spots (cross attacker): the first of 12 masked
    compares on packed windows -> 11-bit spot masks (reference data:
    src/patterns/DefensiveMoveTable.cpp:329-341)."""
    pat, msk, res = _promo_data(windows.device)
    hit = (windows[..., None] & msk) == pat
    return torch.where(hit.any(-1), res[hit.int().argmax(-1)], 0)


@functools.lru_cache(maxsize=None)
def _promo_data(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(torch.tensor(t, dtype=torch.int64, device=device)
                 for t in (T._PROMO_PATTERNS, T._PROMO_MASKS, T._PROMO_RESULTS))


def _straight_four(windows: torch.Tensor) -> torch.Tensor:
    """Any 4 consecutive crosses in center-filled windows [..., 4] ->
    [..., 4] per direction (reference: RawPatternCalculator::
    isStraightFourAt, a 4-in-a-row scan; candidates come pre-filtered)."""
    wins = windows | (CROSS << (2 * T.CENTER))
    starts = torch.arange(0, 2 * (T.PATTERN_LENGTH - 3), 2, device=windows.device)
    return (((wins[..., None] >> starts) & 255) == 0b01010101).any(-1)


def _naive_forbidden(threat: torch.Tensor) -> torch.Tensor:
    return (threat == T.TT_OVERLINE) | (threat == T.TT_FORK_4x4) | (threat == T.TT_FORK_3x3)


def is_forbidden(
    tables: RuleTables, board: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    depth: int = 2, overlay_rows: torch.Tensor | None = None,
    overlay_cols: torch.Tensor | None = None, max_forks: int | None = 8,
) -> torch.Tensor:
    """Renju forbidden check for BLACK moves at query cells [B, *S] ->
    bool [B, *S]: `is_forbidden_u` without its uncertainty flag."""
    return is_forbidden_u(tables, board, rows, cols, depth, overlay_rows, overlay_cols,
                          max_forks)[0]


def is_forbidden_u(
    tables: RuleTables, board: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    depth: int = 2, overlay_rows: torch.Tensor | None = None,
    overlay_cols: torch.Tensor | None = None, max_forks: int | None = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Renju forbidden check with an exactness certificate: query cells
    [B, *S] (empty or occupied: windows mask the center) -> (forbidden,
    uncertain), both bool [B, *S].

    The reference's recursion (src/game/rules.cpp:134-173) bounded by
    `depth`: `uncertain=False` certifies that `forbidden` is the exact
    unbounded verdict; `uncertain=True` cells return the upper bound
    (forbidden if any resolution of the uncertain sub-checks could make it
    so).  A depth-0 check returns the naive verdict, uncertain on a naive
    3x3 fork; a resolve level widens each fork cell to its <= 16 promotion
    candidates, checks them one level down with the cell as an overlay
    stone, and flags the cell iff the low and high threat bounds disagree.

    `max_forks` caps how many naive-fork query cells per board are
    resolved when the query axis is wide (more than 4 * max_forks cells);
    overflow cells keep the naive verdict, flagged uncertain."""
    bsz, h, w = board.shape
    wins = windows_all(board).reshape(bsz, 4, h * w)
    rq, cq, ov = _flat_queries(rows, cols, overlay_rows, overlay_cols)
    forb, unc = _forbidden_u(tables, board, wins, rq, cq, ov, depth, max_forks)
    return forb.reshape(rows.shape), unc.reshape(rows.shape)


def _forbidden_u(tables, board, wins, rq, cq, ov, depth, max_forks):
    """`is_forbidden_u` on flat queries [B, Q] (overlays [B, Q, K]) with
    the board's windows `wins` [B, 4, HW], shared by every level."""
    windows = _windows_at(wins, board.shape[2], rq, cq, ov)  # [B, Q, 4]
    # THREAT_KINDS leave out only half-open threes, which decide no
    # ThreatType above TT_HALF_OPEN_3: the forbidden verdicts are those of
    # the full classification
    pts, _ = bitwise.classify_by_table(windows, GameRules(tables.rules), bitwise.THREAT_KINDS)
    threat = threat_type(tables, pts, False)
    naive = _naive_forbidden(threat)
    is_fork = threat == T.TT_FORK_3x3
    if depth <= 0:
        # naive non-forbidden is exact (resolution only ever demotes
        # threes); a naive 3x3 fork could resolve to fake: uncertain
        return naive, is_fork
    # gate any(fork), of both branches below: host (they widen each fork
    # query x16 and recurse, and most queries hold no fork)
    if not host_gate(is_fork):
        return naive, torch.zeros_like(naive)
    if max_forks is not None and rq.shape[1] > 4 * max_forks:
        return _resolve_compacted(tables, board, wins, rq, cq, ov, depth, max_forks, naive,
                                  is_fork)
    resolved, res_unc = _resolve(tables, board, wins, rq, cq, ov, depth, windows, pts)
    return torch.where(is_fork, resolved, naive), is_fork & res_unc


def first_k(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first `k` entries of `mask`'s last axis as
    `lax.top_k` of the 0/1 mask orders them: true entries first, each
    group in index order (a stable descending sort; `torch.topk` promises
    no order among equal values)."""
    return torch.sort(mask.int(), dim=-1, descending=True, stable=True).indices[..., :k]


def _resolve_compacted(tables, board, wins, rq, cq, ov, depth, max_forks, naive, is_fork):
    """Resolve at most `max_forks` fork query cells per board (the first
    in index order), the verdicts scattered back over the naive answer;
    unresolved fork cells keep it, flagged uncertain."""
    idx = first_k(is_fork, max_forks)  # [B, F]
    valid = is_fork.gather(1, idx)
    sub_ov = None
    if ov is not None:
        oidx = idx[..., None].expand(-1, -1, ov[0].shape[-1])
        sub_ov = (ov[0].gather(1, oidx), ov[1].gather(1, oidx))
    sub_forb, sub_unc = _forbidden_u(tables, board, wins, rq.gather(1, idx), cq.gather(1, idx),
                                     sub_ov, depth, None)
    zero = torch.zeros_like(is_fork)
    resolved = zero.scatter(1, idx, sub_forb & valid)
    unc = zero.scatter(1, idx, sub_unc & valid)
    uncovered = is_fork & ~zero.scatter(1, idx, valid)
    return (naive & ~is_fork) | resolved | uncovered, unc | uncovered


@functools.lru_cache(maxsize=None)
def _spots(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 40 (direction, offset) promotion spots of a window: direction
    [40], offset [40] and the direction's row and column steps [40]."""
    d = torch.arange(4).repeat_interleave(len(_OFFSETS))
    off = torch.tensor(_OFFSETS).repeat(4)
    steps = torch.tensor(DIRECTION_STEPS)[d]
    return tuple(t.to(device) for t in (d, off, steps[:, 0], steps[:, 1]))


def _resolve(tables, board, wins, rq, cq, ov, depth, windows, pts):
    """One resolve level for flat queries [B, Q]: (forbidden upper bound,
    low and high bounds differ), both [B, Q]."""
    bsz, h, w = board.shape
    q = rq.shape[1]
    d40, off40, sr40, sc40 = _spots(board.device)
    promo = promotion_masks(windows)  # [B, Q, 4]
    r2 = rq[..., None] + off40 * sr40  # [B, Q, 40]
    c2 = cq[..., None] + off40 * sc40
    bit = ((promo[:, :, d40] >> (PAD + off40)) & 1) == 1
    ok = bit & (r2 >= 0) & (r2 < h) & (c2 >= 0) & (c2 < w)
    # compact to the <= 16 live candidates before widening the query axis
    top = first_k(ok, CAND)  # [B, Q, 16]
    rr = r2.clamp(0, h - 1).gather(2, top)
    cc = c2.clamp(0, w - 1).gather(2, top)
    ok = ok.gather(2, top)
    dirs = d40[top]
    # the fork cell rides along as an overlay stone after the earlier ones
    here = (rq[:, :, None, None].expand(-1, -1, CAND, 1), cq[:, :, None, None].expand(-1, -1, CAND, 1))
    if ov is None:
        ov_r, ov_c = here
    else:
        k = ov[0].shape[-1]
        ov_r = torch.cat([ov[0][:, :, None, :].expand(-1, -1, CAND, k), here[0]], -1)
        ov_c = torch.cat([ov[1][:, :, None, :].expand(-1, -1, CAND, k), here[1]], -1)
    # the candidate spot must be empty on the overlaid board
    base = board.reshape(bsz, h * w).gather(1, (rr * w + cc).reshape(bsz, -1)).reshape(rr.shape)
    on_overlay = ((ov_r == rr[..., None]) & (ov_c == cc[..., None])).any(-1)
    empty = (base == NONE) & ~on_overlay
    flat_ov = (ov_r.reshape(bsz, q * CAND, -1), ov_c.reshape(bsz, q * CAND, -1))
    rf, cf = rr.reshape(bsz, -1), cc.reshape(bsz, -1)
    cand_wins = _windows_at(wins, w, rf, cf, flat_ov).reshape(bsz, q, CAND, 4)
    sf = _straight_four(cand_wins).gather(3, dirs[..., None])[..., 0]
    nested, nested_unc = _forbidden_u(tables, board, wins, rf, cf, flat_ov, depth - 1, 8)
    nested, nested_unc = nested.reshape(rr.shape), nested_unc.reshape(rr.shape)
    # the child's verdict is its upper bound: ~nested is "certainly not
    # forbidden", ~nested | nested_unc "possibly not forbidden"
    promotes = ok & empty & sf
    by_dir = dirs[..., None] == torch.arange(4, device=board.device)  # [B, Q, 16, 4]
    certain_real = ((promotes & ~nested)[..., None] & by_dir).any(2)  # [B, Q, 4]
    maybe_real = ((promotes & (~nested | nested_unc))[..., None] & by_dir).any(2)
    # the low bound demotes every not-certainly-real three, the high bound
    # keeps every possibly-real one; forbidden-ness is monotone in the
    # surviving threes, so the true verdict lies between them
    open3 = pts == T.PT_OPEN_3
    f_low = _naive_forbidden(threat_type(tables, torch.where(open3 & ~certain_real, 0, pts), False))
    f_high = _naive_forbidden(threat_type(tables, torch.where(open3 & ~maybe_real, 0, pts), False))
    return f_high, f_low != f_high


def threat_type(tables: RuleTables, pts: torch.Tensor, sign_is_circle) -> torch.Tensor:
    """Combine 4 directional PatternTypes (last axis) into a ThreatType;
    `sign_is_circle` is a bool broadcastable to `pts.shape[:-1]`."""
    pts = pts.long()
    idx = pts[..., 0] | (pts[..., 1] << 3) | (pts[..., 2] << 6) | (pts[..., 3] << 9)
    enc = _threat_table(GameRules(tables.rules), pts.device)[idx]
    circle = torch.as_tensor(sign_is_circle, device=enc.device)
    return (enc >> torch.where(circle, 4, 0)) & 15


@functools.lru_cache(maxsize=None)
def _threat_table(rules: GameRules, device: torch.device) -> torch.Tensor:
    """int32 [8^4]: ThreatType nibbles (cross | circle << 4), on `device`
    at its first use there."""
    return torch.from_numpy(T._build_threat_table(rules).astype(np.int32)).to(device)


def outcome_after(
    tables: RuleTables,
    board: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    signs: torch.Tensor,
    move_count: torch.Tensor,
    draw_after: int,
    forbidden_depth: int = 2,
) -> torch.Tensor:
    """GameOutcome [B] int8 after `signs` played at (rows, cols); `board`
    must already contain the move.  `move_count` counts stones including
    this move (reference: src/game/rules.cpp:110-133).  Under renju a
    black move on a forbidden cell loses, unless it makes a five."""
    is_circle = signs == CIRCLE
    fx, fo = bitwise.five_mask(windows_at_one(board, rows, cols), GameRules(tables.rules))
    five = torch.where(is_circle[:, None], fo, fx).any(-1)
    win = torch.where(
        is_circle, int(GameOutcome.CIRCLE_WIN), int(GameOutcome.CROSS_WIN)
    ).to(torch.int8)
    out = torch.full_like(signs, int(GameOutcome.UNKNOWN), dtype=torch.int8)
    out = torch.where(move_count >= draw_after, int(GameOutcome.DRAW), out).to(torch.int8)
    if tables.rules == GameRules.RENJU:
        # gate any(~is_circle): always taken (a search's batch holds black
        # movers at every step)
        forb, unc = is_forbidden_u(tables, board, rows, cols, forbidden_depth)
        unc = unc & ~is_circle & ~five
        # gate: host (the bounded check is almost never uncertain)
        if host_gate(unc):
            forb = _escalate_boards(tables, board, rows, cols, forb, unc, forbidden_depth + 1)
        out = torch.where(forb & ~is_circle & ~five, int(GameOutcome.CIRCLE_WIN), out)
    return torch.where(five, win, out).to(torch.int8)


def _escalate_boards(tables, board, rows, cols, forb, unc, depth):
    """Recheck up to 8 boards whose move's bounded check was uncertain
    (the first in index order) at `depth`; the others keep `forb`."""
    bidx = first_k(unc, min(8, board.shape[0]))
    vals = unc[bidx]
    f2, _ = is_forbidden_u(tables, board[bidx], rows[bidx, None], cols[bidx, None], depth,
                           max_forks=None)
    zero = torch.zeros_like(unc)
    res = zero.index_copy(0, bidx, f2[:, 0] & vals)
    covered = zero.index_copy(0, bidx, vals)
    return torch.where(covered & unc, res, forb)


def forbidden_plane(tables: RuleTables, board: torch.Tensor, depth: int = 2) -> torch.Tensor:
    """[B, H, W] bool: renju-forbidden empty cells for black (all false
    under the other rules); `forbidden_plane_u` without the certificate."""
    return forbidden_plane_u(tables, board, depth)[0]


def forbidden_plane_u(
    tables: RuleTables, board: torch.Tensor, depth: int = 2,
    escalate_depth: int = 3, escalate_cap: int = 32, pts_cross: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] forbidden plane plus a [B, H, W] residual-uncertainty
    certificate (all false: provably exact against the unbounded
    recursion, src/game/rules.cpp:134-173).

    Overlines and 4x4 forks are forbidden outright; the naive 3x3 fork
    cells (rare) are compacted globally across the batch, the first 128
    in flat index order checked by `is_forbidden_u` at `depth`; overflow
    cells keep the (forbidden) upper bound, flagged uncertain.  Flagged
    cells are then re-resolved at `escalate_depth`, at most
    `escalate_cap` of them; what stays uncertain keeps the upper bound and
    shows in the certificate.  `pts_cross` [B, H, W, 4], the cross
    PatternTypes of every cell, may be passed when the caller has them."""
    bsz, h, w = board.shape
    if tables.rules != GameRules.RENJU:
        z = torch.zeros(board.shape, dtype=torch.bool, device=board.device)
        return z, z
    if pts_cross is None:
        wins = windows_all(board).movedim(1, -1)
        pts_cross, _ = bitwise.classify_by_table(wins, GameRules.RENJU, bitwise.THREAT_KINDS)
    threat = threat_type(tables, pts_cross, False)
    empty = board == NONE
    hard = empty & ((threat == T.TT_OVERLINE) | (threat == T.TT_FORK_4x4))
    flat = (empty & (threat == T.TT_FORK_3x3)).reshape(-1)
    # gate any(fork): always taken (at a search's batch some board holds a
    # fork cell at nearly every step); run on no fork, it resolves 128
    # non-fork cells and scatters back nothing
    idx = first_k(flat, min(128, flat.numel()))
    vals = flat[idx]
    f, u = _check_cells(tables, board, idx, depth)
    zero = torch.zeros_like(flat)
    uncovered = flat & ~zero.index_copy(0, idx, vals)
    forb = zero.index_copy(0, idx, f & vals) | uncovered
    unc = zero.index_copy(0, idx, u & vals) | uncovered
    # gate: host (the bounded check is almost never uncertain)
    if host_gate(unc):
        forb, unc = _escalate_forbidden(tables, board, forb, unc, escalate_depth, escalate_cap)
    return hard | forb.reshape(bsz, h, w), unc.reshape(bsz, h, w)


def _check_cells(tables, board, idx, depth):
    """`is_forbidden_u` at flat cells `idx` [K] of the flattened [B*H*W]
    grid, each on its own board: (forbidden, uncertain) [K]."""
    h, w = board.shape[1], board.shape[2]
    cell = idx % (h * w)
    f, u = is_forbidden_u(tables, board[idx // (h * w)], (cell // w)[:, None],
                          (cell % w)[:, None], depth, max_forks=None)
    return f[:, 0], u[:, 0]


def _escalate_forbidden(tables, board, forb_flat, unc_flat, depth, cap):
    """Re-resolve up to `cap` globally compacted uncertain cells (flat
    [B*H*W] masks, the first in index order) at `depth`: the corrected
    (forbidden, residual uncertainty)."""
    idx = first_k(unc_flat, min(cap, unc_flat.numel()))
    vals = unc_flat[idx]
    f, u = _check_cells(tables, board, idx, depth)
    zero = torch.zeros_like(unc_flat)
    covered = zero.index_copy(0, idx, vals)
    forb = torch.where(covered, zero.index_copy(0, idx, f & vals), forb_flat)
    return forb, zero.index_copy(0, idx, u & vals) | (unc_flat & ~covered)
