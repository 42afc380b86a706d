"""Batched VCT solver: victory-by-continuous-threats (fours AND open
threes) AND-OR proof search, lockstep over a batch of boards, and the loss
prover built on it.

Port of the reference package's `search/vct_batched.py` (`solve`, and the
loss legs `prepare_loss`, `finish_loss`, `solve_loss`), itself a
re-expression of the reference's threat-space search (src/search/
alpha_beta/{ThreatSpaceSearch,ThreatGenerator}.cpp, AlphaBetaSearch.cpp:
76-135): the recursive AND-OR DFS is a fixed-stack machine advanced one
transition at a time, every board in lockstep.  After an open-three move
the defender is not forced: the complete defender option set
(defensive-move tables + counter-fours) forms an AND node whose options
must ALL be refuted.  A per-board transposition table stores failed
positions with their remaining (depth, three-budget), so re-reached
positions fail at once.

Soundness (every claimed WIN is a true forced win) and the budgets are the
reference package's; `solve` never claims LOSS/DRAW.  Renju: black's
candidates leave out every possibly forbidden cell, a forced block that is
certainly forbidden for a black defender counts as a win, and forbidden
defender options are kept (the attacker must refute them too).  The loss
prover refutes every option of a complete defensive set with the attacker
VCT on the children, in one lockstep batch.

The reference package runs the machine in a `lax.while_loop` that stops
when the step budget is spent or no board is still searching.  Here a
finished board is a fixed point of the transition (every write is gated by
the board's phase, and a finished board is in none), so `solve` checks for
a searching board only every `_CHECK_EVERY` transitions, one host sync per
check, and the extra transitions change nothing.  The state tensors are
updated in place (the solve owns them); u32 hashes are carried in int64.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..game.types import CROSS, CIRCLE, DIRECTION_STEPS, ILLEGAL, NONE, GameRules
from ..game import vectorized as V
from ..patterns import bitwise
from ..patterns import defensive as DEF
from ..patterns import tables as T
from . import lockstep as L


class VCTBatchedResult(NamedTuple):
    win: torch.Tensor  # [B] bool: forced win proven for the side to move
    best_move: torch.Tensor  # [B] int32 flat first move of the proof (-1)
    distance: torch.Tensor  # [B] int32 plies to mate (0 when unproven)


_SEARCHING, _WIN, _FAIL = 0, 1, 2
_ADV, _RETW, _RETF = 0, 1, 2
_TT_BIG_DEPTH = 127  # depth-independent fail entries (static refutations)
_CHECK_EVERY = 4  # transitions between host checks for a searching board

def _ext_windows_at_one(board: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """26-bit 13-cell extended windows at ONE in-bounds empty cell per
    board: [B, H, W] + [B] -> [B, 4] int64 (reference: RawPatternCalculator
    extended window extraction).  The inner 11 cells are `windows_at_one`;
    the two edge cells (offsets -6 and +6) are read from an ILLEGAL-padded
    board."""
    bsz, h, w = board.shape
    inner = V.windows_at_one(board, rows, cols)  # [B, 4], center empty
    ext = inner << 2  # offsets -5..5 move to positions 1..11; center = NONE
    p6 = torch.full((bsz, h + 12, w + 12), ILLEGAL, dtype=torch.int64, device=board.device)
    p6[:, 6:6 + h, 6:6 + w] = board
    b = torch.arange(bsz, device=board.device)
    r, c = rows.long() + 6, cols.long() + 6
    out = []
    for d, (dr, dc) in enumerate(DIRECTION_STEPS):
        acc = ext[:, d]
        for off, pos in ((-6, 0), (6, 12)):
            acc = acc | (p6[b, r + off * dr, c + off * dc] << (2 * pos))
        out.append(acc)
    return torch.stack(out, dim=-1)


@lru_cache(maxsize=None)
def _line_consts(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_table_cells`' direction steps [4, 2], offsets -6..6 and bit
    positions 0..12, and the [1, 1, 9, 9] star of the cells within 4
    steps along a direction."""
    steps = torch.tensor(DIRECTION_STEPS, dtype=torch.int64)
    offs = torch.arange(DEF.EXT_LENGTH, dtype=torch.int64) - DEF.CENTER
    star = torch.zeros((1, 1, 9, 9))
    for dr, dc in DIRECTION_STEPS:
        for i in range(-4, 5):
            if i:
                star[0, 0, 4 + i * dr, 4 + i * dc] = 1.0
    return tuple(t.to(device) for t in (steps, offs, torch.arange(DEF.EXT_LENGTH), star))


def _table_cells(dmask: torch.Tensor, mr: torch.Tensor, mc: torch.Tensor, h: int, w: int
                 ) -> torch.Tensor:
    """[B, HW] bool: the cells that the 13-bit defensive-table masks
    `dmask` [B, 4] (one per direction, centered on the cell (mr, mc) [B])
    name, inside the board."""
    bsz = dmask.shape[0]
    steps, offs, bit_pos, _ = _line_consts(dmask.device)
    bit = ((dmask[:, :, None] >> bit_pos) & 1) == 1  # [B, 4, 13]
    rr = mr[:, None, None] + offs[None, None, :] * steps[None, :, 0:1]
    cc = mc[:, None, None] + offs[None, None, :] * steps[None, :, 1:2]
    ok = bit & (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    cell = (rr.clamp(0, h - 1) * w + cc.clamp(0, w - 1)).reshape(bsz, -1)
    out = torch.zeros((bsz, h * w), dtype=torch.int32, device=dmask.device)
    return out.scatter_add_(1, cell, ok.reshape(bsz, -1).to(torch.int32)) > 0


class _State(NamedTuple):
    board: torch.Tensor  # [B, H, W] int8 (mutated along the line)
    ply: torch.Tensor  # [B] int64 current frame depth (0-based)
    phase: torch.Tensor  # [B] int8: ADV / RET_WIN / RET_FAIL
    att_move: torch.Tensor  # [B, D] int64 current attacker candidate per ply
    def_move: torch.Tensor  # [B, D] int64 current defender option per ply
    att_tried: torch.Tensor  # [B, D, HW] bool
    def_opts: torch.Tensor  # [B, D, HW] bool: defender AND-set per ply
    def_tried: torch.Tensor  # [B, D, HW] bool: refuted defender options
    threes_left: torch.Tensor  # [B, D+1] int64 three-budget at frame entry
    tt_hash: torch.Tensor  # [B, S] int64 u32 verification hashes
    tt_depth: torch.Tensor  # [B, S] int64 remaining depth proven failed
    tt_threes: torch.Tensor  # [B, S] int64 three-budget proven failed
    status: torch.Tensor  # [B] int8
    win_extra: torch.Tensor  # [B] int64 plies beyond 2*win_ply at the win
    win_ply: torch.Tensor  # [B] int64 frame depth where the win closed


def _init_state(board: torch.Tensor, max_depth: int, max_threes: int, tt_slots: int) -> _State:
    bsz, h, w = board.shape
    D, S, dev = max_depth, tt_slots, board.device
    i64 = dict(dtype=torch.int64, device=dev)
    threes_left = torch.zeros((bsz, D + 1), **i64)
    threes_left[:, 0] = max_threes
    return _State(
        board=board.to(torch.int8).clone(),
        ply=torch.zeros(bsz, **i64),
        phase=torch.full((bsz,), _ADV, dtype=torch.int8, device=dev),
        att_move=torch.full((bsz, D), -1, **i64),
        def_move=torch.full((bsz, D), -1, **i64),
        att_tried=torch.zeros((bsz, D, h * w), dtype=torch.bool, device=dev),
        def_opts=torch.zeros((bsz, D, h * w), dtype=torch.bool, device=dev),
        def_tried=torch.zeros((bsz, D, h * w), dtype=torch.bool, device=dev),
        threes_left=threes_left,
        tt_hash=torch.zeros((bsz, S), **i64),
        tt_depth=torch.full((bsz, S), -1, **i64),
        tt_threes=torch.full((bsz, S), -1, **i64),
        status=torch.full((bsz,), _SEARCHING, dtype=torch.int8, device=dev),
        win_extra=torch.zeros(bsz, **i64),
        win_ply=torch.zeros(bsz, **i64),
    )


def _make_transition(rules: GameRules, stm: torch.Tensor, max_depth: int, max_defenses: int,
                     tt_slots: int):
    """One lockstep transition `st -> st` of the machine for the side to
    move `stm` [B]; it updates the frame tensors of `st` in place."""
    dev = stm.device
    D, S = max_depth, tt_slots
    stm = stm.to(torch.int8)
    stm_is_circle = stm == CIRCLE
    def_sign = torch.where(stm == CROSS, CIRCLE, CROSS).to(torch.int8)
    def_is_circle = ~stm_is_circle
    own_cross, their_cross = def_is_circle[:, None, None], stm_is_circle[:, None, None]
    renju = rules == GameRules.RENJU

    b = torch.arange(stm.shape[0], device=dev)

    def step(st: _State) -> _State:
        bsz, h, w = st.board.shape
        hw = h * w
        searching = st.status == _SEARCHING
        adv = searching & (st.phase == _ADV)
        retw = searching & (st.phase == _RETW)
        retf = searching & (st.phase == _RETF)
        ply_idx = st.ply.clamp(0, D - 1)

        # ================= ADVANCE =================
        pt_cross, pt_circle = L.classify(st.board, rules, bitwise.THREAT_KINDS)
        own_pts = torch.where(stm_is_circle[:, None, None, None], pt_circle, pt_cross)
        opp_pts = torch.where(stm_is_circle[:, None, None, None], pt_cross, pt_circle)
        empty = st.board == NONE
        mine = L.actor_planes(own_pts, empty, own_cross, renju)
        theirs = L.actor_planes(opp_pts, empty, their_cross, renju)

        own5, opp5 = mine["five"], theirs["five"]
        win_now = own5.any(2).any(1) & adv
        n_opp5 = opp5.sum((1, 2))
        static_fail = (n_opp5 >= 2) & adv & ~win_now

        # --- transposition probe ---
        h1, h2 = L.hash_boards(st.board)
        slot = h1 & (S - 1)
        e_hash = st.tt_hash[b, slot]
        e_depth = st.tt_depth[b, slot]
        e_threes = st.tt_threes[b, slot]
        rem = D - st.ply
        tl = L.col_at(st.threes_left, st.ply)
        tt_fail = (adv & ~win_now & ~static_fail & (e_depth >= rem) & (e_threes >= tl)
                   & (e_hash == h2) & (e_depth >= 0))
        depth_fail = adv & ~win_now & ~static_fail & ~tt_fail & (st.ply >= D)

        # --- candidate selection (OR node) ---
        # renju: black's candidates leave out every possibly forbidden
        # cell (a superset of the forbidden ones, so sound)
        cand = mine["four"] | mine["win3"]
        blocks = mine["four"] & opp5
        if renju:
            cand, blocks = cand & ~mine["maybe_forb"], blocks & ~mine["maybe_forb"]
        cand = cand | (mine["three"] & (tl > 0)[:, None, None])
        cand = torch.where((n_opp5 > 0)[:, None, None], blocks, cand)
        cand_flat = cand.reshape(bsz, hw) & ~L.plane_at(st.att_tried, ply_idx)
        can_advance = adv & ~win_now & ~static_fail & ~tt_fail & ~depth_fail
        cand_flat = cand_flat & can_advance[:, None]
        # priority: open-four/fork makers, then fours, then threes (fork
        # threes first) — reference: staged generation order,
        # ThreatGenerator.hpp:78-88
        prio = torch.where(mine["win3"].reshape(bsz, hw), 64,
                           torch.where(mine["four"].reshape(bsz, hw), 32, 8))
        prio = torch.where(cand_flat, prio + mine["n3"].reshape(bsz, hw), 0)
        has_cand = cand_flat.any(-1)
        exhausted = can_advance & ~has_cand

        move = torch.argmax(prio, -1)  # first maximum, as jnp.argmax
        do_try = can_advance & has_cand
        mr, mc = move // w, move % w
        board2 = L.place(st.board, do_try, move, stm)

        # attacker five threats: all new fives flow through the new stone
        threats = L.five_plane_of(board2, rules, stm_is_circle).reshape(bsz, hw)
        threats = threats & do_try[:, None]
        n_thr = threats.sum(-1)
        win_dd = do_try & (n_thr >= 2)  # double four: unstoppable
        block = torch.argmax(threats.int(), -1)
        forced = do_try & (n_thr == 1)
        if renju:
            # a forced block CERTAINLY forbidden for a black defender (no
            # 3x3 recursion needed) wins; classified after the move, which
            # can only have removed black patterns
            blk = V.windows_at_one(board2, block // w, block % w)
            blk_pts, _ = bitwise.classify_by_table(blk, rules, bitwise.THREAT_KINDS)
            blk_n4 = ((blk_pts == T.PT_HALF_OPEN_4) | (blk_pts == T.PT_OPEN_4)
                      | (blk_pts == T.PT_DOUBLE_4)).sum(-1)
            block_forb = ((blk_pts == T.PT_OVERLINE).any(-1) | (blk_pts == T.PT_DOUBLE_4).any(-1)
                          | (blk_n4 >= 2)) & (def_sign == CROSS)
            win_blk = forced & block_forb
            forced = forced & ~block_forb

        # --- AND-node option set for open-three moves (n_thr == 0) ---
        is_three_move = do_try & (n_thr == 0)
        ext = _ext_windows_at_one(st.board, mr, mc)  # [B, 4] pre-move
        dmask = DEF.get_moves_batched(
            rules, ext, def_is_circle[:, None].expand(bsz, 4), T.PT_OPEN_3
        ).long()  # [B, 4] 13-bit masks
        dir_is3 = L.pts_at_cell(own_pts, move) == T.PT_OPEN_3  # [B, 4]
        opts = _table_cells(dmask * dir_is3, mr, mc, h, w)
        # counter-fours: pre-move defender four/five makers (superset of
        # the post-move set — an attacker stone only removes defender fours)
        opts = opts | (theirs["four"] | opp5).reshape(bsz, hw)
        opts = opts & (board2 == NONE).reshape(bsz, hw) & is_three_move[:, None]
        n_opts = opts.sum(-1)
        # a candidate that created neither a five threat nor an open three
        # is non-forcing: abandon it rather than ever counting it as a win
        real3 = dir_is3.any(-1)
        win_nodef = is_three_move & real3 & (n_opts == 0)
        too_wide = is_three_move & ((n_opts > max_defenses) | ~real3) & ~win_nodef
        do_and = is_three_move & real3 & ~win_nodef & ~too_wide

        first_opt = torch.argmax(opts.int(), -1)
        reply = torch.where(forced, block, first_opt)
        descend = forced | do_and
        board3 = L.place(board2, descend, reply, def_sign)
        # abandoned candidates (too_wide) keep the pre-move board
        board3 = torch.where(too_wide[:, None, None], st.board, board3)

        won_adv = win_now | win_dd | win_nodef
        if renju:
            won_adv = won_adv | win_blk
        fail_adv = static_fail | tt_fail | depth_fail | exhausted

        # --- TT insert on frame failure (tt hits need no re-store) ---
        ins = fail_adv & ~tt_fail
        st.tt_hash[b, slot] = torch.where(ins, h2, e_hash)
        st.tt_depth[b, slot] = torch.where(ins, torch.where(static_fail, _TT_BIG_DEPTH, rem),
                                           e_depth)
        st.tt_threes[b, slot] = torch.where(ins, torch.where(static_fail, _TT_BIG_DEPTH, tl),
                                            e_threes)

        # --- ADVANCE state writes ---
        tried = st.att_tried[b, ply_idx]
        tried[b, move] |= do_try
        st.att_tried[b, ply_idx] = tried
        L.set_col(st.att_move, ply_idx, do_try, move)
        L.set_col(st.def_move, ply_idx, descend, reply)
        block_plane = torch.zeros((bsz, hw), dtype=torch.bool, device=dev)
        block_plane[b, block] = True
        L.set_plane(st.def_opts, ply_idx, descend,
                    torch.where(forced[:, None], block_plane, opts))
        L.set_plane(st.def_tried, ply_idx, descend, torch.zeros_like(opts))
        L.set_col(st.threes_left, (st.ply + 1).clamp(0, D), descend,
                  tl - is_three_move.long())

        won = won_adv & adv
        new_ply = torch.where(descend, st.ply + 1, st.ply)
        new_phase = torch.where(won, _RETW, torch.where(fail_adv & adv, _RETF, st.phase))
        # wins close with the board at frame-entry state
        new_board = torch.where(won[:, None, None], st.board, board3)
        win_extra = torch.where(won, torch.where(win_now, 1, 3), st.win_extra)
        win_ply = torch.where(won, st.ply, st.win_ply)
        # remember the closing candidate for best-move reporting
        closing = win_dd | win_nodef
        L.set_col(st.att_move, ply_idx, closing | win_blk if renju else closing, move)

        # ================= RET_WIN =================
        at_root = st.ply == 0
        retw_done = retw & at_root
        retw_pop = retw & ~at_root
        q = (st.ply - 1).clamp(0, D - 1)
        dmq = L.col_at(st.def_move, q)
        amq = L.col_at(st.att_move, q)
        new_board = L.unplace(new_board, retw_pop, dmq)
        refuted = L.plane_at(st.def_tried, q)
        refuted[b, dmq.clamp(0, hw - 1)] |= retw_pop & (dmq >= 0)
        L.set_plane(st.def_tried, q, retw_pop, refuted)
        remaining = L.plane_at(st.def_opts, q) & ~L.plane_at(st.def_tried, q)
        any_left = remaining.any(-1)
        more = retw_pop & any_left
        closed = retw_pop & ~any_left
        o2 = torch.argmax(remaining.int(), -1)
        new_board = L.place(new_board, more, o2, def_sign)
        L.set_col(st.def_move, q, more, o2)
        new_phase = torch.where(more, _ADV, new_phase)
        new_board = L.unplace(new_board, closed, amq)
        new_ply = torch.where(closed, q, new_ply)
        status = torch.where(retw_done, _WIN, torch.where(retf & at_root, _FAIL, st.status))

        # ================= RET_FAIL =================
        retf_pop = retf & ~at_root
        new_board = L.unplace(new_board, retf_pop, dmq)
        new_board = L.unplace(new_board, retf_pop, amq)
        new_ply = torch.where(retf_pop, q, new_ply)
        new_phase = torch.where(retf_pop, _ADV, new_phase)
        # candidate amq failed: clear parent's defender state (amq stays tried)
        none = torch.zeros_like(opts)
        L.set_plane(st.def_opts, q, retf_pop, none)
        L.set_plane(st.def_tried, q, retf_pop, none)
        L.set_col(st.def_move, q, retf_pop, -1)

        # reset the abandoned frame rows (invariant: frames >= ply are clean)
        leave = retw_pop | retf_pop
        L.set_plane(st.att_tried, ply_idx, leave, none)
        L.set_plane(st.def_opts, ply_idx, leave, none)
        L.set_plane(st.def_tried, ply_idx, leave, none)
        L.set_col(st.att_move, ply_idx, leave, -1)

        return st._replace(
            board=new_board, ply=new_ply, phase=new_phase.to(torch.int8),
            status=status.to(torch.int8), win_extra=win_extra, win_ply=win_ply,
        )

    return step


def solve(
    tables: V.RuleTables,
    board,
    stm,
    max_depth: int = 8,
    max_steps: int = 384,
    max_defenses: int = 12,
    max_threes: int = 3,
    tt_slots: int = 128,
) -> VCTBatchedResult:
    """Run the batched VCT for the side to move: `board` [B, H, W] int8 and
    `stm` [B] tensors on one device.

    max_depth: attacker plies; max_steps: lockstep transition budget shared
    by descends and backtracks; max_defenses: AND-node width cap (wider
    nodes abandon the line); max_threes: open-three moves per line
    (reference: TSS positional budgets, ThreatSpaceSearch.hpp:61-66)."""
    rules = GameRules(tables.rules)
    board = board.to(torch.int8)
    bsz, h, w = board.shape
    hw = h * w
    st = _init_state(board, max_depth, max_threes, tt_slots)
    step = _make_transition(rules, stm, max_depth, max_defenses, tt_slots)
    for i in range(max_steps):
        if i % _CHECK_EVERY == 0 and not bool((st.status == _SEARCHING).any()):
            break
        st = step(st)

    win = st.status == _WIN
    # immediate-five wins report the five cell; otherwise the root candidate
    own5_0 = L.five_plane_of(board, rules, stm == CIRCLE).reshape(bsz, hw)
    imm = torch.argmax(own5_0.int(), -1)
    first = torch.where(own5_0.any(-1), imm, st.att_move[:, 0])
    first = torch.where(win, first, -1)
    distance = torch.where(win, 2 * st.win_ply + st.win_extra, 0)
    return VCTBatchedResult(win=win, best_move=first.to(torch.int32),
                            distance=distance.to(torch.int32))


# ---------------------------------------------------------------------------
# The loss prover
# ---------------------------------------------------------------------------


class LossResult(NamedTuple):
    loss: torch.Tensor  # [B] bool: the side to move is PROVEN lost
    distance: torch.Tensor  # [B] int32 plies to mate (0 when unproven)


class LossPrepared(NamedTuple):
    child_board: torch.Tensor  # [B*M, H, W] defender-option children
    child_stm: torch.Tensor  # [B*M] attacker to move
    valid: torch.Tensor  # [B, M] real option lanes
    provable: torch.Tensor  # [B] option set is complete and fits M
    five_case: torch.Tensor  # [B]
    n_opts: torch.Tensor  # [B]
    base: torch.Tensor  # [B] raw mate length of the triggering execution
    # (1 five / 3 win-in-3 / 5 fork-4x3)


def prepare_loss(
    tables: V.RuleTables, board: torch.Tensor, stm: torch.Tensor, max_options: int = 8,
) -> LossPrepared:
    """The option children of the loss proof for the side to move
    (reference: the LOSS leg of the per-leaf alpha-beta, a fail-low over a
    complete defensive move list, src/search/alpha_beta/
    AlphaBetaSearch.cpp:91-135 with MoveGenerator's MUST_DEFEND stages):
    the complete defensive option set (<= `max_options` cells) of one
    triggering threat, each played on its own copy of the board, to be
    refuted by the attacker's VCT.  The sets, as the reference package's:
    - an attacker five threat and no defender five: its completion cells;
    - no attacker five, a defender without four or five makers, and an
      attacker win-in-3 cell (open four, double four, 4x4 fork): the
      defensive-table cells of the first such cell, and the cell itself;
    - neither, a defender without four or five makers, and an attacker
      FORK_4x3 cell: the defensive-table cells of its open-three and
      half-open-four directions, the cell, and every cell within 4 steps
      of a half-open-four defense where the defender holds a pattern.
    Renju: a black attacker's threat cell must not be possibly forbidden;
    a black defender's certainly forbidden options are dropped."""
    rules = GameRules(tables.rules)
    renju = rules == GameRules.RENJU
    board = board.to(torch.int8)
    bsz, h, w = board.shape
    hw = h * w
    M = max_options
    dev = board.device
    star = _line_consts(dev)[3]
    stm_is_circle = stm == CIRCLE
    att_sign = torch.where(stm == CROSS, CIRCLE, CROSS).to(torch.int8)
    pt_cross, pt_circle = L.classify(board, rules, bitwise.THREAT_KINDS)
    att_pts = torch.where(stm_is_circle[:, None, None, None], pt_cross, pt_circle)
    def_pts = torch.where(stm_is_circle[:, None, None, None], pt_circle, pt_cross)
    empty = board == NONE
    att_cross = stm_is_circle[:, None, None]
    att = L.actor_planes(att_pts, empty, att_cross, renju)
    dfd = L.actor_planes(def_pts, empty, ~att_cross, renju)

    att5 = att["five"].reshape(bsz, hw)
    any_att5 = att5.any(-1)
    def5 = dfd["five"].reshape(bsz, hw)
    def_force = def5.any(-1) | dfd["four"].flatten(1).any(-1)
    win3 = (att["win3"] & ~att["maybe_forb"] if renju else att["win3"]).reshape(bsz, hw)
    five_case = any_att5 & ~def5.any(-1)
    cells = torch.arange(hw, device=dev)
    dic = stm_is_circle[:, None].expand(bsz, 4)  # the defender's sign per direction

    def threat_cells(cell_plane, codes):
        """The first cell of `cell_plane` [B, HW], its defensive-table
        cells for the attacker PatternTypes `codes` of its directions, and
        the per-code masks [B, 4]."""
        rc = torch.argmax(cell_plane.int(), -1)
        mr, mc = rc // w, rc % w
        ext = _ext_windows_at_one(board, mr, mc)  # [B, 4] pre-move windows
        pts_at = L.pts_at_cell(att_pts, rc)  # [B, 4]
        masks = {code: torch.where(pts_at == code,
                                   DEF.get_moves_batched(rules, ext, dic, code).long(), 0)
                 for code in codes}
        return rc, mr, mc, masks

    # win-in-3 threat: the defensive-table cells of the first win3 cell
    rc, mr, mc, masks = threat_cells(win3, (T.PT_OPEN_4, T.PT_DOUBLE_4, T.PT_HALF_OPEN_4))
    dmask = sum(masks.values())  # one code per direction: disjoint
    tbl_opts = _table_cells(dmask, mr, mc, h, w) | (cells == rc[:, None])
    # a table miss would shrink the option set: never prove from it
    four_case = ~any_att5 & ~def_force & win3.any(-1) & (dmask != 0).any(-1)

    # the deeper trigger (defend_loss_in_6, MoveGenerator.cpp:423-447): an
    # attacker FORK_4x3 cell against a four-less defender
    att_tt = V.threat_type(tables, att_pts, ~att_cross)
    fork43 = (att_tt == T.TT_FORK_4x3) & empty
    if renju:
        fork43 = fork43 & ~att["certain_forb"]
    fork43 = fork43.reshape(bsz, hw)
    rc3, mr3, mc3, masks3 = threat_cells(fork43, (T.PT_OPEN_3, T.PT_HALF_OPEN_4))
    dmask3 = masks3[T.PT_OPEN_3] + masks3[T.PT_HALF_OPEN_4]
    tbl3 = _table_cells(dmask3, mr3, mc3, h, w)
    ho4def = _table_cells(masks3[T.PT_HALF_OPEN_4], mr3, mc3, h, w)
    # initiative-regaining superset: within 4 steps along any direction of
    # a half-open-four defense, any cell where the defender holds a pattern
    near = torch.nn.functional.conv2d(ho4def.reshape(bsz, 1, h, w).float(), star, padding=4) > 0
    init_cells = (near[:, 0] & (def_pts > 0).any(-1) & empty).reshape(bsz, hw)
    opts3 = tbl3 | (cells == rc3[:, None]) | init_cells
    fork_case = (~any_att5 & ~def_force & ~four_case & fork43.any(-1)
                 & (dmask3 != 0).any(-1))

    opts = torch.where(five_case[:, None], att5,
                       torch.where(four_case[:, None], tbl_opts, fork_case[:, None] & opts3))
    opts = opts & empty.reshape(bsz, hw)
    if renju:
        # a black defender cannot play a certainly forbidden cell
        opts = opts & ~((~stm_is_circle)[:, None] & dfd["certain_forb"].reshape(bsz, hw))
    n_opts = opts.sum(-1)
    provable = (five_case | four_case | fork_case) & (n_opts <= M)
    base = torch.where(five_case, 1, torch.where(four_case, 3, 5)).to(torch.int32)

    # expand the batch by the option axis: the options in cell order, then
    # (invalid lanes) the lowest other cells
    opt_idx = V.first_k(opts, M)
    valid = opts.gather(1, opt_idx) & provable[:, None]
    child = board.reshape(bsz, 1, hw).repeat(1, M, 1)
    b = torch.arange(bsz, device=dev)[:, None]
    m = torch.arange(M, device=dev)[None, :]
    child[b, m, opt_idx] = torch.where(valid, stm[:, None].to(torch.int8), child[b, m, opt_idx])
    return LossPrepared(
        child_board=child.reshape(bsz * M, h, w),
        child_stm=att_sign[:, None].expand(bsz, M).reshape(-1),
        valid=valid, provable=provable, five_case=five_case, n_opts=n_opts, base=base,
    )


def finish_loss(prep: LossPrepared, cwin: torch.Tensor, cdist: torch.Tensor) -> LossResult:
    """The loss proof from the children's VCT verdicts ([B, M] win and
    distance): every real option refuted -> the side to move is lost."""
    loss = prep.provable & (cwin | ~prep.valid).all(-1)
    worst = torch.where(prep.valid & cwin, cdist, prep.base[:, None]).amax(-1)
    distance = torch.where(loss, 1 + torch.where(prep.n_opts > 0, worst, prep.base), 0)
    return LossResult(loss=loss, distance=distance.to(torch.int32))


def _attacker_move_plane(tables: V.RuleTables, board: torch.Tensor, stm: torch.Tensor
                         ) -> torch.Tensor:
    """[B, HW] weighted candidate plane for the side TO MOVE as the
    attacker of the loss recursion: fork-4x3 makers (8), win-in-3 makers
    (4), four makers (2), summed (the THREATS-mode initiative moves of the
    reference's recursive_solve).  One working move suffices, so the set
    need not be complete; a black attacker's possibly forbidden cells are
    dropped, so every candidate is legal."""
    rules = GameRules(tables.rules)
    renju = rules == GameRules.RENJU
    bsz, h, w = board.shape
    stm_is_circle = stm == CIRCLE
    pt_cross, pt_circle = L.classify(board, rules, bitwise.THREAT_KINDS)
    my_pts = torch.where(stm_is_circle[:, None, None, None], pt_circle, pt_cross)
    empty = board == NONE
    mine = L.actor_planes(my_pts, empty, (~stm_is_circle)[:, None, None], renju)
    my_tt = V.threat_type(tables, my_pts, stm_is_circle[:, None, None])
    fork43 = (my_tt == T.TT_FORK_4x3) & empty
    win3, four = mine["win3"], mine["four"]
    if renju:
        legal = ~mine["maybe_forb"]
        fork43, win3, four = fork43 & legal, win3 & legal, four & legal
    weight = (8 * fork43.int() + 4 * win3.int() + 2 * four.int()) * empty.int()
    return weight.reshape(bsz, h * w)


def solve_loss(
    tables: V.RuleTables,
    board: torch.Tensor,
    stm: torch.Tensor,
    max_options: int = 8,
    max_depth: int = 8,
    max_steps: int = 384,
    max_threes: int = 2,
    levels: int = 1,
    max_att_moves: int = 4,
) -> LossResult:
    """`prepare_loss`, the attacker VCT on the option children, and
    `finish_loss` (the search's leaf solver instead puts the children into
    its win solve's batch).

    `levels` > 1 adds the reference's fail-low recursion
    (AlphaBetaSearch::recursive_solve, AlphaBetaSearch.cpp:91-135): an
    option the direct VCT does not refute is attacked again by each of up
    to `max_att_moves` attacker initiative moves (`_attacker_move_plane`,
    the heaviest first) and refuted if one of them leaves the defender in
    a `solve_loss(levels - 1)` loss.  The batch grows by `max_options *
    max_att_moves` a level."""
    board = board.to(torch.int8)
    stm = stm.to(torch.int8)
    prep = prepare_loss(tables, board, stm, max_options)
    bsz, M = prep.valid.shape
    sres = solve(tables, prep.child_board, prep.child_stm, max_depth=max_depth,
                 max_steps=max_steps, max_threes=max_threes)
    cwin = sres.win.reshape(bsz, M)
    cdist = sres.distance.reshape(bsz, M)
    if levels > 1:
        A = max_att_moves
        cb, cs = prep.child_board, prep.child_stm  # [B*M, H, W], [B*M]
        h, w = cb.shape[1], cb.shape[2]
        wplane = _attacker_move_plane(tables, cb, cs)  # [B*M, HW]
        topv, topi = torch.sort(wplane, dim=-1, descending=True, stable=True)
        topv, topi = topv[:, :A], topi[:, :A]  # lax.top_k's order
        cand_valid = topv > 0  # [B*M, A]
        gboard = cb.reshape(bsz * M, 1, h * w).repeat(1, A, 1)
        r = torch.arange(bsz * M, device=cb.device)[:, None]
        a = torch.arange(A, device=cb.device)[None, :]
        gboard[r, a, topi] = torch.where(cand_valid, cs[:, None], gboard[r, a, topi])
        gstm = torch.where(cs == CROSS, CIRCLE, CROSS).to(torch.int8)[:, None].expand(-1, A)
        sub = solve_loss(tables, gboard.reshape(-1, h, w), gstm.reshape(-1),
                         max_options=max_options, max_depth=max_depth, max_steps=max_steps,
                         max_threes=max_threes, levels=levels - 1, max_att_moves=A)
        gloss = sub.loss.reshape(bsz, M, A) & cand_valid.reshape(bsz, M, A)
        gdist = sub.distance.reshape(bsz, M, A)
        # the attacker takes the shortest winning continuation, plus its move
        d2 = torch.where(gloss, gdist, 1 << 20).amin(-1) + 1
        win2 = gloss.any(-1)
        cdist = torch.where(~cwin & win2, d2, cdist).to(torch.int32)
        cwin = cwin | win2
    return finish_loss(prep, cwin, cdist)
