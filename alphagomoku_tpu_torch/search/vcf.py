"""Batched VCF solver: victory-by-continuous-fours proof search, lockstep
over a batch of boards.

Port of the reference package's `search/vcf.py`, itself a re-expression
of the forcing-line core of the reference's alpha-beta solver (reference:
src/search/alpha_beta/{AlphaBetaSearch,VCFSolver,MoveGenerator}.cpp): the
recursive DFS over four-making moves is a fixed-stack machine advanced by
one (attacker move, forced defender reply) pair per transition, every
board in lockstep.  Soundness, as the reference package's (every claimed
WIN is a true forced win):
- attacker candidates are four-making moves; when the defender already
  threatens a five, only those that also block it (two or more defender
  five threats end the line);
- the defender's reply is forced: the completion cell of the attacker's
  four (a defender five after the block ends the line; two completion
  cells are a double four, a win);
- renju: black's candidates leave out every possibly forbidden cell (a
  superset of the forbidden ones, so sound); a block that is forbidden for
  a black defender (`vectorized.is_forbidden`) counts as a win; a black
  five trumps a forbidden cell.
The search never claims LOSS/DRAW.

As in `search/vct_batched.py`, a finished board is a fixed point of the
transition (every write is gated by the board still searching), so
`solve` checks for a searching board only every `_CHECK_EVERY`
transitions, one host sync per check, and reads and writes the state with
gathers and in-place index writes where the reference package uses
one-hot selects.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..game.types import CROSS, CIRCLE, NONE, GameRules
from ..game import vectorized as V
from ..patterns import bitwise
from . import lockstep as L

_SEARCHING, _WIN, _FAIL = 0, 1, 2
_CHECK_EVERY = 4  # transitions between host checks for a searching board


class VCFResult(NamedTuple):
    win: torch.Tensor  # [B] bool: VCF win proven for the side to move
    best_move: torch.Tensor  # [B] int32 flat first move of the winning line (-1)
    distance: torch.Tensor  # [B] int32 plies to mate (0 when unproven)


class _State(NamedTuple):
    board: torch.Tensor  # [B, H, W] int8 (mutated along the line)
    ply: torch.Tensor  # [B] int64 current attacker depth (0-based)
    att_moves: torch.Tensor  # [B, D] int64 flat attacker moves (-1 empty)
    def_moves: torch.Tensor  # [B, D] int64 flat defender replies (-1 empty)
    tried: torch.Tensor  # [B, D, HW] bool: attacker moves already explored
    status: torch.Tensor  # [B] int8: searching, win or fail
    win_extra: torch.Tensor  # [B] int64 plies beyond 2*ply at the win (1 or 3)


def _init_state(board: torch.Tensor, max_depth: int) -> _State:
    bsz, h, w = board.shape
    dev = board.device
    return _State(
        board=board.clone(),
        ply=torch.zeros(bsz, dtype=torch.int64, device=dev),
        att_moves=torch.full((bsz, max_depth), -1, dtype=torch.int64, device=dev),
        def_moves=torch.full((bsz, max_depth), -1, dtype=torch.int64, device=dev),
        tried=torch.zeros((bsz, max_depth, h * w), dtype=torch.bool, device=dev),
        status=torch.full((bsz,), _SEARCHING, dtype=torch.int8, device=dev),
        win_extra=torch.zeros(bsz, dtype=torch.int64, device=dev),
    )


def _make_transition(tables: V.RuleTables, stm: torch.Tensor, max_depth: int):
    """One lockstep transition `st -> st` for the side to move `stm` [B];
    it updates the frame tensors of `st` in place."""
    rules = GameRules(tables.rules)
    renju = rules == GameRules.RENJU
    D = max_depth
    stm = stm.to(torch.int8)
    stm_is_circle = stm == CIRCLE
    own_cross, their_cross = (~stm_is_circle)[:, None, None], stm_is_circle[:, None, None]
    def_sign = torch.where(stm == CROSS, CIRCLE, CROSS).to(torch.int8)
    b = torch.arange(stm.shape[0], device=stm.device)

    def step(st: _State) -> _State:
        bsz, h, w = st.board.shape
        hw = h * w
        searching = st.status == _SEARCHING
        empty = st.board == NONE
        pt_cross, pt_circle = L.classify(st.board, rules, bitwise.THREAT_KINDS)
        own_pts = torch.where(stm_is_circle[:, None, None, None], pt_circle, pt_cross)
        opp_pts = torch.where(stm_is_circle[:, None, None, None], pt_cross, pt_circle)
        mine = L.actor_planes(own_pts, empty, own_cross, renju)
        opp5 = L.actor_planes(opp_pts, empty, their_cross, renju)["five"]
        makes_four = mine["four"] & ~mine["maybe_forb"] if renju else mine["four"]

        # immediate win: a five-completing move exists right now
        win_now = mine["five"].flatten(1).any(-1) & searching
        n_opp5 = opp5.sum((1, 2))
        cand = makes_four & torch.where((n_opp5 > 0)[:, None, None], opp5, True)
        cand = cand & (n_opp5 < 2)[:, None, None]
        ply_idx = st.ply.clamp(0, D - 1)
        cand_flat = cand.reshape(bsz, hw) & ~L.plane_at(st.tried, ply_idx)
        cand_flat = cand_flat & (searching & ~win_now)[:, None]
        has_cand = cand_flat.any(-1) & (st.ply < D)

        # descend: try the first untried candidate
        move = torch.argmax(cand_flat.int(), -1)
        do_desc = has_cand & searching & ~win_now
        board2 = L.place(st.board, do_desc, move, stm)
        # the attacker's five threats after the move (all new fives go
        # through the new stone; earlier ones would have fired win_now)
        threats = L.five_plane_of(board2, rules, stm_is_circle).reshape(bsz, hw)
        threats = threats & do_desc[:, None]
        n_thr = threats.sum(-1)
        double_four_win = do_desc & (n_thr >= 2)
        block = torch.argmax(threats.int(), -1)
        do_block = do_desc & (n_thr == 1)
        won = win_now | double_four_win
        if renju:
            # a black defender cannot take a forbidden block
            forb = V.is_forbidden(tables, board2, block // w, block % w)
            block_wins = do_block & forb & (def_sign == CROSS)
            do_block = do_block & ~block_wins
            won = won | block_wins
        board3 = L.place(board2, do_block, block, def_sign)
        # a defender five after the block (its four completed) ends the line
        def_five = L.five_plane_of(board3, rules, ~stm_is_circle).reshape(bsz, hw)
        line_fails = do_block & def_five.any(-1)

        # backtrack: no candidate at this ply (the frame below is read
        # before this transition's writes)
        do_back = searching & ~win_now & ~do_desc
        at_root = st.ply == 0
        pop = do_back & ~at_root
        prev = (st.ply - 1).clamp(0, D - 1)
        pa = L.col_at(st.att_moves, prev)
        pd = L.col_at(st.def_moves, prev)

        st.tried[b, ply_idx, move] |= do_desc
        advanced = do_block & ~line_fails
        L.set_col(st.att_moves, ply_idx, advanced | (won & do_desc), move)
        L.set_col(st.def_moves, ply_idx, advanced, block)
        # failed lines: undo the attacker (and defender) stones
        board4 = L.unplace(board3, line_fails, move)
        board4 = L.unplace(board4, line_fails, block)
        board5 = L.unplace(board4, pop & (pa >= 0), pa.clamp(0, hw - 1))
        board5 = L.unplace(board5, pop & (pd >= 0), pd.clamp(0, hw - 1))
        # clear the tried set of the ply being abandoned
        L.set_plane(st.tried, ply_idx, pop, torch.zeros_like(cand_flat))

        new_ply = torch.where(advanced, st.ply + 1, torch.where(pop, st.ply - 1, st.ply))
        status = torch.where(won & searching, _WIN,
                             torch.where(do_back & at_root, _FAIL, st.status))
        # mate distance: an available five mates in 1 more ply; a double
        # four or an unblockable four needs 3 (four, any reply, five)
        win_extra = torch.where(won & searching, torch.where(win_now, 1, 3), st.win_extra)
        return st._replace(board=board5, ply=new_ply, status=status.to(torch.int8),
                           win_extra=win_extra)

    return step


def solve(
    tables: V.RuleTables, board, stm, max_depth: int = 10, max_steps: int = 256,
) -> VCFResult:
    """Run the batched VCF for the side to move: `board` [B, H, W] int8 and
    `stm` [B] tensors on one device.  max_depth: attacker plies;
    max_steps: lockstep transition budget shared by descends and
    backtracks (reference: solver node/depth limits,
    AlphaBetaSearch.hpp:34-39)."""
    rules = GameRules(tables.rules)
    board = board.to(torch.int8)
    bsz, h, w = board.shape
    st = _init_state(board, max_depth)
    step = _make_transition(tables, stm, max_depth)
    for i in range(max_steps):
        if i % _CHECK_EVERY == 0 and not bool((st.status == _SEARCHING).any()):
            break
        st = step(st)

    win = st.status == _WIN
    # the first attacker move of the winning line; an immediate five (a
    # win before any line move) reports its five cell
    own5 = L.five_plane_of(board, rules, stm == CIRCLE).reshape(bsz, h * w)
    imm = torch.argmax(own5.int(), -1)
    first = torch.where(st.att_moves[:, 0] >= 0, st.att_moves[:, 0], imm)
    first = torch.where(win, torch.where(own5.any(-1), imm, first), -1)
    distance = torch.where(win, 2 * st.ply + st.win_extra, 0)
    return VCFResult(win=win, best_move=first.to(torch.int32), distance=distance.to(torch.int32))
