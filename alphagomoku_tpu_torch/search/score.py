"""Packed 16-bit solver scores and (win, draw) values, on tensors.

Port of the reference package's `search/score.py`, a bit-exact
re-expression of the reference's `Score`
(include/alphagomoku/search/Score.hpp:47-331): a 16-bit word =
3-bit ProvenValue {LOSS=0, DRAW=1, UNKNOWN=2, WIN=3} << 13 | (4000 + eval),
eval in [-4000, 4000].  The packing is ordered, so minimax comparisons are
plain integer compares.  WIN stores eval = -plys (closer wins sort
higher), LOSS/DRAW store eval = +plys.

torch has no arithmetic on uint16, so a Score is carried zero-extended in
int32 (values 0..65535); `make` wraps results into 16 bits exactly as a
uint16 cast does.  The constructors accept Python ints (returning an int)
or integer tensors.
"""

from __future__ import annotations

import torch

from ..game.types import CROSS, CIRCLE, GameOutcome

# ProvenValue codes (reference: Score.hpp:26-32 enum order)
PV_LOSS = 0
PV_DRAW = 1
PV_UNKNOWN = 2
PV_WIN = 3

MINUS_INF = 0x0000
PLUS_INF = 0xFFFF


def make(pv, evaluation):
    """Score from ProvenValue + eval (reference: Score ctor)."""
    return ((pv << 13) | (4000 + evaluation)) & 0xFFFF


def zero():
    return make(PV_UNKNOWN, 0)


def eval_score(evaluation):
    return make(PV_UNKNOWN, evaluation)


def win_in(plys):
    return make(PV_WIN, -plys)


def loss_in(plys):
    return make(PV_LOSS, plys)


def draw_in(plys):
    return make(PV_DRAW, plys)


def get_eval(s):
    return (s & 8191) - 4000


def get_pv(s):
    return s >> 13


def is_infinite(s: torch.Tensor) -> torch.Tensor:
    return (s == MINUS_INF) | (s == PLUS_INF)


def is_finite(s: torch.Tensor) -> torch.Tensor:
    return ~is_infinite(s)


def is_proven(s: torch.Tensor) -> torch.Tensor:
    return (get_pv(s) != PV_UNKNOWN) & is_finite(s)


def is_win(s: torch.Tensor) -> torch.Tensor:
    return (get_pv(s) == PV_WIN) & is_finite(s)


def is_loss(s: torch.Tensor) -> torch.Tensor:
    return (get_pv(s) == PV_LOSS) & is_finite(s)


def is_draw(s: torch.Tensor) -> torch.Tensor:
    return get_pv(s) == PV_DRAW


def get_distance(s: torch.Tensor) -> torch.Tensor:
    """Plies to the proven result (reference: Score.hpp getDistance)."""
    pv = get_pv(s)
    ev = get_eval(s)
    return torch.where(pv == PV_WIN, -ev, torch.where(pv == PV_UNKNOWN, 0, ev))


def neg(s: torch.Tensor) -> torch.Tensor:
    """Unary minus (reference: Score.hpp operator-): swaps WIN/LOSS keeping
    |eval|; infinities swap."""
    pv = get_pv(s)
    ev = get_eval(s)
    new_pv = torch.where(pv == PV_WIN, PV_LOSS, torch.where(pv == PV_LOSS, PV_WIN, pv))
    new_ev = torch.where(pv == PV_DRAW, ev, -ev)
    out = make(new_pv, new_ev)
    inf = torch.where(s == MINUS_INF, PLUS_INF, MINUS_INF)
    return torch.where(is_infinite(s), inf, out).to(s.dtype)


def add_int(s: torch.Tensor, i) -> torch.Tensor:
    """score + int on the eval field; infinities unchanged
    (reference: Score.hpp operator+(Score, int))."""
    out = make(get_pv(s), get_eval(s) + i)
    return torch.where(is_infinite(s), s, out).to(s.dtype)


def increase_distance(s: torch.Tensor, i=1) -> torch.Tensor:
    """Push a proven result one ply further (reference: increaseDistance)."""
    pv = get_pv(s)
    delta = torch.where(
        (pv == PV_LOSS) | (pv == PV_DRAW), i, torch.where(pv == PV_WIN, -i, 0)
    )
    return add_int(s, delta)


def invert_up(s: torch.Tensor) -> torch.Tensor:
    """Invert to the parent's perspective, one ply up
    (reference: Score.hpp:285-301): LOSS in d -> WIN in d+1, WIN in d ->
    LOSS in d+1, DRAW in d -> DRAW in d+1, UNKNOWN(e) -> UNKNOWN(-e)."""
    return increase_distance(neg(s), 1)


def invert_down(s: torch.Tensor) -> torch.Tensor:
    """(reference: Score.hpp:303-317)"""
    return increase_distance(neg(s), -1)


def convert_to_value(s: torch.Tensor) -> torch.Tensor:
    """Score -> (win_rate, draw_rate) float32 pair stacked on the last axis
    (reference: Score.hpp:266-281 convertToValue)."""
    pv = get_pv(s)
    ev = get_eval(s)
    fin = is_finite(s)
    win = torch.where(
        pv == PV_WIN,
        fin.float(),
        torch.where(pv == PV_UNKNOWN, (1000.0 + ev.float()) / 2000.0, 0.0),
    )
    draw = (pv == PV_DRAW).float()
    return torch.stack([win, draw], dim=-1)


def from_outcome(outcome: torch.Tensor, sign_to_move: torch.Tensor, distance=0):
    """GameOutcome + side to move -> proven Score, int32
    (reference: src/search/Score.cpp:40-53 convertProvenValue)."""
    outcome = outcome.to(torch.int32)
    stm = sign_to_move.to(torch.int32)
    win = ((outcome == int(GameOutcome.CROSS_WIN)) & (stm == CROSS)) | (
        (outcome == int(GameOutcome.CIRCLE_WIN)) & (stm == CIRCLE)
    )
    loss = ((outcome == int(GameOutcome.CROSS_WIN)) & (stm == CIRCLE)) | (
        (outcome == int(GameOutcome.CIRCLE_WIN)) & (stm == CROSS)
    )
    draw = outcome == int(GameOutcome.DRAW)
    pv = torch.where(
        win, PV_WIN, torch.where(loss, PV_LOSS, torch.where(draw, PV_DRAW, PV_UNKNOWN))
    ).to(torch.int32)
    ev = torch.where(win, -distance, torch.where(loss | draw, distance, 0)).to(torch.int32)
    return make(pv, ev)


# ---------------------------------------------------------------------------
# Value = (win_rate, draw_rate) pairs on the last axis
# (reference: include/alphagomoku/search/Value.hpp)
# ---------------------------------------------------------------------------


def value_expectation(value: torch.Tensor) -> torch.Tensor:
    """w + 0.5*d (reference: Value.hpp:41-44 getExpectation)."""
    return value[..., 0] + 0.5 * value[..., 1]


def value_invert(value: torch.Tensor) -> torch.Tensor:
    """Opponent's view: win' = 1 - win - draw (reference: Value.hpp
    getInverted)."""
    return torch.stack([1.0 - value[..., 0] - value[..., 1], value[..., 1]], dim=-1)
