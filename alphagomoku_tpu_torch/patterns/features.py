"""NN input features: 32 bit-planes per cell, packed in one word.

Port of the reference package's `patterns/features.py`.  The bit layout is the reference's (src/networks/NNInputFeatures.cpp:66-111):

    bit 0     legal move (cell empty)
    bit 1     own stone            bit 2   opponent stone
    bit 3     ones                 bit 7   zeros
    bit 4     cross to move        bit 5   circle to move
    bit 6     forbidden move (renju, cross to move only)
    bits  8-11  own open three, one bit per direction (H, V, D, AD)
    bits 12-15  own half-open four, one bit per direction
    bit 16    own open four        bit 17  own double four
    bit 18    own five             bit 19  own overline
    bits 20-31  same group for the opponent

Bits up to 31 are in use, so the packed map is carried in int64.
"""

from __future__ import annotations

import torch

from ..game.types import NONE, CROSS, CIRCLE, GameRules
from ..game import vectorized as V
from ..utils import augment
from . import bitwise
from . import tables as T


def _player_group(pts: torch.Tensor) -> torch.Tensor:
    """12-bit per-player group from directional PatternTypes [..., 4]:
    [0-3] open three per dir, [4-7] half-open four per dir, [8] open 4,
    [9] double 4, [10] five, [11] overline (any direction)."""
    g = torch.zeros(pts.shape[:-1], dtype=torch.int64, device=pts.device)
    for d in range(4):
        p = pts[..., d]
        g = g | ((p == T.PT_OPEN_3).long() << d)
        g = g | ((p == T.PT_HALF_OPEN_4).long() << (4 + d))
    g = g | ((pts == T.PT_OPEN_4).any(-1).long() << 8)
    g = g | ((pts == T.PT_DOUBLE_4).any(-1).long() << 9)
    g = g | ((pts == T.PT_FIVE).any(-1).long() << 10)
    g = g | ((pts == T.PT_OVERLINE).any(-1).long() << 11)
    return g


def encode(
    tables: V.RuleTables, board: torch.Tensor, sign_to_move: torch.Tensor,
    forbidden_depth: int = 2,
) -> torch.Tensor:
    """Packed int64 feature map [B, H, W] from int8 boards [B, H, W] and
    side-to-move [B]; under renju, bit 6 marks the cells forbidden for
    cross (`vectorized.forbidden_plane` at `forbidden_depth`) on boards
    where cross is to move."""
    own_is_cross = (sign_to_move == CROSS)[:, None, None]  # [B, 1, 1]

    wins = V.windows_all(board).permute(0, 2, 3, 1)  # [B, H, W, 4]
    pt_cross, pt_circle = bitwise.classify(wins, GameRules(tables.rules))
    cross_group = _player_group(pt_cross)
    circle_group = _player_group(pt_circle)
    own_group = torch.where(own_is_cross, cross_group, circle_group)
    opp_group = torch.where(own_is_cross, circle_group, cross_group)

    out = (own_group << 8) | (opp_group << 20)
    out = out | (1 << 3)  # ones plane
    out = out | torch.where(own_is_cross, 1 << 4, 1 << 5)

    empty = board == NONE
    own_stone = torch.where(own_is_cross, board == CROSS, board == CIRCLE)
    opp_stone = torch.where(own_is_cross, board == CIRCLE, board == CROSS)
    out = out | empty.long()
    out = out | (own_stone.long() << 1)
    out = out | (opp_stone.long() << 2)
    if tables.rules == GameRules.RENJU:
        forb, _ = V.forbidden_plane_u(tables, board, forbidden_depth, pts_cross=pt_cross)
        out = out | ((forb & own_is_cross).long() << 6)
    return out


def unpack_planes(packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[B, H, W] packed map -> [B, H, W, 32] planes for NN input (NHWC)."""
    bits = torch.arange(32, device=packed.device)
    return ((packed[..., None] >> bits) & 1).to(dtype)


def unpack_raw_planes(packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The 8 'raw' planes (bits 0-7) used by *raw network variants
    (reference: networks.cpp raw input = H*W*8)."""
    bits = torch.arange(8, device=packed.device)
    return ((packed[..., None] >> bits) & 1).to(dtype)


def _shuffle_directions(packed: torch.Tensor, perm) -> torch.Tensor:
    """Permute direction bits in groups 8-11, 12-15, 20-23, 24-27:
    new direction i takes old direction perm[i]
    (reference: NNInputFeatures.cpp:33-51 shuffle_directions)."""
    base = (1 << 8) | (1 << 12) | (1 << 20) | (1 << 24)
    out = packed & 0xF00F00FF
    for i in range(4):
        out = out | (((packed >> perm[i]) & base) << i)
    return out


def augment_features(packed: torch.Tensor, mode: int) -> torch.Tensor:
    """Apply a symmetry (a Python int): spatial transform + direction-bit
    shuffle (reference: NNInputFeatures::augment, NNInputFeatures.cpp:111-155)."""
    out = augment.apply_symmetry(packed, mode)
    perm = augment.DIRECTION_PERM[mode]
    if perm != (0, 1, 2, 3):
        out = _shuffle_directions(out, perm)
    return out


def augment_features_batch(packed: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """Per-sample symmetry over a batch [B, H, W], modes int [B]."""
    out = packed
    sel = modes[:, None, None]
    for m in range(1, augment.num_symmetries(*packed.shape[-2:])):
        out = torch.where(sel == m, augment_features(packed, m), out)
    return out
