"""The 8 board symmetries, on single tensors and per sample over a batch.

Port of the reference package's `utils/augment.py`.  The enumeration is
the reference's (reference: include/alphagomoku/utils/augmentations.hpp:19-29):

    0 IDENTITY            4 FLIP_DIAGONALLY     (transpose)
    1 FLIP_VERTICALLY     5 FLIP_ANTIDIAGONALLY
    2 FLIP_HORIZONTALLY   6 ROTATE_90           (dst[r,c] = src[c, N-1-r])
    3 ROTATE_180          7 ROTATE_270

All transforms act on the LAST TWO axes, so they apply unchanged to
`[B, H, W]` boards, `[B, H, W]` packed feature maps and `[B, C, H, W]`
plane stacks.  Non-square boards only admit symmetries 0-3
(reference: augmentations.hpp:62-65).  The `_dyn` and `_batch` variants
take the mode as a tensor: one mode for the whole tensor, or one per
sample.
"""

from __future__ import annotations

import torch

IDENTITY = 0
FLIP_VERTICALLY = 1
FLIP_HORIZONTALLY = 2
ROTATE_180 = 3
FLIP_DIAGONALLY = 4
FLIP_ANTIDIAGONALLY = 5
ROTATE_90 = 6
ROTATE_270 = 7

# self-inverse except the quarter rotations (reference: augmentations.hpp:31-53)
INVERSE = (0, 1, 2, 3, 4, 5, 7, 6)

# How each symmetry permutes the 4 line directions (H, V, D, AD):
# new direction i corresponds to old direction DIRECTION_PERM[s][i]
# (reference: src/networks/NNInputFeatures.cpp:115-155 shuffle_directions
# template arguments per mode).
DIRECTION_PERM = (
    (0, 1, 2, 3),  # identity
    (0, 1, 3, 2),  # flip vertically: diagonals swap
    (0, 1, 3, 2),  # flip horizontally: diagonals swap
    (0, 1, 2, 3),  # rotate 180: nothing changes
    (1, 0, 2, 3),  # flip diagonally: H/V swap
    (1, 0, 2, 3),  # flip antidiagonally: H/V swap
    (1, 0, 3, 2),  # rotate 90: both swap
    (1, 0, 3, 2),  # rotate 270: both swap
)


def num_symmetries(rows: int, cols: int) -> int:
    return 8 if rows == cols else 4


def _tx(x: torch.Tensor) -> torch.Tensor:
    """Transpose the last two axes."""
    return x.transpose(-1, -2)


def apply_symmetry(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Apply symmetry `mode` (a Python int) to the last two axes of `x`."""
    if mode == IDENTITY:
        return x
    if mode == FLIP_VERTICALLY:
        return x.flip(-2)
    if mode == FLIP_HORIZONTALLY:
        return x.flip(-1)
    if mode == ROTATE_180:
        return x.flip(-2, -1)
    if mode == FLIP_DIAGONALLY:
        return _tx(x)
    if mode == FLIP_ANTIDIAGONALLY:
        # dst[r, c] = src[N-1-c, N-1-r]
        return _tx(x).flip(-2, -1)
    if mode == ROTATE_90:
        # dst[r, c] = src[c, N-1-r]
        return _tx(x.flip(-1))
    if mode == ROTATE_270:
        # dst[r, c] = src[N-1-c, r]
        return _tx(x.flip(-2))
    raise ValueError(f"bad symmetry mode {mode}")


def inverse_symmetry(x: torch.Tensor, mode: int) -> torch.Tensor:
    return apply_symmetry(x, INVERSE[mode])


def apply_symmetry_dyn(x: torch.Tensor, mode) -> torch.Tensor:
    """Apply a symmetry given as a 0-d tensor (or an int) to all of `x`."""
    return apply_symmetry(x, int(mode))


def inverse_symmetry_dyn(x: torch.Tensor, mode) -> torch.Tensor:
    return apply_symmetry(x, INVERSE[int(mode)])


def apply_symmetry_batch(x: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """Per-sample symmetry over a batch: x [B, ..., H, W], modes int [B].
    Every mode's transform is taken of the whole batch and each sample
    keeps its own; a non-square board admits modes 0-3 only."""
    out = x
    sel = modes.reshape((-1,) + (1,) * (x.dim() - 1))
    for m in range(1, num_symmetries(x.shape[-2], x.shape[-1])):
        out = torch.where(sel == m, apply_symmetry(x, m), out)
    return out


def inverse_symmetry_batch(x: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    inv = torch.tensor(INVERSE, dtype=torch.long, device=modes.device)[modes.long()]
    return apply_symmetry_batch(x, inv)


def symmetry_location(rows, cols, h: int, w: int, mode) -> tuple:
    """Transform (row, col) locations the same way apply_symmetry moves cells:
    if y = apply_symmetry(x, mode) then y[f(r, c)] == x[r, c].  `mode` is an
    int, or a tensor of modes broadcast against the locations."""
    tables = {
        IDENTITY: lambda r, c: (r, c),
        FLIP_VERTICALLY: lambda r, c: (h - 1 - r, c),
        FLIP_HORIZONTALLY: lambda r, c: (r, w - 1 - c),
        ROTATE_180: lambda r, c: (h - 1 - r, w - 1 - c),
        FLIP_DIAGONALLY: lambda r, c: (c, r),
        FLIP_ANTIDIAGONALLY: lambda r, c: (w - 1 - c, h - 1 - r),
        ROTATE_90: lambda r, c: (w - 1 - c, r),
        ROTATE_270: lambda r, c: (c, h - 1 - r),
    }
    if isinstance(mode, int):
        return tables[mode](rows, cols)
    outs = [tables[m](rows, cols) for m in range(8)]
    rr = torch.stack([torch.as_tensor(o[0]) for o in outs], 0)
    cc = torch.stack([torch.as_tensor(o[1]) for o in outs], 0)
    idx = torch.as_tensor(mode).long()
    return rr[idx], cc[idx]
