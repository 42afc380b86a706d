"""Root move-restriction masks: the opening edge-generator family.

Port of the reference package's `search/generators.py`, the counterpart
of the reference's specialised edge generators (reference:
src/search/monte_carlo/EdgeGenerator.cpp: CenterExcludingGenerator,
CenterOnlyGenerator, SymmetricalExcludingGenerator, used by the swap and
swap2 opening controllers, player/EngineController.hpp:44-60).  They are
plain [B, H, W] bool masks ANDed into the roots' move restriction
(`mcts.run_search(root_move_mask=)`), which composes with the solver's
must-defend restriction.
"""

from __future__ import annotations

import torch

from ..utils import augment


def center_excluding_mask(batch: int, rows: int, cols: int, radius: int,
                          device="cpu") -> torch.Tensor:
    """Exclude a Chebyshev-`radius` square around the centre (swap2 second
    stones must leave the centre, reference: CenterExcludingGenerator)."""
    r0, c0 = rows // 2, cols // 2
    rr = (torch.arange(rows, device=device)[:, None] - r0).abs()
    cc = (torch.arange(cols, device=device)[None, :] - c0).abs()
    return (torch.maximum(rr, cc) > radius).expand(batch, rows, cols)


def center_only_mask(batch: int, rows: int, cols: int, radius: int,
                     device="cpu") -> torch.Tensor:
    """Restrict to the centre square (reference: CenterOnlyGenerator)."""
    return ~center_excluding_mask(batch, rows, cols, radius, device)


def symmetrical_excluding_mask(board: torch.Tensor) -> torch.Tensor:
    """One representative per symmetry orbit of the position: for each
    board symmetry that leaves the position invariant, a cell stays
    allowed only if its flat index is the least in its orbit (reference:
    SymmetricalExcludingGenerator, used on (near-)empty openings)."""
    board = torch.as_tensor(board)
    bsz, h, w = board.shape
    dev = board.device
    rr = torch.arange(h, device=dev)[:, None].expand(h, w)
    cc = torch.arange(w, device=dev)[None, :].expand(h, w)
    min_orbit = torch.full((bsz, h, w), h * w, dtype=torch.int64, device=dev)
    for s in range(augment.num_symmetries(h, w)):
        invariant = (augment.apply_symmetry(board, s) == board).flatten(1).all(-1)  # [B]
        tr, tc = augment.symmetry_location(rr, cc, h, w, s)
        flat = tr * w + tc
        min_orbit = torch.minimum(min_orbit, torch.where(invariant[:, None, None], flat, h * w))
    return (rr * w + cc)[None] <= min_orbit
