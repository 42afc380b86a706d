"""Pattern classification as tensor bit math, compiled from the rule DSL.

Port of the reference package's `patterns/bitwise.py`: the matching rules
of `tables._classifier_rules` (the reference's PatternClassifier,
src/patterns/PatternClassifier.cpp:182-327) evaluated on packed 22-bit
line windows (2 bits per cell, cell i at bits [2i, 2i+1]).

Windows are carried in int64 (the packed values are unsigned 32-bit; torch
has no shifts on uint32).  For each sign the eleven cells are stacked into
one `[11, ...]` tensor, each distinct rule mask becomes a bool "allowed"
tensor over it, and a rule of length L is the AND of L shifted slices of
those tensors, OR-reduced over the window offsets: about L tensor ops per
rule instead of one per (offset, position).
"""

from __future__ import annotations

import functools

import torch

from ..game.types import CROSS, CIRCLE, GameRules
from . import tables as T

_LEN = T.PATTERN_LENGTH  # 11
_ANY = 0b1111


@functools.lru_cache(maxsize=None)
def _compiled_rules(rules: GameRules, sign: int, kind: str):
    return tuple(tuple(m) for m in T._classifier_rules(kind, GameRules(rules), sign))


class _Cells:
    """The eleven 2-bit cells of every window with `sign` at the center,
    plus a per-mask cache of `allowed[mask][p] = sign at p is in mask`."""

    def __init__(self, windows: torch.Tensor, sign: int):
        win = windows.to(torch.int64) | (sign << (2 * T.CENTER))
        shifts = torch.arange(0, 2 * _LEN, 2, device=windows.device)
        shifts = shifts.reshape((_LEN,) + (1,) * windows.dim())
        self.cells = (win.unsqueeze(0) >> shifts) & 3  # [11, ...]
        self._allowed: dict[int, torch.Tensor] = {}

    def allowed(self, mask: int) -> torch.Tensor:
        if mask not in self._allowed:
            self._allowed[mask] = ((mask >> self.cells) & 1) == 1
        return self._allowed[mask]

    def match(self, masks: tuple[int, ...]) -> torch.Tensor:
        """Does the rule match anywhere inside the window?"""
        n_off = _LEN - len(masks) + 1
        term = None
        for j, mask in enumerate(masks):
            if mask == _ANY:
                continue  # [any] matches everything
            a = self.allowed(mask)[j : j + n_off]
            term = a if term is None else term & a
        if term is None:  # rule is all-[any]
            return torch.ones_like(self.cells[0], dtype=torch.bool)
        return term.any(0)

    def match_any(self, rule_list) -> torch.Tensor:
        hit = None
        for masks in rule_list:
            h = self.match(masks)
            hit = h if hit is None else hit | h
        return hit


def classify(windows: torch.Tensor, rules: GameRules) -> tuple[torch.Tensor, torch.Tensor]:
    """PatternTypes (cross, circle) for packed empty-center windows.

    windows: integer tensor [...] of 22-bit windows, center read as NONE.
    Returns two int32 tensors of PatternType codes."""
    rules = GameRules(rules)
    results = []
    for sign in (CROSS, CIRCLE):
        cells = _Cells(windows, sign)
        out = torch.zeros(windows.shape, dtype=torch.int32, device=windows.device)
        for kind, code in T._PRIORITY:
            hit = cells.match_any(_compiled_rules(rules, sign, kind))
            out = torch.where((out == 0) & hit, code, out)
        results.append(out)
    return results[0], results[1]


def five_mask(
    windows: torch.Tensor, rules: GameRules
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cross, circle) bool masks: placing that sign at the (empty) center
    completes a five.  Exactly PT_FIVE of `classify` (five is the highest
    classifier priority, so its rules alone decide it)."""
    rules = GameRules(rules)
    return tuple(
        _Cells(windows, sign).match_any(_compiled_rules(rules, sign, "five"))
        for sign in (CROSS, CIRCLE)
    )
