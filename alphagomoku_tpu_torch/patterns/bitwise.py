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

`pattern_table` runs that bit math once over all 4^10 window keys, so a
caller that classifies every cell many times (the VCT solver) takes one
lookup instead of a few hundred tensor ops, with the same results.
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


def classify(
    windows: torch.Tensor, rules: GameRules, kinds: tuple[str, ...] | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """PatternTypes (cross, circle) for packed empty-center windows.

    windows: integer tensor [...] of 22-bit windows, center read as NONE.
    Returns two int32 tensors of PatternType codes.

    kinds: optional subset of the `T._PRIORITY` kind names to evaluate;
    a cell that matches only skipped kinds classifies as 0.  Exact for the
    kinds kept as long as every higher-priority kind is kept too (the
    priority filter only compares against higher kinds).  The solvers pass
    THREAT_KINDS."""
    rules = GameRules(rules)
    want = None if kinds is None else set(kinds)
    results = []
    for sign in (CROSS, CIRCLE):
        cells = _Cells(windows, sign)
        out = torch.zeros(windows.shape, dtype=torch.int32, device=windows.device)
        for kind, code in T._PRIORITY:
            if want is not None and kind not in want:
                continue
            hit = cells.match_any(_compiled_rules(rules, sign, kind))
            out = torch.where((out == 0) & hit, code, out)
        results.append(out)
    return results[0], results[1]


@functools.lru_cache(maxsize=None)
def pattern_table(rules: GameRules, device: torch.device,
                  kinds: tuple[str, ...] | None = None) -> torch.Tensor:
    """int32 [4^10]: the PatternType nibbles (cross | circle << 4) of every
    center-free window key, computed once per rule, device and `kinds` by
    `classify` itself: the reference's pattern table, built in memory."""
    keys = torch.arange(T.NUM_PATTERNS, dtype=torch.int64, device=device)
    cross, circle = classify((keys & 1023) | ((keys & 1047552) << 2), rules, kinds)
    return (cross | (circle << 4)).to(torch.int32)


def classify_packed(windows: torch.Tensor, rules: GameRules) -> torch.Tensor:
    """The nibble-packed form of `classify`, as the pattern table encodes
    it: cross | circle << 4, in int64 (the reference package's uint32)."""
    cross, circle = classify(windows, rules)
    return (cross | (circle << 4)).to(torch.int64)


def classify_by_table(
    windows: torch.Tensor, rules: GameRules, kinds: tuple[str, ...] | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """`classify` as one lookup in `pattern_table`, with the same results."""
    keys = (windows & 1023) | ((windows & 4190208) >> 2)  # drop the center cell
    kinds = None if kinds is None else tuple(kinds)
    enc = pattern_table(GameRules(rules), windows.device, kinds)[keys]
    return enc & 15, enc >> 4


# every kind the solvers' threat staging reads (all but half_open_three)
THREAT_KINDS = (
    "five", "overline", "open_four", "double_four", "half_open_four",
    "open_three",
)


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
