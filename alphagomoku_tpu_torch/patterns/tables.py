"""Pattern DSL, PatternType / ThreatType codes and the threat table
(numpy, torch-free).

A copy of the rule definitions of the reference package's
`patterns/tables.py`: the matching-rule mini-DSL (`_parse`, `_wrap_*`,
`_classifier_rules`, `_PRIORITY`), the `PT_*` / `TT_*` codes, and the
8^4-entry threat table (`_threat_of`, `_build_threat_table`), built in
memory, and the open-three promotion data of the renju forbidden check
(`_PROMO_*`).  The port classifies windows with bit math compiled from these
rules (`patterns/bitwise.py`, which also builds the 4^10 pattern table from
that bit math), so the reference package's numpy build of that table is
not copied and nothing is cached on disk.

Rule semantics replicate the reference's PatternClassifier
(reference: src/patterns/PatternClassifier.cpp:16-75, :182-327).
"""

from __future__ import annotations

import functools

import numpy as np

from ..game.types import (
    NONE,
    CROSS,
    CIRCLE,
    ILLEGAL,
    GameRules,
)

# ---------------------------------------------------------------------------
# PatternType / ThreatType codes (reference: patterns/PatternTable.hpp:22-32,
# patterns/ThreatTable.hpp:18-30)
# ---------------------------------------------------------------------------

PT_NONE = 0
PT_HALF_OPEN_3 = 1
PT_OPEN_3 = 2
PT_HALF_OPEN_4 = 3
PT_OPEN_4 = 4
PT_DOUBLE_4 = 5
PT_FIVE = 6
PT_OVERLINE = 7

TT_NONE = 0
TT_HALF_OPEN_3 = 1
TT_OPEN_3 = 2
TT_FORK_3x3 = 3
TT_HALF_OPEN_4 = 4
TT_FORK_4x3 = 5
TT_FORK_4x4 = 6
TT_OPEN_4 = 7
TT_FIVE = 8
TT_OVERLINE = 9

PATTERN_LENGTH = 11
CENTER = PATTERN_LENGTH // 2
NUM_PATTERNS = 4**10  # center-free keys

# ---------------------------------------------------------------------------
# Matching-rule mini-DSL
#
# A rule is a sequence of 4-bit masks (bit s set => sign s allowed at that
# offset); a window matches if the rule matches at ANY offset inside it.  Same
# semantics as the reference DSL (src/patterns/PatternClassifier.cpp:16-75)
# but composed with list operations instead of string rewriting.
# ---------------------------------------------------------------------------

_ANY = 0b1111


def _parse(rule: str) -> list[int]:
    """Parse a rule string like "_XXXX[not O]" into allowed-sign masks."""
    masks: list[int] = []
    i = 0
    while i < len(rule):
        c = rule[i]
        if c in "_XO|":
            masks.append(1 << {"_": NONE, "X": CROSS, "O": CIRCLE, "|": ILLEGAL}[c])
            i += 1
        elif c == "[":
            j = rule.index("]", i)
            body = rule[i + 1 : j]
            if body == "any":
                masks.append(_ANY)
            elif body.startswith("not "):
                m = _ANY
                for ch in body[4:]:
                    m &= ~(1 << {"_": NONE, "X": CROSS, "O": CIRCLE, "|": ILLEGAL}[ch])
                masks.append(m & _ANY)
            else:
                m = 0
                for ch in body:
                    m |= 1 << {"_": NONE, "X": CROSS, "O": CIRCLE, "|": ILLEGAL}[ch]
                masks.append(m)
            i = j + 1
        else:
            raise ValueError(f"bad rule {rule!r}")
    return masks


def _wrap_and(rules: list[list[int]], prefix: str, postfix: str) -> list[list[int]]:
    """prefix + rule + postfix for every rule
    (reference: PatternClassifier::modifyPatternsAND)."""
    p, q = _parse(prefix), _parse(postfix)
    return [p + r + q for r in rules]


def _wrap_or3(rules: list[list[int]], prefix: str, common: str, postfix: str) -> list[list[int]]:
    """(prefix + rule + common) OR (common + rule + postfix)
    (reference: PatternClassifier::modifyPatternsOR 3-arg form)."""
    p, q, c = _parse(prefix), _parse(postfix), _parse(common)
    out = []
    for r in rules:
        out.append(p + r + c)
        out.append(c + r + q)
    return out


def _classifier_rules(kind: str, rules: GameRules, sign: int) -> list[list[int]]:
    """Matching rules for one (classifier, rule-variant, sign).

    The base shapes and per-variant end-condition wrappers replicate the
    reference's rule definitions exactly
    (reference: src/patterns/PatternClassifier.cpp:182-327).
    """
    X = "X" if sign == CROSS else "O"
    O = "O" if sign == CROSS else "X"
    not_own = f"[not {X}]"
    not_opp = f"[not {O}]"
    is_black = sign == CROSS  # renju restrictions only apply to black

    def base(shapes: list[str]) -> list[list[int]]:
        return [_parse(s.replace("X", X)) for s in shapes]

    if kind == "overline":
        return base(["XXXXXX"])

    if kind == "five":
        out = base(["XXXXX"])
        if rules == GameRules.STANDARD or (rules == GameRules.RENJU and is_black):
            out = _wrap_and(out, not_own, not_own)
        elif rules == GameRules.CARO5:
            out = _wrap_or3(out, "[_|]", not_own, "[_|]")
        elif rules == GameRules.CARO6:
            out = _wrap_or3(out, not_opp, "[any]", not_opp)
        return out

    if kind == "open_four":
        out = base(["_XXXX_"])
        if rules == GameRules.STANDARD or (rules == GameRules.RENJU and is_black):
            out = _wrap_and(out, not_own, not_own)
        elif rules == GameRules.CARO6:
            out = _wrap_and(out, not_opp, not_opp)
        if rules == GameRules.CARO5:
            out = _wrap_and(out, "[_|]", "[_|]")
        return out

    if kind == "double_four":
        out = base(["X_XXX_X", "XX_XX_XX", "XXX_X_XXX"])
        if rules == GameRules.STANDARD or (rules == GameRules.RENJU and is_black):
            out = _wrap_and(out, not_own, not_own)
        elif rules == GameRules.CARO6:
            out = _wrap_and(out, not_opp, not_opp)
        if rules == GameRules.CARO5:
            out = _wrap_and(out, "[_|]", "[_|]")
        return out

    if kind == "half_open_four":
        out = base(["_XXXX", "X_XXX", "XX_XX", "XXX_X", "XXXX_"])
        if rules == GameRules.STANDARD or (rules == GameRules.RENJU and is_black):
            out = _wrap_and(out, not_own, not_own)
        elif rules == GameRules.CARO5:
            out = _wrap_or3(out, "[_|]", not_own, "[_|]")
        elif rules == GameRules.CARO6:
            out = _wrap_or3(out, not_opp, "[any]", not_opp)
        return out

    if kind == "open_three":
        out = base(["_XXX__", "_XX_X_", "_X_XX_", "__XXX_"])
        if rules == GameRules.STANDARD or (rules == GameRules.RENJU and is_black):
            out = _wrap_and(out, not_own, not_own)
        elif rules == GameRules.CARO6:
            out = _wrap_and(out, not_opp, not_opp)
        if rules == GameRules.CARO5:
            out = _wrap_and(out, "[_|]", "[_|]")
        return out

    if kind == "half_open_three":
        out = base(
            ["__XXX", "_X_XX", "_XX_X", "_XXX_", "X__XX", "X_X_X", "X_XX_", "XX__X", "XX_X_", "XXX__"]
        )
        if rules == GameRules.STANDARD or (rules == GameRules.RENJU and is_black):
            out = _wrap_and(out, not_own, not_own)
        elif rules == GameRules.CARO5:
            out = _wrap_or3(out, "[_|]", not_own, "[_|]")
        elif rules == GameRules.CARO6:
            out = _wrap_or3(out, not_opp, "[any]", not_opp)
        return out

    raise ValueError(kind)


# Priority order of classifiers (reference: PatternTable.cpp:49-66
# ThreatClassifier::operator(): five > overline > open4 > double4 >
# half-open4 > open3 > half-open3).
_PRIORITY = [
    ("five", PT_FIVE),
    ("overline", PT_OVERLINE),
    ("open_four", PT_OPEN_4),
    ("double_four", PT_DOUBLE_4),
    ("half_open_four", PT_HALF_OPEN_4),
    ("open_three", PT_OPEN_3),
    ("half_open_three", PT_HALF_OPEN_3),
]


# ---------------------------------------------------------------------------
# Threat table: ThreatType from the four directional PatternTypes
# ---------------------------------------------------------------------------


def _threat_of(pts: np.ndarray, rules: GameRules, for_circle: bool) -> np.ndarray:
    """ThreatType [N] from 4 directional PatternTypes [N, 4]; exact
    re-expression of reference get_threat (src/patterns/ThreatTable.cpp:52-96).

    `for_circle` selects which half of the renju ThreatEncoding pairs applies:
    black overline is forbidden (OVERLINE) while for white the same pattern
    group means a win (FIVE), etc.
    """
    count5 = (pts == PT_FIVE).sum(1)
    count_ol = (pts == PT_OVERLINE).sum(1)
    count_o3 = (pts == PT_OPEN_3).sum(1)
    count_o4 = (pts == PT_OPEN_4).sum(1)
    count4 = count_o4 + (pts == PT_HALF_OPEN_4).sum(1)
    has_d4 = (pts == PT_DOUBLE_4).sum(1) > 0
    has_ho4 = (pts == PT_HALF_OPEN_4).sum(1) > 0
    has_ho3 = (pts == PT_HALF_OPEN_3).sum(1) > 0

    is5 = count5 > 0
    is_ol = count_ol > 0
    fork33 = count_o3 >= 2
    fork43 = (count_o3 >= 1) & (count4 >= 1)
    fork44 = has_d4 | (count4 >= 2)
    has_o4 = count_o4 > 0

    out = np.zeros(len(pts), dtype=np.uint8)
    # Assign lowest priority first, then overwrite with higher priorities.
    out[has_ho3] = TT_HALF_OPEN_3
    out[count_o3 > 0] = TT_OPEN_3
    out[has_ho4] = TT_HALF_OPEN_4
    out[fork33] = TT_FORK_3x3
    if rules == GameRules.RENJU:
        # Reference priority: overline > fork44 > open4 > fork43 (applied here
        # lowest-first, later assignments overwrite).  A 4x3 or open-4 point
        # that is simultaneously a 3x3 fork is still forbidden for black
        # (reference: ThreatTable.cpp:63-76).
        out[fork43] = TT_FORK_4x3
        out[fork43 & fork33] = TT_FORK_4x3 if for_circle else TT_FORK_3x3
        out[has_o4] = TT_OPEN_4
        out[has_o4 & fork33] = TT_OPEN_4 if for_circle else TT_FORK_3x3
        out[fork44] = TT_FORK_4x4
        out[is_ol] = TT_FIVE if for_circle else TT_OVERLINE
    else:
        out[fork43] = TT_FORK_4x3
        out[has_o4] = TT_OPEN_4
        out[fork44] = TT_FORK_4x4
    out[is5] = TT_FIVE
    return out


@functools.lru_cache(maxsize=None)
def _build_threat_table(rules: GameRules) -> np.ndarray:
    """uint8[8^4]: ThreatType nibbles (cross | circle<<4) indexed by
    sum(PatternType[dir] << 3*dir).  Built in memory, once per rule."""
    rules = GameRules(rules)
    idx = np.arange(8**4, dtype=np.uint32)
    pts = np.stack([(idx >> np.uint32(3 * d)) & 7 for d in range(4)], axis=1).astype(np.uint8)
    cross = _threat_of(pts, rules, for_circle=False)
    circle = _threat_of(pts, rules, for_circle=True)
    out = (cross | (circle << 4)).astype(np.uint8)
    out.flags.writeable = False
    return out


# ---------------------------------------------------------------------------
# Open-three promotion spots (renju forbidden check): for the first of 12
# (window & mask) == pattern matches, an 11-bit mask of the spots that may
# promote the open three made at the center into a straight four.  Data
# replicated from the reference (src/patterns/DefensiveMoveTable.cpp:
# 329-341); candidates are validated against the board downstream, so an
# over-approximation is harmless.
# ---------------------------------------------------------------------------

_PROMO_PATTERNS = (320, 4352, 20480, 80, 16640, 69632, 272, 4160, 81920, 320, 4352, 20480)
_PROMO_MASKS = (65520, 262080, 1048320, 16380, 262080, 1048320, 16380, 65520, 1048320,
                16380, 65520, 262080)
_PROMO_RESULTS = (196, 392, 784, 82, 328, 656, 74, 148, 592, 70, 140, 280)
