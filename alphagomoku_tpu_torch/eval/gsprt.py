"""Generalized sequential probability-ratio test on pentanomial paired-game
results (reference: src/tuning/GSPRT.cpp:18-133, tuning/GSPRT.hpp:22-33).

Normalized-Elo LLR over the 5-outcome distribution of game pairs, with the
reference's dynamic overshoot correction of the accept/reject bounds.

A copy of the reference package's `eval/gsprt.py` (plain Python, no
accelerator work).
"""

from __future__ import annotations

import math

_NELO_DIVIDED_BY_NT = 800.0 / math.log(10.0)


def _llr_normalized(nelo0: float, nelo1: float, results: list[float]) -> float:
    """(reference: GSPRT.cpp:55-68 LLR_normalized)"""
    count = sum(results)
    if count <= 0:
        return 0.0
    eps = 1.0e-3
    pdf = [max(eps, r) / count for r in results]
    n = len(pdf)
    mean = sum(i / n * pdf[i] for i in range(n))
    variance = sum(i / n * (pdf[i] - mean) ** 2 for i in range(n))
    if variance <= 0:
        return 0.0
    nt0 = nelo0 / _NELO_DIVIDED_BY_NT
    nt1 = nelo1 / _NELO_DIVIDED_BY_NT
    nt = (mean - 0.5) / math.sqrt(2.0 * variance)
    return count * math.log(
        (1 + (nt - nt0) ** 2) / (1 + (nt - nt1) ** 2)
    )


class GSPRT:
    """status: -1 undecided, 0 H0 accepted (reject), 1 H1 accepted (pass)."""

    def __init__(
        self, elo0: float, elo1: float, alpha: float = 0.05, beta: float = 0.05
    ):
        self.elo0 = elo0
        self.elo1 = elo1
        self.lower = math.log(beta / (1.0 - alpha))  # LA
        self.upper = math.log((1.0 - beta) / alpha)  # LB
        self.results = [0.0] * 5
        self.llr = 0.0
        self.status = -1
        # overshoot correction state (reference: GSPRT.cpp:97-116)
        self._max_llr = 0.0
        self._min_llr = 0.0
        self._sq0 = 0.0
        self._sq1 = 0.0
        self._o0 = 0.0
        self._o1 = 0.0

    def add_result(self, pair_points: int) -> int:
        """pair_points in 0..4 (A's points over a color-swapped game pair)."""
        self.results[pair_points] += 1
        self.llr = _llr_normalized(self.elo0, self.elo1, self.results)
        if self.llr > self._max_llr:
            self._sq1 += (self.llr - self._max_llr) ** 2
            self._max_llr = self.llr
            self._o1 = self._sq1 / (2 * self.llr) if self.llr else 0.0
        if self.llr < self._min_llr:
            self._sq0 += (self.llr - self._min_llr) ** 2
            self._min_llr = self.llr
            self._o0 = -self._sq0 / (2 * self.llr) if self.llr else 0.0
        if self.llr > self.upper - self._o1:
            self.status = 1
        elif self.llr < self.lower + self._o0:
            self.status = 0
        return self.status

    def add_pentanomial(self, penta) -> int:
        for pts, count in enumerate(penta):
            for _ in range(int(count)):
                self.add_result(pts)
        return self.status
