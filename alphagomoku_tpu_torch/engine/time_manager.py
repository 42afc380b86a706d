"""Match time control (reference: src/player/TimeManager.cpp:19-141).

Time for a turn = min(turn limit, time_left / sum_i fraction^i) - protocol
lag, where the geometric sum runs over the estimated number of own moves
left.  Moves left = max(1, c0(move) - c2(move) * (expectation - 0.5)^2)
with per-rule piecewise-linear curves (reference: TimeManager.cpp:19-76).

A copy of the reference package's `engine/time_manager.py`."""

from __future__ import annotations

import time

import numpy as np

from ..game.types import GameRules

TIME_FRACTION = 0.04  # (reference: TimeManager.hpp:39)
SWAP2_FRACTION = 0.1


class _Curve:
    def __init__(self, points: list[tuple[int, float]]):
        self.xs = np.array([p[0] for p in points], float)
        self.ys = np.array([p[1] for p in points], float)

    def __call__(self, x: float) -> float:
        return float(np.interp(x, self.xs, self.ys))


class MovesLeftEstimator:
    """(reference: TimeManager.cpp:65-76)"""

    def __init__(self, c0: list[tuple[int, float]], c2: list[tuple[int, float]]):
        self.c0 = _Curve(c0)
        self.c2 = _Curve(c2)

    def get(self, move_number: int, expectation: float) -> float:
        x = abs(expectation - 0.5)
        return max(1.0, self.c0(move_number) - self.c2(move_number) * x * x)


def _freestyle_estimator() -> MovesLeftEstimator:
    # (reference: TimeManager.cpp:19-34)
    return MovesLeftEstimator(
        c0=[(0, 60), (20, 53), (350, 50), (400, 0)],
        c2=[(0, 200), (20, 180), (349, 180), (350, 0)],
    )


def _standard_estimator() -> MovesLeftEstimator:
    # (reference: TimeManager.cpp:35-54; shared by standard/renju/caro)
    return MovesLeftEstimator(
        c0=[(0, 85), (15, 85), (65, 135), (80, 135), (100, 125), (225, 0)],
        c2=[(0, 320), (20, 320), (65, 525), (80, 525), (125, 375), (140, 0)],
    )


class TimeManager:
    def __init__(self):
        self.estimators = {
            GameRules.FREESTYLE: _freestyle_estimator(),
            GameRules.STANDARD: _standard_estimator(),
            GameRules.RENJU: _standard_estimator(),
            GameRules.CARO5: _standard_estimator(),
            GameRules.CARO6: _standard_estimator(),
        }
        self.used_time = 0.0
        self.time_of_last_search = 0.0
        self._start: float | None = None

    # -- timer (reference: TimeManager.cpp:86-110) -------------------------

    def start_timer(self) -> None:
        self._start = time.monotonic()

    def stop_timer(self) -> None:
        if self._start is not None:
            self.used_time += time.monotonic() - self._start
            self._start = None

    def reset_timer(self) -> None:
        self.time_of_last_search = self.used_time
        self.used_time = 0.0
        self._start = None

    def get_elapsed_time(self) -> float:
        if self._start is not None:
            return self.used_time + (time.monotonic() - self._start)
        return self.used_time

    # -- budgets (reference: TimeManager.cpp:119-141) ----------------------

    def get_time_for_turn(
        self,
        rules: GameRules,
        rows: int,
        move_number: int,
        expectation: float,
        time_for_turn: float,
        time_left: float,
        protocol_lag: float = 0.0,
        time_fraction: float | None = None,
    ) -> float:
        moves_left = self.estimators[rules].get(move_number, expectation)
        fraction = (
            time_fraction if time_fraction is not None else TIME_FRACTION
        )
        # geometric series weighting of the remaining budget
        s = (1.0 - fraction**moves_left) / (1.0 - fraction)
        return min(time_for_turn, time_left / s) - protocol_lag

    def get_time_for_opening(
        self, time_for_turn: float, time_left: float, protocol_lag: float = 0.0
    ) -> float:
        return min(time_for_turn, SWAP2_FRACTION * time_left) - protocol_lag
