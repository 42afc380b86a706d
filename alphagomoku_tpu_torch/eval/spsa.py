"""SPSA parameter tuner (reference: src/tuning/SPSA.cpp, tuning/SPSA.hpp):
simultaneous-perturbation stochastic approximation over engine parameters
normalized to [0, 1], with Rademacher perturbations, the reference's gain
sequences a_k = a/(k+1+A)^alpha, c_k = c/(k+1)^gamma, and JSON progress
save/load for resumable tuning runs.

A copy of the reference package's `eval/spsa.py` (plain Python, no
accelerator work).
"""

from __future__ import annotations

import json
from typing import Callable, Sequence

import numpy as np


class SPSA:
    def __init__(
        self,
        func: Callable[[Sequence[float]], float] | None,
        dim: int,
        gradient_func: Callable[[Sequence[float], Sequence[float]], float] | None = None,
        seed: int = 0,
        a: float = 1.1,
        c: float = 0.1,
        alpha: float = 0.602,
        gamma: float = 0.101,
    ):
        if (func is None) == (gradient_func is None):
            raise ValueError("provide exactly one of func / gradient_func")
        self.func = func
        self.gradient_func = gradient_func
        self.theta = np.full(dim, 0.5)
        self.a, self.c, self.alpha, self.gamma = a, c, alpha, gamma
        self.step = 0
        self.rng = np.random.default_rng(seed)

    def set_initial_theta(self, theta: Sequence[float]) -> None:
        self.theta = np.asarray(theta, float).copy()

    def do_one_step(self, max_iterations: int) -> float:
        """(reference: SPSA.cpp:62-106 do_one_step)"""
        A = max_iterations / 10.0
        c_k = self.c / (self.step + 1) ** self.gamma
        a_k = self.a / (self.step + 1 + A) ** self.alpha
        delta = np.where(self.rng.integers(0, 2, self.theta.shape) == 1, 1.0, -1.0)
        tp = np.clip(self.theta + c_k * delta, 0.0, 1.0)
        tm = np.clip(self.theta - c_k * delta, 0.0, 1.0)
        if self.gradient_func is not None:
            grad = self.gradient_func(tp, tm)
        else:
            grad = self.func(tp) - self.func(tm)
        gradient = grad / (2.0 * c_k * delta)
        self.theta = np.clip(self.theta + a_k * gradient, 0.0, 1.0)
        self.step += 1
        return float(grad)

    # -- resumable progress (reference: SPSA.cpp:107-126) ------------------

    def save_progress(self) -> dict:
        return {
            "a": self.a,
            "c": self.c,
            "alpha": self.alpha,
            "gamma": self.gamma,
            "step": self.step,
            "theta": self.theta.tolist(),
        }

    def load_progress(self, data: dict) -> None:
        self.a = data["a"]
        self.c = data["c"]
        self.alpha = data["alpha"]
        self.gamma = data["gamma"]
        self.step = data["step"]
        self.theta = np.asarray(data["theta"], float)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.save_progress(), fh, indent=2)

    def load(self, path: str) -> None:
        with open(path) as fh:
            self.load_progress(json.load(fh))
