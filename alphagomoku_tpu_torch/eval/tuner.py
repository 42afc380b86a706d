"""Engine-parameter tuning harness: SPSA over match results, GSPRT gate.

Port of the reference package's `eval/tuner.py`, the counterpart of the
reference's tuning_launcher (reference: tuning_launcher/ +
src/tuning/{SPSA,GSPRT}.cpp): search parameters (exploration constant,
FPU reduction, expansion temperature, ...) are normalised to [0, 1],
perturbed by SPSA, and scored by paired-opening matches between the
perturbed engines, played on `device` (`eval/match.py`); a final GSPRT
match accepts or rejects the tuned parameters against the baseline."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from ..game import vectorized as V
from ..search import mcts
from .gsprt import GSPRT
from .match import play_match, random_openings
from .spsa import SPSA


@dataclass
class TunableParam:
    """A search parameter with its [0, 1] normalisation range."""

    name: str
    low: float
    high: float

    def denorm(self, t: float) -> float:
        return self.low + (self.high - self.low) * float(np.clip(t, 0.0, 1.0))


DEFAULT_PARAMS = [
    TunableParam("exploration_constant", 0.25, 3.0),
    TunableParam("fpu_reduction", 0.0, 0.6),
    TunableParam("policy_expansion_temperature", 0.5, 2.0),
]


def config_from_theta(
    base: mcts.MCTSConfig, params: list[TunableParam], theta
) -> mcts.MCTSConfig:
    return base._replace(**{p.name: p.denorm(t) for p, t in zip(params, theta)})


class EngineTuner:
    """SPSA gradient = match score between the +delta and -delta engines
    (reference: SPSA::do_one_step with a gradient_function driven by
    matches).  The matches run on `device`."""

    def __init__(
        self,
        net_apply: Callable,
        variables: Any,
        tables: V.RuleTables,
        base_config: mcts.MCTSConfig,
        num_simulations: int = 64,
        games_per_step: int = 16,
        rows: int = 15,
        cols: int = 15,
        params: list[TunableParam] | None = None,
        seed: int = 0,
        device="cuda",
    ):
        self.net_apply = net_apply
        self.variables = variables
        self.tables = tables
        self.base = base_config
        self.sims = num_simulations
        self.games = games_per_step
        self.rows, self.cols = rows, cols
        self.params = params if params is not None else DEFAULT_PARAMS
        self.device = device
        self.rng = np.random.default_rng(seed)
        self.spsa = SPSA(None, dim=len(self.params), gradient_func=self._match_gradient, seed=seed)

    def _match_gradient(self, theta_plus, theta_minus) -> float:
        cfg_p = config_from_theta(self.base, self.params, theta_plus)
        cfg_m = config_from_theta(self.base, self.params, theta_minus)
        score = play_param_match(
            self.net_apply, self.variables, self.tables, cfg_p, cfg_m, self.sims,
            random_openings(self.rng, self.games // 2, self.rows, self.cols), self.device,
        )
        # centred score in [-0.5, 0.5]: positive favours theta_plus
        return score - 0.5

    def tune(self, steps: int, progress_path: str | None = None) -> mcts.MCTSConfig:
        for _ in range(steps):
            self.spsa.do_one_step(steps)
            if progress_path:
                self.spsa.save(progress_path)
        return config_from_theta(self.base, self.params, self.spsa.theta)

    def gate(self, candidate: mcts.MCTSConfig, elo0=0.0, elo1=10.0, max_pairs=200) -> int:
        """GSPRT accept/reject of the tuned config against the baseline
        (reference: GSPRT over TwoMatch results); the test is left in
        `self.last_gsprt` (its LLR and results)."""
        g = self.last_gsprt = GSPRT(elo0, elo1)
        while g.status == -1 and sum(g.results) < max_pairs:
            openings = random_openings(self.rng, 4, self.rows, self.cols)
            res_match = play_param_match_full(
                self.net_apply, self.variables, self.tables, candidate, self.base, self.sims,
                openings, self.device,
            )
            g.add_pentanomial(res_match.pentanomial)
        return g.status


def play_param_match_full(net_apply, variables, tables, cfg_a, cfg_b, sims, openings,
                          device="cuda"):
    """Paired match where the two sides differ by SEARCH CONFIG only (same
    network weights)."""
    return play_match(
        net_apply_a=net_apply, variables_a=variables, net_apply_b=net_apply,
        variables_b=variables, tables=tables, mcfg=cfg_a, num_simulations=sims,
        openings=openings, mcfg_b=cfg_b, device=device,
    )


def play_param_match(net_apply, variables, tables, cfg_a, cfg_b, sims, openings,
                     device="cuda"):
    return play_param_match_full(net_apply, variables, tables, cfg_a, cfg_b, sims, openings,
                                 device).score_a
