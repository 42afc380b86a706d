"""Frozen absolute-strength anchor opponent.

A deterministic, net-free evaluator with the network interface
(NetOutput), so the standard match machinery (eval/match.play_multi_match)
can rate any checkpoint against a REPRODUCIBLE fixed opponent across
training runs and rounds: the anchor has no parameters to drift — its
policy is a pure function of the input planes (adjacency + center prior),
its value is uniform, and all of its tactical strength comes from the
search it is run under (pin the anchor MCTSConfig: ANCHOR_MCFG — 200 sims,
VCT leaf solver).

Port of the reference package's `eval/anchor.py`, on the port's planes
(`[B, H, W, 8]`, `patterns/features.unpack_raw_planes`) and on whatever
device they lie: the 24 shifted windows are summed in the reference
package's order, in float32, so the logits are bit-equal to its.  Two
behaviours of the reference are kept (ROADMAP.md §3): `play_multi_match`
runs every opponent at the match's shared `num_simulations`, so AnchorV2
differs from AnchorV1 by its `max_nodes` and solver cap alone; and a block
whose pairs are all excluded (truncated games the anchor's uniform value
cannot adjudicate) scores 0.5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.networks import NetOutput
from ..search import mcts

ANCHOR_VERSION = "AnchorV1"

# pin the anchor's search so its playing strength is reproducible
ANCHOR_SIMS = 200
ANCHOR_MCFG = mcts.MCTSConfig(
    max_nodes=ANCHOR_SIMS + 8,
    max_edges=32,
    max_depth=32,
    leaf_solver="vct",
    leaf_solver_steps=16,
    leaf_solver_cap=64,
)

# AnchorV2: the next tier of the absolute ladder — same net-free policy,
# 4x the pinned search (the r5 flagship SATURATES AnchorV1 at 48/48, so a
# stronger frozen opponent keeps the scale informative going forward)
ANCHOR_V2_VERSION = "AnchorV2"
ANCHOR_V2_SIMS = 800
ANCHOR_V2_MCFG = mcts.MCTSConfig(
    max_nodes=ANCHOR_V2_SIMS + 8,
    max_edges=32,
    max_depth=32,
    leaf_solver="vct",
    leaf_solver_steps=16,
    leaf_solver_cap=128,
)


def anchor_apply(variables, planes: torch.Tensor) -> NetOutput:
    """Net-interface evaluator: planes [B, H, W, 8] raw bit-planes
    (patterns/features.py bits 0-7: legal, own stone, opp stone, ...).

    Policy: stones within Chebyshev distance 2 of a cell, distance-1
    neighbors double-weighted, plus a centered prior — the classic
    neighborhood move prior.  Value: uniform win/draw/loss.  `variables`
    is ignored (pass {})."""
    own = planes[..., 1].float()
    opp = planes[..., 2].float()
    occ = own + opp
    b, h, w = occ.shape

    pad = F.pad(occ, (2, 2, 2, 2))
    near = torch.zeros_like(occ)
    for dr in range(-2, 3):
        for dc in range(-2, 3):
            if dr == 0 and dc == 0:
                continue
            weight = 2.0 if max(abs(dr), abs(dc)) == 1 else 1.0
            near = near + weight * pad[:, 2 + dr : 2 + dr + h, 2 + dc : 2 + dc + w]

    r = torch.arange(h, dtype=torch.float32, device=occ.device)[:, None]
    c = torch.arange(w, dtype=torch.float32, device=occ.device)[None, :]
    center = -0.08 * ((r - (h - 1) / 2.0).abs() + (c - (w - 1) / 2.0).abs())
    logits = 0.6 * near + center[None]

    value_logits = torch.zeros((b, 3), dtype=torch.float32, device=occ.device)
    return NetOutput(
        policy_logits=logits,
        value_logits=value_logits,
        q_logits=None,
        moves_left_logits=None,
        soft_policy_logits=None,
    )


def anchor_opponent(version: str = ANCHOR_VERSION):
    """eval.match.Opponent for the anchor (import here to avoid cycles)."""
    from .match import Opponent

    mcfg = ANCHOR_V2_MCFG if version == ANCHOR_V2_VERSION else ANCHOR_MCFG
    return Opponent(
        net_apply=anchor_apply,
        variables={},
        raw_input=True,
        mcfg=mcfg,
        name=version,
        # uniform value head: cannot adjudicate truncated games — such
        # pairs are excluded from the score instead of scoring free draws
        calibrated_value=False,
    )
