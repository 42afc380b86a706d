"""Tune the engine's search parameters on the card: SPSA steps, then a
capped GSPRT gate of the tuned configuration against the baseline.

    python3 -m alphagomoku_tpu_torch.tools.tune_engine [--steps N]
        [--gate-pairs P] [--sims S] [--games G] [--checkpoint PATH]
        [--out DIR] [--device cuda]

Runs `eval.tuner.EngineTuner` at its defaults (64 simulations a move, 16
games a step, 15x15, `DEFAULT_PARAMS`: exploration constant, FPU
reduction, expansion temperature) with the flagship network_23, over a
base configuration of `policy="puct_fpu"` (the policy that reads the FPU
reduction), `max_nodes = sims + 8`, 32 edge slots and 16 levels.  Each
SPSA step plays one match of G games to their end between the +delta and
-delta engines; the gate plays pairs of games until the GSPRT decides or
P pairs are played.  Prints a line for each step (its seconds, the match
gradient, theta) and for the gate, then one JSON line with the seconds of
each SPSA step and of the gate, the tuned configuration's parameters and
the gate's status and LLR; with `--out`, writes it to DIR/tune_engine.json
and SPSA's progress to DIR/spsa.json too.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CKPT = ROOT / "runs" / "flagship_r4" / "checkpoint" / "network_23.msgpack"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--gate-pairs", type=int, default=8)
    parser.add_argument("--sims", type=int, default=64)
    parser.add_argument("--games", type=int, default=16)
    parser.add_argument("--checkpoint", type=Path, default=CKPT)
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from ..eval.tuner import EngineTuner, config_from_theta
    from ..game import vectorized as V
    from ..game.types import GameRules
    from ..models.convert import network_from_flax
    from ..models.forward import network_apply
    from ..search import mcts
    from ..utils import checkpoint

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tune_engine: torch.cuda.is_available() is false")
    net = network_from_flax(checkpoint.load(args.checkpoint)).to(args.device).eval()
    apply, variables = network_apply(net)
    base = mcts.MCTSConfig(max_nodes=args.sims + 8, max_edges=32, max_depth=16,
                           policy="puct_fpu")
    tuner = EngineTuner(apply, variables, V.device_tables(GameRules.FREESTYLE), base,
                        num_simulations=args.sims, games_per_step=args.games, device=args.device)
    progress = None
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        progress = str(args.out / "spsa.json")
    grads = []
    inner = tuner.spsa.gradient_func
    tuner.spsa.gradient_func = lambda tp, tm: grads.append(inner(tp, tm)) or grads[-1]
    step_s = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        tuner.spsa.do_one_step(args.steps)
        if progress:
            tuner.spsa.save(progress)
        step_s.append(time.perf_counter() - t0)
        print(f"tune_engine: SPSA step {i + 1} of {args.steps}: {step_s[-1]:.1f} s, "
              f"{args.games} games at {args.sims} sims, gradient {grads[-1]:+.4f}, theta "
              f"{[round(t, 4) for t in tuner.spsa.theta]}", flush=True)
    tuned = config_from_theta(base, tuner.params, tuner.spsa.theta)
    t0 = time.perf_counter()
    status = tuner.gate(tuned, max_pairs=args.gate_pairs)
    gate_s = time.perf_counter() - t0
    g = tuner.last_gsprt
    print(f"tune_engine: gate {gate_s:.1f} s, status {status} (-1 undecided, 0 rejected, 1 "
          f"accepted), LLR {g.llr:.4f} over pentanomial {g.results}", flush=True)
    out = {"steps": args.steps, "sims": args.sims, "games_per_step": args.games,
           "step_seconds": step_s, "gradients": grads, "theta": list(tuner.spsa.theta),
           "tuned": {p.name: getattr(tuned, p.name) for p in tuner.params},
           "gate_seconds": gate_s, "gate_status": status, "gate_llr": g.llr,
           "gate_pentanomial": [int(x) for x in g.results], "gate_max_pairs": args.gate_pairs,
           "device": args.device}
    if args.out is not None:
        (args.out / "tune_engine.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
