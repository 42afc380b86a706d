"""Run searches of two sides on one GPU, in the order A, B, B, A (or A, B),
so that a change in host speed during the call falls on both alike, and
compare them: their times, and whether their trees, chosen moves and
launches per step are the same.

    python3 -m alphagomoku_tpu_torch.tools.ab_flagship A B [--order abba|ab]

A side is `DIR[:PATH[,PATH...]]`: a checkout of this repo and the searches
to run in it (default `flagship,8x128`).  PATH is one of `flagship`,
`8x128`, `strength` and `loss_prover`, the searches of `chip_smoke.py`
phases 7, 11, 12 and 14: batch 1280 at the bench configuration
(max_nodes 808, max_edges 32, max_depth 16, freestyle, bench boards from
seed 0), network_23 (C = 64, L = 6) or the seeded 8x128 network
(`chip_smoke.WIDE_SEED`, C = 128, L = 8), the strength search with the VCT
leaf solver (steps 16, cap 256), the loss_prover search with the loss
prover too (loss_cap 32, loss_options 8).  Two checkouts with the same
paths compare a change with its parent; one checkout with two paths
(`DIR:strength DIR:loss_prover`) compares two configurations.

A checkout needs `alphagomoku_tpu_torch/`, `chip_smoke.py` and
`runs/flagship_r4/checkpoint/network_23.msgpack` (for example
`git archive <commit> alphagomoku_tpu_torch chip_smoke.py runs/flagship_r4/checkpoint`).
Each run is a fresh process in one checkout, with that checkout's package
and kernels (built there at first use).  For each path it times the trunk
kernel on the stem's output of the bench boards (CUDA events around 20
launches back to back, median of 3, as `chip_smoke.py` does), runs one
`run_search` of 800 simulations and traces 5 more steps of it under
torch.profiler (`chip_smoke.profile_steps`: wall, device-busy and host ms
per phase, kernel launches per step in all and per phase); it prints one
JSON line.  The last line pairs A's i-th path with B's i-th path: the
medians of each side's runs, their ratio B / A, and whether the counts
(node count, sum of the chosen moves, trunk launches, launches per traced
step in all and per phase) are the same in every run of both sides, where
the two paths are one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SIMS = 800
PATHS = ("flagship", "8x128", "strength", "loss_prover")
# the readings compared: the trunk kernel's device ms, the search's wall
# time per step, then 5 more steps traced by `chip_smoke.profile_steps`
# (their wall ms, device-busy ms and host ms of each phase)
TIMED = ("trunk_ms", "ms_per_step", "traced_ms", "busy_ms", "host_ms_select",
         "host_ms_evaluate", "host_ms_solve", "host_ms_expand", "host_ms_backup")
# counts that a change which keeps the search must keep
SAME = ("node_count", "move_sum", "trunk_launches", "launches", "phase_launches")

# Run in a checkout's root: uses only what that checkout's package and
# chip_smoke.py have offered since the strength search came in (and the
# loss prover, for that path).
_CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from alphagomoku_tpu_torch.game import vectorized as V
from alphagomoku_tpu_torch.game.types import CROSS, GameRules
from alphagomoku_tpu_torch.models.convert import network_from_flax
from alphagomoku_tpu_torch.models.networks import create_network, init_random_
from alphagomoku_tpu_torch.ops import convnext_fused as CF
from alphagomoku_tpu_torch.patterns import features as FEAT
from alphagomoku_tpu_torch.search import mcts
from alphagomoku_tpu_torch.utils import checkpoint

sims = int(sys.argv[1])
dev = torch.device("cuda")
tables = V.device_tables(GameRules.FREESTYLE)
boards = torch.from_numpy(cs.bench_boards(cs.BATCH)).to(dev)
stm = torch.full((cs.BATCH,), CROSS, dtype=torch.int8, device=dev)
cfg = mcts.MCTSConfig(max_nodes=808, max_edges=32, max_depth=16)
scfg = cfg._replace(leaf_solver="vct", leaf_solver_steps=16, leaf_solver_cap=256)
with torch.no_grad():
    planes = FEAT.unpack_raw_planes(FEAT.encode(tables, boards, stm))
nets = {
    "64": lambda: network_from_flax(checkpoint.load(cs.CKPT)),
    "128": lambda: init_random_(create_network("ConvNextPVQMraw", blocks=8, filters=128),
                                torch.Generator().manual_seed(cs.WIDE_SEED)),
}
searches = {
    "flagship": ("64", cfg),
    "8x128": ("128", cfg),
    "strength": ("64", scfg),
    "loss_prover": ("64", scfg._replace(loss_prover=True, loss_cap=32, loss_options=8)),
}
res = {}
for name in sys.argv[2].split(","):
    width, pcfg = searches[name]
    net = nets[width]().to(dev).eval()
    tw = CF.pack_trunk_weights(net)
    weights = CF.FusedWeights(net, tw)
    with torch.no_grad():
        x = net.stem_forward(planes).permute(0, 2, 3, 1).contiguous()
        trunk_ms = cs.time_cuda(lambda: [CF.fused_trunk(x, tw) for _ in range(20)], reps=3) / 20
    del x
    CF.fused_trunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = mcts.run_search(CF.fused_apply, weights, tables, pcfg, boards, stm, sims, device=dev)
    move = mcts.select_move(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {
        "trunk_ms": trunk_ms, "ms_per_step": dt / sims * 1e3, "sims_per_s": cs.BATCH * sims / dt,
        "trunk_launches": CF.fused_trunk.launches, "node_count": int(state.tree.node_count.max()),
        "move_sum": int(move.sum()),
    }
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, pcfg)
    prof = json.loads(cs.profile_steps(simulate, weights, state, 5).split(":", 1)[1])
    out.update({"traced_ms": prof["wall_ms_per_step"],
                "busy_ms": prof["device_busy_ms_per_step"],
                "launches": prof["kernel_launches_per_step"],
                "phase_launches": {k: v["launches"] for k, v in prof["phases"].items()},
                **{"host_ms_" + k.split(".")[1]: v["host_ms"] for k, v in prof["phases"].items()}})
    res[name] = out
    del state, weights, net
print(json.dumps(res))
"""


def side(arg: str) -> tuple[Path, list[str]]:
    """`DIR[:PATH[,PATH...]]` -> (checkout, paths)."""
    checkout, _, paths = arg.partition(":")
    names = paths.split(",") if paths else ["flagship", "8x128"]
    bad = [p for p in names if p not in PATHS]
    if bad:
        raise argparse.ArgumentTypeError(f"unknown paths {bad}; choose from {PATHS}")
    return Path(checkout).resolve(), names


def run(checkout: Path, paths: list[str]) -> dict:
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(SIMS), ",".join(paths)],
                          cwd=checkout, capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise SystemExit(f"{checkout}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=side)
    ap.add_argument("b", type=side)
    ap.add_argument("--order", choices=("abba", "ab"), default="abba")
    args = ap.parse_args()
    if len(args.a[1]) != len(args.b[1]):
        ap.error("A and B must name as many paths")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    runs = {"a": [], "b": []}
    for tag in args.order:
        res = run(*getattr(args, tag))
        runs[tag].append(res)
        print(json.dumps({"side": tag, **res}), flush=True)
    pairs = {}
    for pa, pb in zip(args.a[1], args.b[1]):
        med = {tag: {k: statistics.median(r[p][k] for r in runs[tag]) for k in TIMED}
               for tag, p in (("a", pa), ("b", pb))}
        pair = {"median": med, "b_over_a": {k: med["b"][k] / med["a"][k] if med["a"][k] else None
                                            for k in TIMED}}
        if pa == pb:
            first = runs["a"][0][pa]
            pair["same"] = {k: all(r[pa][k] == first[k] for rs in runs.values() for r in rs)
                            for k in SAME}
        pairs[f"{pa}/{pb}"] = pair
    print(json.dumps(pairs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
