"""Time the flagship search and the C = 64 trunk kernel of two checkouts of
this repo on one GPU, in the order A, B, B, A, so that a change in host
speed during the call falls on both alike.

    python3 -m alphagomoku_tpu_torch.tools.ab_flagship A_DIR B_DIR

A checkout needs `alphagomoku_tpu_torch/`, `chip_smoke.py` and
`runs/flagship_r4/checkpoint/network_23.msgpack` (for example
`git archive <commit> alphagomoku_tpu_torch chip_smoke.py runs/flagship_r4/checkpoint`).
Each run is a fresh process in one checkout, with that checkout's package
and kernels (built there at first use).  It loads network_23, times the
trunk kernel on the stem's output of the bench boards (B = 1280, L = 6:
CUDA events around 20 launches back to back, median of 3, as
`chip_smoke.py` does), then runs one `run_search` of 800 simulations at
the bench configuration, and prints one JSON line.  The last line gives
the medians of each checkout's runs and their ratio B / A.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SIMS = 800

# Run in a checkout's root: uses only what that checkout's package and
# chip_smoke.py have offered since the port began.
_CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from alphagomoku_tpu_torch.game import vectorized as V
from alphagomoku_tpu_torch.game.types import CROSS, GameRules
from alphagomoku_tpu_torch.models.convert import network_from_flax
from alphagomoku_tpu_torch.ops import convnext_fused as CF
from alphagomoku_tpu_torch.patterns import features as FEAT
from alphagomoku_tpu_torch.search import mcts
from alphagomoku_tpu_torch.utils import checkpoint

sims = int(sys.argv[1])
dev = torch.device("cuda")
net = network_from_flax(checkpoint.load(cs.CKPT)).to(dev).eval()
tw = CF.pack_trunk_weights(net)
weights = CF.FusedWeights(net, tw)
tables = V.device_tables(GameRules.FREESTYLE)
boards = torch.from_numpy(cs.bench_boards(cs.BATCH)).to(dev)
stm = torch.full((cs.BATCH,), CROSS, dtype=torch.int8, device=dev)
with torch.no_grad():
    planes = FEAT.unpack_raw_planes(FEAT.encode(tables, boards, stm))
    x = net.stem_forward(planes).permute(0, 2, 3, 1).contiguous()
    trunk_ms = cs.time_cuda(lambda: [CF.fused_trunk(x, tw) for _ in range(20)], reps=3) / 20
cfg = mcts.MCTSConfig(max_nodes=808, max_edges=32, max_depth=16)
CF.fused_trunk.launches = 0
torch.cuda.synchronize()
t0 = time.perf_counter()
state = mcts.run_search(CF.fused_apply, weights, tables, cfg, boards, stm, sims, device=dev)
move = mcts.select_move(state)
torch.cuda.synchronize()
dt = time.perf_counter() - t0
print(json.dumps({
    "trunk_ms": trunk_ms, "ms_per_step": dt / sims * 1e3, "sims_per_s": cs.BATCH * sims / dt,
    "trunk_launches": CF.fused_trunk.launches, "node_count": int(state.tree.node_count.max()),
    "move_sum": int(move.sum()),
}))
"""


def run(checkout: Path, sims: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(sims)], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{checkout}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    runs = {"a": [], "b": []}
    for tag in ("a", "b", "b", "a"):
        res = run(getattr(args, tag).resolve(), SIMS)
        runs[tag].append(res)
        print(json.dumps({"checkout": tag, **res}), flush=True)
    med = {tag: {k: statistics.median(r[k] for r in rs) for k in ("trunk_ms", "ms_per_step")}
           for tag, rs in runs.items()}
    print(json.dumps({"median": med, "b_over_a": {
        k: med["b"][k] / med["a"][k] for k in ("trunk_ms", "ms_per_step")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
