"""Time the trunk kernel at both built widths and an 800-sim search of each
width's network, for two checkouts of this repo on one GPU, in the order A,
B, B, A, so that a change in host speed during the call falls on both alike.

    python3 -m alphagomoku_tpu_torch.tools.ab_flagship A_DIR B_DIR

A checkout needs `alphagomoku_tpu_torch/`, `chip_smoke.py` and
`runs/flagship_r4/checkpoint/network_23.msgpack` (for example
`git archive <commit> alphagomoku_tpu_torch chip_smoke.py runs/flagship_r4/checkpoint`).
Each run is a fresh process in one checkout, with that checkout's package
and kernels (built there at first use).  For the flagship (network_23,
C = 64, L = 6) and then the seeded 8x128 network (`chip_smoke.WIDE_SEED`,
C = 128, L = 8) it times the trunk kernel on the stem's output of the bench
boards (B = 1280: CUDA events around 20 launches back to back, median of 3,
as `chip_smoke.py` does), runs one `run_search` of 800 simulations at
the bench configuration and traces 5 more steps of it under
torch.profiler (`chip_smoke.profile_steps`: wall, device-busy and host ms
per phase, kernel launches per step in all and in `mcts.backup`); it
prints one JSON line.  The last line gives the
medians of each checkout's runs and their ratio B / A.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SIMS = 800
# the readings compared, per width (no suffix: C = 64 and the flagship;
# _128: the 8x128): the search's wall time per step, then 5 more steps
# traced by `chip_smoke.profile_steps` (their wall ms, device-busy ms and
# host ms of each phase)
TIMED = tuple(k + sfx for sfx in ("", "_128") for k in (
    "trunk_ms", "ms_per_step", "traced_ms", "busy_ms", "host_ms_select", "host_ms_evaluate",
    "host_ms_expand", "host_ms_backup"))
# counts read from the same traced steps: kernel launches per step, in all
# and in the backup phase
COUNTED = tuple(k + sfx for sfx in ("", "_128") for k in ("launches", "launches_backup"))

# Run in a checkout's root: uses only what that checkout's package and
# chip_smoke.py have offered since the C = 128 trunk came in.
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
with torch.no_grad():
    planes = FEAT.unpack_raw_planes(FEAT.encode(tables, boards, stm))
nets = {
    "": network_from_flax(checkpoint.load(cs.CKPT)),
    "_128": init_random_(create_network("ConvNextPVQMraw", blocks=8, filters=128),
                         torch.Generator().manual_seed(cs.WIDE_SEED)),
}
res = {}
for sfx, net in nets.items():
    net = net.to(dev).eval()
    tw = CF.pack_trunk_weights(net)
    weights = CF.FusedWeights(net, tw)
    with torch.no_grad():
        x = net.stem_forward(planes).permute(0, 2, 3, 1).contiguous()
        trunk_ms = cs.time_cuda(lambda: [CF.fused_trunk(x, tw) for _ in range(20)], reps=3) / 20
    del x
    CF.fused_trunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = mcts.run_search(CF.fused_apply, weights, tables, cfg, boards, stm, sims, device=dev)
    move = mcts.select_move(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res.update({
        "trunk_ms" + sfx: trunk_ms, "ms_per_step" + sfx: dt / sims * 1e3,
        "sims_per_s" + sfx: cs.BATCH * sims / dt, "trunk_launches" + sfx: CF.fused_trunk.launches,
        "node_count" + sfx: int(state.tree.node_count.max()), "move_sum" + sfx: int(move.sum()),
    })
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, cfg)
    prof = json.loads(cs.profile_steps(simulate, weights, state, 5).split(":", 1)[1])
    res.update({"traced_ms" + sfx: prof["wall_ms_per_step"],
                "busy_ms" + sfx: prof["device_busy_ms_per_step"],
                "launches" + sfx: prof["kernel_launches_per_step"],
                "launches_backup" + sfx: prof["phases"]["mcts.backup"]["launches"],
                **{"host_ms_" + k.split(".")[1] + sfx: v["host_ms"]
                   for k, v in prof["phases"].items() if v["launches"]}})
    del state, weights, net
print(json.dumps(res))
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
    med = {tag: {k: statistics.median(r[k] for r in rs) for k in TIMED + COUNTED}
           for tag, rs in runs.items()}
    print(json.dumps({"median": med, "b_over_a": {
        k: med["b"][k] / med["a"][k] for k in TIMED}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
