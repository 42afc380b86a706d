"""Run one whole training-manager iteration with the port on one GPU:
self-play, training, checkpoint and SWA, gating, at the manager's defaults.

    python3 -m alphagomoku_tpu_torch.tools.train_iteration [--out DIR] [--sims N]

The run resumes a temporary copy of the reference package's run in
`runs/flagship_r4/` (network_28, best 23, 11,600 learning steps) with
`TrainingManager(ManagerConfig(working_dir=...), device="cuda")` at its
defaults (`alphagomoku_tpu/training/manager.py:53-113`): ConvNextPVQMraw
6x64, freestyle 15x15, 256 self-play games at 100 sims with the VCT leaf
solver and tree reuse, 200 train steps at batch 256 (RAdam, lr 1e-3, L2
1e-4), SWA over 10 checkpoints, gating of 64 games at 100 sims to the end.
`--sims N` sets the config's `num_simulations` (self-play's and gating's)
in place of 100: at 100 the iteration takes more than an hour on an H100,
since gating plays until its longest game ends.
Before the iteration the replay window is loaded through `generate_games`'
skip path from the buffer files of the last 20 iterations that the copy
holds, with their validation buffers: all 20 in a git checkout, as an
uninterrupted run holds them; none in a copy of the repo that leaves the
buffer files out, which then trains on iteration 29's generation alone, as
`TrainingManager.run` does after a restart.  Then `run_iteration_rl(29)`
runs.

It prints the card's name and power limit first, as `nvidia-smi` gives
them, a progress line every 8 self-play moves and every 16 gating plies
(the first with the seconds of self-play and training), and last one JSON
line: the seconds of each stage, self-play samples per second, train steps
per second, the iteration's peak device memory, the per-head mean losses,
the gating result, and the kernel launches per self-play step (3 more
steps of the last self-play search traced by torch.profiler).  The JSON
line and the iteration's new files (metadata.json, network_29,
network_swa, the history, gating and buffer-stats lines) go to `--out`
(default build/train_iteration/), and every line printed is also appended
to `--out`/progress.jsonl as it is printed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RUN = ROOT / "runs" / "flagship_r4"
ITERATION = 29
NEW_FILES = ("metadata.json", f"checkpoint/network_{ITERATION}.msgpack",
             "checkpoint/network_swa.msgpack", "training_history.txt", "gating.txt",
             "buffer_stats.txt")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "train_iteration")
    parser.add_argument("--sims", type=int, default=100)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("train_iteration: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.search import mcts
    from alphagomoku_tpu_torch.tools.profiling import profile_steps
    from alphagomoku_tpu_torch.training import ManagerConfig, TrainingManager

    args.out.mkdir(parents=True, exist_ok=True)
    progress = args.out / "progress.jsonl"
    progress.unlink(missing_ok=True)

    def say(line: str) -> None:
        print(line, flush=True)
        with open(progress, "a") as fh:
            fh.write(line + "\n")

    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    tmp = tempfile.TemporaryDirectory()
    wd = Path(tmp.name) / "run"
    shutil.copytree(RUN, wd)
    mgr = TrainingManager(ManagerConfig(working_dir=str(wd), num_simulations=args.sims),
                          device="cuda")
    window = [i for i in range(ITERATION - mgr.cfg.buffer_window, ITERATION)
              if (wd / "train_buffer" / f"buffer_{i}.npz").exists()]
    for i in window:
        mgr.generate_games(i)
        mgr.valid_buffer.load_generation(i, str(wd / "valid_buffer" / f"buffer_{i}.npz"))
    say(json.dumps({"resumed": mgr.metadata, "window": window,
                    "samples": mgr.buffer.num_samples, "sims": args.sims}))

    last, plies = [], [0]  # the carry of the last searched self-play move; gating's plies

    def on_move(move, carry):
        last[:] = [carry]
        if move % 8 == 7:
            say(json.dumps({"stage": "selfplay", "moves": move + 1,
                            "seconds": time.perf_counter() - t_start}))

    def on_ply(env, moves):
        plies[0] += 1
        if plies[0] == 1 or plies[0] % 16 == 0:
            say(json.dumps({"stage": "gating", "plies": plies[0],
                            "seconds": time.perf_counter() - t_start,
                            "stage_seconds": mgr.last_timings}))

    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    metrics = mgr.run_iteration_rl(ITERATION, on_move=on_move, on_ply=on_ply)
    peak = torch.cuda.max_memory_allocated()
    for name in NEW_FILES:
        (args.out / name).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(wd / name, args.out / name)
    times = dict(mgr.last_timings)
    res = mgr.last_gating
    # launches per self-play step: 3 more steps of the last move's search
    weights = CF.pack_weights(mgr._load_net(mgr.checkpoint_path(ITERATION - 1)))
    simulate = mcts.make_simulate_fn(CF.fused_apply, mgr.tables, mgr._play_mcfg)
    profile = json.loads(profile_steps(simulate, weights, last[0].search, 3)
                         .removeprefix("profile: "))
    line = json.dumps({
        "iteration": ITERATION, "sims": args.sims, "stage_seconds": times,
        "samples": metrics["samples"],
        "samples_per_second": metrics["samples"] / times["selfplay"],
        "train_steps_per_second": mgr.cfg.train_steps_per_iteration / times["train_steps"],
        "peak_memory_bytes": peak,
        "losses": {k: v for k, v in metrics.items() if k not in ("promoted", "score", "elo")},
        "gating": {"promoted": metrics["promoted"], "score": res.score_a, "elo": res.elo_a,
                   "pentanomial": res.pentanomial.tolist(), "truncated": res.truncated,
                   "game_lengths": res.game_lengths.tolist()},
        "metadata": mgr.metadata, "device": torch.cuda.get_device_name(0),
        "launches_per_selfplay_step": profile["kernel_launches_per_step"],
        "selfplay_profile": profile,
    })
    (args.out / "train_iteration.json").write_text(line + "\n")
    say(line)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
