"""Play one self-play generation with the port on one GPU, at the training
manager's configuration, and write its replay buffer.

    python3 -m alphagomoku_tpu_torch.tools.selfplay_generation [--max-moves N] [--out DIR]

The configuration is the reference package's
`TrainingManager.generate_games` at its defaults
(`alphagomoku_tpu/training/manager.py:275-420`, `manager_configs`): the
flagship network_23 (ConvNextPVQMraw 6x64,
`runs/flagship_r4/checkpoint/`), 256 games in lockstep, 100 simulations a
move, `MCTSConfig(max_nodes=2 * sims + 8, max_edges=32, max_depth=32,
leaf_solver="vct", leaf_solver_steps=16, leaf_solver_cap=256)`, tree
reuse, Dirichlet root noise (weight 0.25, alpha 0.1), visit sampling on
the first 10 plies, balanced openings of 4 stones (oversample 4, solver
check on), chunks of 16 moves, games to the end or to `--max-moves` (the
manager's 160 by default).  The games run on the GPU from a
`torch.Generator` seeded with 0; the network's weights are the
checkpoint's.

After each chunk it prints the chunk's counters (`on_stats`) with the
seconds so far.  At the end it writes `buffer_0.npz` (the valid samples of
`make_targets`, the reference package's replay-buffer file) under `--out`
and prints one JSON line: the games and valid samples, the moves searched
and the games finished, seconds per move and samples per second (wall time
of the whole generation, openings included), and the kernel launches per
simulation step, from 3 more steps of the last move's search traced by
torch.profiler (`tools/profiling.py`, `profile_steps`).  The card's name
and power limit come first, as `nvidia-smi` prints them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CKPT = ROOT / "runs" / "flagship_r4" / "checkpoint" / "network_23.msgpack"
H = W = 15
GAMES = 256
SIMS = 100
MAX_MOVES = 160
OPENING_STONES = 4
CHUNK_MOVES = 16


def manager_configs(sims: int = SIMS, max_moves: int = MAX_MOVES, **changes):
    """(MCTSConfig, SelfplayConfig) of the reference package's training
    manager at its defaults (`alphagomoku_tpu/training/manager.py:286-309`:
    max_nodes 2 * sims + 8 with tree reuse, max_edges 32, max_depth 32, the
    VCT leaf solver at steps 16 and cap 256; the SelfplayConfig defaults
    with tree reuse); `changes` replace MCTSConfig fields."""
    from alphagomoku_tpu_torch.search import mcts
    from alphagomoku_tpu_torch.selfplay import SelfplayConfig

    mcfg = mcts.MCTSConfig(max_nodes=2 * sims + 8, max_edges=32, max_depth=32,
                           leaf_solver="vct", leaf_solver_steps=16, leaf_solver_cap=256)
    scfg = SelfplayConfig(num_simulations=sims, max_moves=max_moves, tree_reuse=True)
    return mcfg._replace(**changes), scfg


def flagship_weights(device):
    """network_23's fused weights on `device`."""
    from alphagomoku_tpu_torch.models.convert import network_from_flax
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.utils import checkpoint

    return CF.pack_weights(network_from_flax(checkpoint.load(CKPT)).to(device))


def balanced_openings(weights, tables, generator, games: int, stones: int = OPENING_STONES):
    """The env of `games` balanced openings of `stones` stones (oversample
    4, solver check on), as the training manager starts a generation."""
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.selfplay import generate_balanced_openings, opening_env

    boards = generate_balanced_openings(CF.fused_apply, weights, tables, generator, games, H, W,
                                        stones=stones)
    return opening_env(boards, stones)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--max-moves", type=int, default=MAX_MOVES)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "selfplay_generation")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("selfplay_generation: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from alphagomoku_tpu_torch.data import ReplayBuffer
    from alphagomoku_tpu_torch.game import vectorized as V
    from alphagomoku_tpu_torch.game.types import GameOutcome, GameRules
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.search import mcts
    from alphagomoku_tpu_torch.selfplay import make_targets, play_games_resumable
    from alphagomoku_tpu_torch.tools.profiling import profile_steps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda")
    mcfg, scfg = manager_configs(max_moves=args.max_moves)
    tables = V.device_tables(GameRules.FREESTYLE)
    weights = flagship_weights(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    last = []  # the carry of the last searched move

    def keep(_, carry):
        last[:] = [carry]

    def progress(stats):
        print(json.dumps({"seconds": time.perf_counter() - t0, **stats}), flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env0 = balanced_openings(weights, tables, gen, GAMES)
    result = play_games_resumable(
        CF.fused_apply, weights, tables, mcfg, scfg, gen, GAMES, H, W,
        chunk_moves=CHUNK_MOVES, init_env=env0, on_stats=progress, on_move=keep, device=dev)
    targets = make_targets(result, H * W)
    buffer = ReplayBuffer()
    samples = buffer.add_generation(0, targets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    searched = int((result.record.phase_counters[:, 7] > 0).sum())
    buffer.save_generation(0, str(args.out / "buffer_0.npz"))
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, mcfg)
    profile = json.loads(profile_steps(simulate, weights, last[0].search, 3)
                         .removeprefix("profile: "))
    print(json.dumps({
        "games": GAMES, "valid_samples": samples, "moves_searched": searched,
        "max_moves": args.max_moves, "sims": SIMS,
        "games_finished": int((result.outcome != int(GameOutcome.UNKNOWN)).sum()),
        "seconds": seconds, "seconds_per_move": seconds / max(searched, 1),
        "samples_per_second": samples / seconds,
        "launches_per_step": profile["kernel_launches_per_step"],
        "profile": profile, "buffer": str(args.out / "buffer_0.npz"),
        "device": torch.cuda.get_device_name(0),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
