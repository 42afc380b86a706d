#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device  - needs CUDA; prints nvidia-smi's name and power limit;
  2. build   - builds the CUDA kernels (csrc/*.cu -> build/torch_kernels/);
  3. score_scan  - kernel vs plain version on the card, bit-equal, at the
     bench shape R = 1280, D = 16, K = 32, with timings, and what the
     scan kernels get from the card (`score_scan.scan_occupancy`:
     registers, blocks per SM, spills, which must be 0);
  4. score_backup - kernel vs plain version on clones of random trees at
     the bench shape (B = 1280, N = 808, D = 16, K = 32), the whole trees
     bit-equal, with timings (the rows in L2 and, `cold_ms`, after a
     write of 128 MB that evicts them) and its bytes bound at full D and
     at this input's valid levels;
  5. fused_trunk - kernel vs plain version at B = 1280, C = 64, L = 6 with
     the flagship network_23 weights, in bf16 ulps (utils/bf16.py): all
     six blocks, each block alone, and kernels fed one bias left out, which
     the check must reject; timings, the bound, the same trunk through
     cuDNN/cuBLAS (bf16 conv2d + matmul) as a yardstick, and what the kernel
     gets from the card (registers per thread, CTAs per SM, shared memory
     per CTA, spills: `convnext_fused.trunk_occupancy`);
  6. network - the full fused forward (kernel trunk) vs the same forward
     with the plain trunk, head by head, in bf16 ulps of at least 1/16
     (`HEAD_LIMITS`);
  7. search  - mcts.run_search, 800 simulations, at the bench configuration (6x64
     network_23, batch 1280, max_nodes 808, max_edges 32, max_depth 16,
     freestyle 15x15, bench boards from seed 0), with the kernels' launch
     counts read around it; then score_backup held against its plain
     version on clones of that search's tree, on paths walked from each
     root down the most-visited edges, timed the same way;
  8. profile - `PROFILE_STEPS` more steps of the same search under torch.profiler: the
     device's busy share, kernel launches per step, and host and device
     milliseconds per step of each phase of the step;
  9. fused_trunk 128 - phase 5 at C = 128, L = 8 with the seeded 8x128
     network (`models.networks.init_random_`, seed 0);
 10. network 128 - phase 6 with the 8x128 network;
 11. search 8x128 - phases 7 and 8 with the 8x128 network (`WIDE_SIMS`
     sims);
 12. search strength - phase 7 with network_23 and the VCT leaf solver at
     the engine default (steps 16, cap 256, depth 6, threes 2;
     `STRENGTH_SIMS` sims), with the roots and leaves it proves;
 13. profile strength - phase 8 for the strength search, `mcts.solve` as
     its own phase;
 14. search loss_prover - phase 12 with the loss prover (`bench.py:186`:
     loss_cap 32, loss_options 8; `LOSS_SIMS` sims), then its profile;
 15. search renju - the same search under renju with the VCF leaf solver
     (`RENJU_SIMS` sims), then its profile: the roots' forbidden cells and
     the residual of their certificate, the cells that feature bit 6 marks
     in the positions the search evaluated, the host gates' syncs per
     step, and a gate that no move chosen for black lies on a cell that
     the root's bit 6 marks forbidden; then the same search and gate on
     the clustered boards of phase 16 with black to move (`CLUSTER_SIMS`
     sims), whose roots hold forbidden cells, so that the gate can fail;
 16. solvers renju - on 1280 black-heavy clustered renju boards (the
     generator of tests/test_torch_renju.py, seed 7): forbidden_plane_u,
     vct_batched.solve, vcf.solve and solve_loss(levels=2) on the card,
     each bit-equal to the same function on CPU copies (solve_loss on the
     first `LOSS2_CPU_BOARDS` boards' rows: its 2-level batch is 256
     VCT rows per board);
 17. selfplay - `play_games_resumable` at the training manager's
     configuration (`tools/selfplay_generation.py`: network_23, 256 games
     from balanced openings of 4 stones, 100 sims, max_nodes 208,
     max_depth 32, the VCT leaf solver at steps 16 and cap 256, tree
     reuse, Dirichlet noise 0.25 / 0.1, temperature on the first 10
     plies), cut to `SELFPLAY_MOVES` moves in chunks of `SELFPLAY_CHUNK`,
     stopped after the first chunk and resumed from its snapshot; then the
     trunk kernel at its batch and score_backup on its last tree's paths
     (depth 32: `score_backup_kernel<32>`), each held against its plain
     version as in phases 5 and 7; gates
     after every move (`MoveChecks`: node_count, sims, root visits, the
     noisy priors' sums, the lanes reused against the reuse rule), on the
     games (`check_games`: moves on empty cells of live games, the moves
     replayed through `env_step` on the CPU give the same boards,
     outcomes and game lengths, which count the stones) and on the
     launches (score_backup once a step); ms per move and per step, the
     share of lanes reused per move, games finished; then the last move's
     search traced, as phase 8;
 18. selfplay to the end - the same with no leaf solver, `TO_END_SIMS`
     sims and a draw horizon `TO_END_PLIES` plies past the openings, in
     one call: every game ends with an outcome, lanes reuse their trees at
     every move after the first, `make_targets` gives valid samples whose
     value_wdl rows sum to 1, and a ReplayBuffer saved and loaded in
     build/chip_smoke/ gives equal arrays;
 19. train - the training manager (`training/manager.py`) at its
     defaults, resumed from a temporary copy of runs/flagship_r4/'s
     checkpoints and records (network_28, best 23, 11,600 learning
     steps): the replay window of the last 20 iterations filled through
     `generate_games`' skip path from buffer files holding phase 18's
     generation (split into train and validation samples as the manager
     splits them; the reference run's own buffers are not read, so the
     phase runs the same in a copy that leaves them out); one train step on the card held
     against the same step on a CPU copy (32 samples, same symmetries,
     the CPU tests' tolerances); `train_iteration(29)`, 200 steps at
     batch 256 (steps per second, peak device memory, finite losses,
     learning_steps 11,800, network_29 and network_swa read back, the
     history line; the per-head means beside the JAX run's iteration-28
     line); `_host_vars()` after training: the trunk kernel on the new
     pack within TRUNK_LIMITS and timed, the pack equal to the trained
     weights, the fused forward within HEAD_LIMITS of the plain-trunk
     forward and within tests/test_ops.py's absolute rule of the trained
     module's own forward, the module still in train mode; `gating(29)` cut through the config to
     `TRAIN_GATING_GAMES` games at `TRAIN_GATING_SIMS` sims, with
     balanced openings, its launches counted (score_backup once a search
     step, the trunk once more per search and once for the openings):
     gating.txt's line, the pentanomial over the pairs, every game ended,
     every live move on an empty cell; the seconds of each stage;
 20. engine (run after phase 7, before phase 8's trace) - the playing
     engine (`engine/manager.py`) at the launcher's
     defaults (extended protocol, network_23, 400 sims: N = 1,208, K = 32,
     D = 40, the host VCT and the VCT leaf solver, B = 1), each search cut
     by `INFO max_node` to `ENGINE_MAX_NODE` sims: BEGIN, two TURNs along
     the searched tree (which reuse it), an open four (the root VCF: WIN
     in 1), a four chain (WIN in 5), the opponent's four to block,
     TAKEBACK, renju with SHOWFORBID and a search for black; gates: every
     answer on an empty cell and, for black under renju, not on a
     forbidden one (`game.rules.is_forbidden`), the win, the chain and
     the block answered right, the tree reused, per search score_backup
     launched once a step and the trunk once a step plus once for a fresh
     root, finite values; ms per simulation step, launches per step,
     seconds per move.  network_23 on a 20x20 board must be refused (its
     moves-left head has 225 buckets).  Then score_backup at D = 40 on
     the engine's tree (its most-visited path, and a full 40-level path:
     both chunks of `score_backup_kernel<32>`), and the trunk at B = 1 on
     15x15 and on 20x20 (the 20x20 engine with seeded 6x64 weights, one
     search), each against its plain version (C = 128 on 20x20: phase
     24); one
     realtime search over the YixinBoard protocol; the benchmark sweep
     and config (`engine/benchmark.py`, written under
     build/chip_smoke/engine_benchmark/);
 21. zoo and selfcheck - part 1 (run after phase 4, before the first
     trace of search steps): score_scan and score_backup at K = 33, 81
     and 225 edge slots (the wide kernels: the rows staged in shared
     memory, each lane a slot every 32), D = 16 and 32, and at K = 400,
     D = 16, bit-equal to their plain versions and timed beside their
     bytes bounds and the parent design's times, with each K's
     registers, blocks per SM, dynamic shared memory and spills (0);
     parts 2-4 (run last): every trunk family but
     convnext at the launcher's width (6x64; the unets at 64; FastPolicy
     at 2x32) with seeded weights: an 8-sim search at B = 256 on the
     bench boards through `models.forward.network_apply` (score_backup
     once a step, the trunk kernel never) and its ms per step, timed
     alone; then, with nothing timed any more, `python -m
     alphagomoku_tpu_torch.engine.manager --selfcheck` as a child process
     (rc 0, five PASS lines) while one 50-sim BEGIN runs through the
     port's ProgramManager with `--arch Transformer_v2`, each zoo
     network's forward is held against a CPU copy's (float32 within 1e-3;
     bf16 within tests/test_ops.py's absolute rule and no farther from the
     float32 heads than the CPU's) and its train step too on two batches
     (float32 at the CPU tests' tolerances; bfloat16 in phase 19's bands
     but its 0.5 cap), and the selfcheck's search runs in this process
     with the launches counted (16 at K = 81);
 22. the rest of search (run after phase 20, before phase 8) -
     `run_search` at leaf_batch 4 (four descents a step under virtual
     loss) with network_23 at the bench configuration, `LB_SIMS` sims in
     50 steps: launches counted around it (score_scan once a step, backup
     B being `score_backup_paths`; score_backup never; the trunk once a
     step and once for the roots), the search's gates, one more step
     replayed on CPU copies of `REPLAY_BOARDS` trees with the card's leaf
     evaluation put in (the integer tree tensors equal), score_scan held
     bit-equal against its plain version on that step's R = 5,120 rows
     and timed in a CUDA graph, the trunk kernel on its 5,120 leaves held
     within TRUNK_LIMITS and timed; the same for a 9x9 leaf-batch search
     at K = 81 (seeded 6x64, B = 256, `LB9_SIMS` sims: the wide scan
     kernel); then at B = 256, `OPTION_SIMS` sims on network_23: every
     in-tree policy (learnable with seeded tree-policy weights) and
     init_to mode, each tree's edge utility at its root and at the root's
     most-visited child held against CPU copies (within 2e-6 relative,
     the argmax equal where the top two lie farther apart); a seeded
     quantized NNUE blended in (the features and both int32 accumulators
     equal between card and CPU); each generator's root move mask (no
     root edge or visit off the mask where it leaves a move); one SPSA
     step of EngineTuner (`TUNE_OPENINGS` openings x 2 colours at
     `TUNE_SIMS` sims); last `PHASE22_PROFILE_STEPS` step of the
     leaf_batch 4 search traced, and its ms and launches per step printed
     beside phases 7 and 8's at S = 1;
 23. the last modules (run after phase 21) - network_23 against
     AnchorV1 (`eval/anchor.py`) through `play_multi_match` under
     `ANCHOR_MCFG` (VCT leaf solver, D = 32: score_backup<32> for both
     sides), `ANCHOR_PAIRS` openings on 15x15 at `ANCHOR_MATCH_SIMS` sims
     for `ANCHOR_PLIES` plies: every live move on an empty cell, both nets'
     values on the final boards finite, the anchor's logits on every ply's
     boards bit-equal to its CPU copy's, seconds and launches per ply; then
     a world-size-1 NCCL group (`parallel.distributed.initialize` at
     tcp://localhost): one DP train step of network_23 at batch `DP_BATCH`
     (`make_dp_train_step`) bitwise equal to the plain step on the same
     batch and modes (parameters, BatchNorm statistics, gradients,
     losses), both timed, no kernel launched; one `make_rl_round`
     (`RL_BATCH` boards, `RL_SIMS` sims, `RL_MOVES` moves, one DP step);
 24. trunk shapes (run after phase 11) - the trunk kernel at the widths and
     boards of `TRUNK_SHAPES`, each a seeded `init_random_` network built
     for its board, as in phase 5: C = 16 and 96 (zero channels padded to
     64 and 128), C = 128 on 16x16 and 20x20 (the cluster entry,
     `convnext_trunk_cluster_kernel<128>`: two CTAs a board), C = 256 on
     15x15 and 20x20, C = 192 on 15x15 and C = 136 on 16x16 (the wide
     entry, `convnext_trunk_wide_kernel<256>`: 1 to 8 CTAs a board, 129 to
     255 on zero channels), C = 384 on 15x15 and 20x20, C = 512 on 20x20,
     C = 300 on 16x16 and C = 1024 on 9x9 (the streamed entry,
     `csrc/convnext_trunk_streamed.cu`: 4 L + 1 launches a call, 300 on
     320 channels), each held within TRUNK_LIMITS of the plain trunk,
     block by block within BLOCK_LIMITS, a left-out bias rejected, and
     timed beside it, the library trunk (unpadded weights) and the bound
     (the trunk's own C), with the entry's occupancy (each kernel's for
     the streamed entry); then one simulation step each of the 20x20
     8x128, 8x256 and 8x384 networks (`SEARCH20_BATCH` boards), every
     trunk launch the cluster, wide or streamed entry's, and
     `SEARCH20_TIMED` warm steps timed after each; the seeded 8x256 and
     8x384 networks at the bench configuration: each trunk held and timed
     at B = 1280, `WIDE256_SIMS` / `WIDE384_SIMS` sims of its search
     (every trunk launch the wide / streamed entry's) and 5 steps traced;
     the launcher's engine with a seeded 8x256 and 8x384 network
     (`ProgramManager(blocks=8, filters=256 / 384)`, START 20, one TURN, a
     50-sim search at B = 1) answering an empty cell on the wide /
     streamed entry; and `vectorized.windows_at_many` and `pattern_types`
     on the card bit-equal to the CPU;
 25. tensor parallelism (last) - `tools/dryrun_multichip.py` at n = 2 as
     child processes on this one card over gloo with CUDA tensors, mesh
     (1, 2): the float32 flagship's column-parallel step held against the
     plain step on the card within tests/test_torch_distributed.py's
     constants, both timed; the flagship's bf16 train step on the
     reference's batch of 256 with the state placed over tp; one
     `make_rl_round` of a 2x16 network (8 sims, 48 moves; the trunk kernel
     at 16 channels padded to 64, score_backup), its launches on rank 0;
then a `kernels` JSON line and, last, {"ok": true, "device": {...}}.

A kernel's `ms` is its device time per launch: for score_scan on the
leaf-batch searches' rows (its main path) by CUDA events
around a CUDA graph of 20 launches (torch.profiler traced none of the
wide kernel's launches there), for score_backup as torch.profiler traces
it (on the flagship tree's paths), for the trunk (2.8 ms and more a launch) by CUDA
events around 20 launches back to back, where the host's time to enqueue
them hides behind the device's work.  `call_ms`, `plain_ms` and
`library_ms` are CUDA-event times of whole calls (median of 20), which
include the host's time to enqueue the work.  The searches' launch counts
are read around each search alone (`launches_by_path`); `launches` is the
flagship's.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from alphagomoku_tpu_torch.tools.profiling import kernel_device_ms, kernel_split_ms, profile_steps

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "runs" / "flagship_r4" / "checkpoint" / "network_23.msgpack"
BATCH = 1280
SIMS = 800  # flagship search
# the 8x128 search runs 200 sims: with every search at 800 the whole run
# passed 15 minutes, and the 8x128 path is the first to cut
WIDE_SIMS = 200  # 8x128 search
# the strength, loss-prover and renju searches run 50 sims (800 before the
# self-play phases came in, 200 before the engine phase came in, 100
# before the rest-of-search phase came in): with self-play at 8 moves the
# whole run took 1005 s at 400 and 843 s at 200 on an H100 80GB HBM3
# (700 W) whose host ran the self-play step at half the speed of another
# run's; at 100 with the zoo phase, 1,052 s on a slow host, and phase 22
# adds about a minute
STRENGTH_SIMS = 50  # strength (VCT leaf solver) search
LOSS_SIMS = 50  # strength search with the loss prover
RENJU_SIMS = 50  # renju search with the VCF leaf solver
CLUSTER_SIMS = 64  # renju search on the clustered boards, black to move
LOSS2_CPU_BOARDS = 32  # boards of the level-2 loss proof checked on the CPU
# self-play at the training manager's configuration (256 games, 100 sims,
# max_nodes 208, max_depth 32, VCT; tools/selfplay_generation.py), cut to
# SELFPLAY_MOVES of its 160 moves (23 to 38 s a move on the H100), played in
# chunks of SELFPLAY_CHUNK with a stop after the first chunk and a resume
# from the snapshot (4 moves in chunks of 2 until the training phase came
# in)
SELFPLAY_MOVES = 2
SELFPLAY_CHUNK = 1
# self-play to the end: the same with no leaf solver, TO_END_SIMS sims and
# a draw horizon TO_END_PLIES plies past the openings
TO_END_SIMS = 16
TO_END_PLIES = 12
WIDE_SEED = 0  # torch.Generator seed of the 8x128 network's weights
H = W = 15

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 CUDA-core
# FLOP/s, bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn` by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _counts() -> dict:
    """Every kernel wrapper's launch count, by the name the `kernels` line
    reads it under (the wide scan entries count with their wrappers)."""
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM

    return {"score_scan": SSM.score_scan.launches, "score_backup": SSM.score_backup.launches,
            "fused_trunk": CF.fused_trunk.launches,
            "fused_trunk_cluster": CF.fused_trunk.cluster_launches,
            "fused_trunk_wide": CF.fused_trunk.wide_launches,
            "fused_trunk_streamed": CF.fused_trunk.streamed_launches}


def _zero_counts() -> None:
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM

    SSM.score_scan.launches = SSM.score_backup.launches = 0
    CF.fused_trunk.launches = CF.fused_trunk.cluster_launches = CF.fused_trunk.wide_launches = 0
    CF.fused_trunk.streamed_launches = 0


def bench_boards(batch: int, seed: int = 0):
    """The bench position generator: 2-7 alternating stones per board."""
    import numpy as np

    rng = np.random.default_rng(seed)
    boards = np.zeros((batch, H, W), np.int8)
    for b in range(batch):
        n = rng.integers(2, 8)
        cells = rng.choice(H * W, size=n, replace=False)
        boards[b].flat[cells] = np.where(np.arange(n) % 2 == 0, 1, 2)
    return boards


def random_scan_inputs(R: int, D: int, K: int, seed: int):
    """The random packed-score generator of tests/test_ops.py."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def rand_scores(shape):
        pv = rng.choice([0, 1, 2, 2, 2, 3], size=shape)
        ev = rng.integers(-200, 200, size=shape)
        dist = rng.integers(0, 30, size=shape)
        ev = np.where(pv == 3, -dist, np.where(pv == 2, ev, dist))
        return ((pv << 13) | (4000 + ev)).astype(np.int32)

    start = rand_scores((R,))
    valid = np.sort(rng.random((R, D)) < 0.7, axis=1)[:, ::-1].copy()
    sl = rng.integers(0, K, size=(R, D)).astype(np.int32)
    es = rand_scores((R, D, K))
    ea = rng.random((R, D, K)) < 0.8
    ea[..., 0] = True
    comp = rng.random((R, D)) < 0.5
    ns = rand_scores((R, D))
    return start, valid, sl, es, ea, comp, ns


def random_backup_inputs(B: int, N: int, D: int, K: int, seed: int):
    """Trees of B boards with N nodes of K edge slots and one path of D
    levels per board, from `random_scan_inputs`' generator (as
    tests/test_torch_score_backup.py makes them): the tree's rows are its
    [B, N(, K)] draws, inactive slots get NULL actions, the path takes
    distinct nodes up to its valid prefix and its `sl` as slots."""
    import numpy as np

    start, valid, sl, _, _, _, _ = random_scan_inputs(B, D, K, seed)
    _, _, _, es, ea, comp, ns = random_scan_inputs(B, N, K, seed + 1000)
    rng = np.random.default_rng(seed + 2000)
    actions = np.where(ea, rng.integers(0, H * W, size=ea.shape), -1).astype(np.int32)
    nodes = np.argsort(rng.random((B, N)), axis=1)[:, :D]
    pn = np.where(valid, nodes, -1).astype(np.int64)
    ps = np.where(valid, sl, -1).astype(np.int64)
    return dict(edge_score=es, edge_action=actions, node_complete=comp, node_score=ns, pn=pn,
                ps=ps, start_score=start)


def most_visited_paths(tree, depth: int):
    """Paths [B, depth] (pn, ps; -1 past the path) from each root down the
    most-visited expanded edge, and the score of the node each ends at."""
    import torch

    rb = torch.arange(tree.batch, device=tree.node_score.device)
    cur = torch.zeros_like(rb)
    alive = torch.ones_like(rb, dtype=torch.bool)
    pn = torch.full((tree.batch, depth), -1, dtype=torch.int64, device=rb.device)
    ps = torch.full_like(pn, -1)
    for d in range(depth):
        child = tree.edge_child[rb, cur].long()
        visits = torch.where(child >= 0, tree.node_visits[rb[:, None], child.clamp(min=0)], -1)
        slot = visits.argmax(-1)
        alive &= visits.amax(-1) > 0
        pn[:, d] = torch.where(alive, cur, -1)
        ps[:, d] = torch.where(alive, slot, -1)
        cur = torch.where(alive, child[rb, slot], cur)
    return pn, ps, tree.node_score[rb, cur]


def backup_bytes(pn, K: int) -> int:
    """The bytes score_backup must move at the port's int32 storage: per
    path pn and ps (int64) and the start score; per valid level the edge
    score and action rows, the node's complete flag and score, and the
    two 4-byte writes."""
    levels = int((pn != -1).sum())
    return pn.shape[0] * (2 * 8 * pn.shape[1] + 4) + levels * (2 * 4 * K + 1 + 4 + 2 * 4)


BACKUP_ARGS = ("edge_score", "edge_action", "node_complete", "node_score", "pn", "ps",
               "start_score")


def backup_check(tree: dict, tag: str):
    """score_backup against score_backup_plain on clones of `tree` (a dict
    of its seven arguments), the whole trees bit-equal.  Returns the
    kernel's arguments (the clones it updated) and the count of scores it
    changed."""
    import torch
    from alphagomoku_tpu_torch.ops import score_scan as SSM

    names = BACKUP_ARGS
    kernel_tree = {k: tree[k].clone() for k in names}
    plain_tree = {k: tree[k].clone() for k in names}
    SSM.score_backup(*(kernel_tree[k] for k in names))
    SSM.score_backup_plain(*(plain_tree[k] for k in names))
    torch.cuda.synchronize()
    differ = [k for k in names if not torch.equal(kernel_tree[k], plain_tree[k])]
    if differ:
        raise SystemExit(f"{tag}: kernel disagrees with the plain version in {differ}")
    changed = int((plain_tree["edge_score"] != tree["edge_score"]).sum()
                  + (plain_tree["node_score"] != tree["node_score"]).sum())
    return [kernel_tree[k] for k in names], changed


def backup_phase(tree: dict, tag: str, kernel: str = "score_backup_kernel",
                 plain_reps: int = 20) -> dict:
    """`backup_check`, then score_backup's device time (of `kernel`) with
    the rows in L2 and after a 128 MB write that evicts them, its call and
    plain times (the plain one over `plain_reps` calls), and its bytes
    bound at this input's valid levels and at full depth."""
    import torch
    from alphagomoku_tpu_torch.ops import score_scan as SSM

    args, changed = backup_check(tree, tag)
    flush = torch.empty(32 << 20, dtype=torch.int32, device=args[0].device)
    ms = kernel_device_ms(lambda: SSM.score_backup(*args), kernel)
    cold_ms = kernel_device_ms(lambda: (flush.zero_(), SSM.score_backup(*args)), kernel)
    call_ms = time_cuda(lambda: SSM.score_backup(*args))
    plain_ms = time_cuda(lambda: SSM.score_backup_plain(*args), reps=plain_reps,
                         warmup=min(3, plain_reps))
    pn, K = tree["pn"], tree["edge_score"].shape[2]
    nbytes = backup_bytes(pn, K)
    full_bytes = backup_bytes(torch.zeros_like(pn), K)
    bound_ms = nbytes / HBM_BPS * 1e3
    bound_full_ms = full_bytes / HBM_BPS * 1e3
    B, N, _ = tree["edge_score"].shape
    levels = int((pn != -1).sum())
    print(f"{tag}: bit-equal at B={B} N={N} D={pn.shape[1]} K={K} ({levels} valid levels, "
          f"{changed} scores changed); kernel {ms:.5f} ms on the device with the rows in L2, "
          f"{cold_ms:.5f} ms after evicting them ({call_ms:.4f} ms a call), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms at these valid levels ({nbytes} bytes), "
          f"{bound_full_ms:.5f} ms at full depth ({full_bytes} bytes)", flush=True)
    return dict(ms=ms, cold_ms=cold_ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_full_depth_ms=bound_full_ms, valid_levels=levels, changed=changed)


def library_trunk(x, tw):
    """The fused trunk's function through PyTorch's library calls (bf16
    depthwise conv2d + matmul), with weights `tw` of the input's own width
    (`unpadded`): a yardstick, never used by the port."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    c = x.shape[-1]
    for l in range(tw.dw.shape[0]):
        xn = x.permute(0, 3, 1, 2)
        y = F.conv2d(xn, tw.dw[l].permute(2, 0, 1)[:, None], padding=3, groups=c)
        y = (y.float() * tw.bn_s[l][:, None, None] + tw.bn_t[l][:, None, None]).to(bf)
        y = y.permute(0, 2, 3, 1)
        y1 = torch.relu(torch.matmul(y, tw.w1[l]).float() + tw.b1[l]).to(bf)
        y2 = (torch.matmul(y1, tw.w2[l]).float() + tw.b2[l]).to(bf)
        x4 = y2 + x
        z = x4.float().mean(dim=(1, 2)).to(bf)
        h1 = torch.relu(torch.matmul(z, tw.sw1[l]).float() + tw.sb1[l]).to(bf)
        g = torch.sigmoid(torch.matmul(h1, tw.sw2[l]).float() + tw.sb2[l]).to(bf)
        x = x4 * g[:, None, None, :]
    return x


def unpadded(tw, c: int):
    """Trunk weights cut back to their first `c` channels: the unpadded
    weights of a C-filter trunk that `pack_trunk_weights` padded on the
    card (the cut channels are zeros)."""
    from alphagomoku_tpu_torch.ops import convnext_fused as CF

    return CF.TrunkWeights(*((t[..., :c] if t.dim() != 3 else t[:, :c, :c]).contiguous()
                             for t in tw))


def held(ref, out, limits: dict) -> dict:
    """`utils.bf16.agreement` of a kernel's result with its plain version's
    under `limits`; `ok` also needs tests/test_ops.py's bf16 rule,
    max |a - b| <= 0.05 * max|a| + 5e-3."""
    from alphagomoku_tpu_torch.utils.bf16 import agreement

    stats = agreement(ref, out, **limits)
    stats["abs_ok"] = stats["max_abs_err"] <= 0.05 * max(1e-3, stats["max_abs_ref"]) + 5e-3
    stats["ok"] &= stats["abs_ok"]
    return stats


def describe(stats: dict) -> str:
    lim = stats["limits"]
    return (f"share differing {stats['share_differ']:.4g} (limit {lim['max_share_differ']:g}), "
            f"over {lim['max_ulps']:g} ulps {stats['share_over']:.4g} "
            f"(limit {lim['max_share_over']:g}), max abs err {stats['max_abs_err']:.4g}, "
            f"median |ref| {stats['median_abs_ref']:.4g}")


def without_last(tw, name: str):
    """Trunk weights with the last block's `name` (a bias) set to 0."""
    t = getattr(tw, name).clone()
    t[-1] = 0
    return tw._replace(**{name: t})


# steps traced by each profile phase
PROFILE_STEPS = 5


def trunk_phase(net, planes, tag: str, plain_reps: int = 5) -> dict:
    """The trunk kernel against `fused_trunk_plain` on the stem output of
    `planes`: all blocks, each block alone, kernels fed a bias left out
    (which must be rejected), timings (the plain trunk's median of
    `plain_reps` calls), the library yardstick and the bound.  Returns the
    trunk's `kernels` entry at this width."""
    import torch
    from alphagomoku_tpu_torch.ops import convnext_fused as CF

    tw = CF.pack_trunk_weights(net)
    with torch.no_grad():
        x = net.stem_forward(planes).permute(0, 2, 3, 1).contiguous()
        out_p = CF.fused_trunk_plain(x, tw)
        trunk = held(out_p, CF.fused_trunk(x, tw), CF.TRUNK_LIMITS)
        if not trunk["ok"]:
            raise SystemExit(f"{tag}: kernel disagrees with the plain version: {trunk}")
        # each block alone (L = 1), from the plain trunk's input to it
        blocks, xl = [], x
        for l in range(tw.dw.shape[0]):
            wl = CF.TrunkWeights(*(t[l:l + 1].contiguous() for t in tw))
            ref_l = CF.fused_trunk_plain(xl, wl)
            blocks.append(held(ref_l, CF.fused_trunk(xl, wl), CF.BLOCK_LIMITS))
            xl = ref_l
        if not all(b["ok"] for b in blocks):
            raise SystemExit(f"{tag}: a block disagrees with the plain version: {blocks}")
        worst = max(blocks, key=lambda b: b["share_differ"])
        # the check has to reject a kernel that leaves out a bias: the
        # kernel fed the weights without the last block's b2 or BN shift
        faults = {name: held(out_p, CF.fused_trunk(x, without_last(tw, name)), CF.TRUNK_LIMITS)
                  for name in ("b2", "bn_t")}
        if any(f["ok"] for f in faults.values()):
            raise SystemExit(f"{tag}: the check passed a kernel without a bias: {faults}")
        print(f"{tag} check: all {len(blocks)} blocks: {describe(trunk)}; block by block, "
              f"the worst: {describe(worst)}; without the last block's "
              + ", ".join(f"{n}: share differing {f['share_differ']:.4g}, rejected"
                          for n, f in faults.items()), flush=True)
        trunk_ms = time_cuda(lambda: [CF.fused_trunk(x, tw) for _ in range(20)], reps=3) / 20
        trunk_call_ms = time_cuda(lambda: CF.fused_trunk(x, tw))
        trunk_plain_ms = time_cuda(lambda: CF.fused_trunk_plain(x, tw), reps=plain_reps,
                                   warmup=min(3, plain_reps))
        # the library computes the C-filter function: no padded channels
        tw_c = unpadded(tw, x.shape[-1])
        lib_out = library_trunk(x, tw_c)
        trunk_lib_ms = time_cuda(lambda: library_trunk(x, tw_c))
    L, (B, h, w, C) = tw.dw.shape[0], x.shape
    occ = CF.trunk_occupancy(C, h, w)
    split = None
    if occ["entry"] == "convnext_trunk_streamed":
        # the streamed entry's device time by kernel: 3 calls traced, L
        # launches of each kernel a call (1 of the scale)
        with torch.no_grad():
            split = kernel_split_ms(lambda: CF.fused_trunk(x, tw),
                                    list(CF.STREAMED_NAMES.values()))
        print(f"{tag} by kernel (device ms a launch, launches traced of {3 * tw.dw.shape[0]}, "
              "3 of the scale): " + "; ".join(
                  f"{k} " + (f"{v['ms_per_launch']:.4f} ms" if v["traced"] else "not traced")
                  + f", {v['traced']}" for k, v in split.items()), flush=True)
    print(f"{tag} occupancy: C={C} {h}x{w}: {occ['entry']} at width {occ['width']}, "
          f"{occ['registers']} registers per thread, {occ['ctas_per_sm']} CTAs per SM"
          + (f" ({occ['clusters']} clusters of {occ['ctas']} at once)" if occ["clusters"]
             else "")
          + f", {occ['smem_bytes']} bytes of shared memory per CTA, {occ['local_bytes']} bytes "
          "of local memory (spills) per thread"
          + (f"; by kernel {occ['kernels']}" if "kernels" in occ else ""), flush=True)
    # the bound of the trunk's own function, at its C (a padded width's
    # extra channels are the kernel's cost, not the function's work)
    dw_flops = 2.0 * 49 * h * w * C * B * L
    mm_flops = (2.0 * 2 * h * w * C * C + 2.0 * 2 * C * C) * B * L
    trunk_bytes = 2 * x.numel() * x.element_size() + L * (49 * C * 2 + 4 * C * C * 2 + 6 * C * 4)
    ops_ms = (dw_flops / F32_FLOPS + mm_flops / BF16_TC_FLOPS) * 1e3
    bytes_ms = trunk_bytes / HBM_BPS * 1e3
    trunk_bound_ms = max(ops_ms, bytes_ms)
    lib = held(out_p, lib_out, CF.TRUNK_LIMITS)
    print(f"{tag}: C={C} L={L} B={B} {h}x{w}; library trunk {describe(lib)}; kernel "
          f"{trunk_ms:.4f} ms on the device ({trunk_call_ms:.4f} ms a call), "
          f"plain {trunk_plain_ms:.4f} ms, library {trunk_lib_ms:.4f} ms, bound "
          f"{trunk_bound_ms:.4f} ms (ops {ops_ms:.4f}: {dw_flops / 1e9:.2f} GFLOP depthwise "
          f"f32 + {mm_flops / 1e9:.2f} GFLOP products bf16; bytes {bytes_ms:.4f})", flush=True)
    return dict(
        status="within limits", max_abs_err=trunk["max_abs_err"],
        share_differ=trunk["share_differ"], share_over_2ulps=trunk["share_over"], ms=trunk_ms,
        call_ms=trunk_call_ms, plain_ms=trunk_plain_ms, bound_ms=trunk_bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=trunk_lib_ms,
        **occ, **({"kernel_split": split} if split else {}),
    )


def network_phase(weights, planes, tag: str) -> None:
    """The fused forward (kernel trunk) against the plain-trunk forward,
    head by head under HEAD_LIMITS, and the rejection of the forward
    without the last b2."""
    from alphagomoku_tpu_torch.ops import convnext_fused as CF

    heads = ("policy_logits", "value_logits", "q_logits", "moves_left_logits")
    net_k = CF.fused_apply(weights, planes)
    net_p = CF.fused_apply(weights, planes, trunk=CF.fused_trunk_plain)
    net_f = CF.fused_apply(CF.FusedWeights(weights.net, without_last(weights.trunk, "b2")),
                           planes)
    for name in heads:
        ref = getattr(net_p, name)
        head = held(ref, getattr(net_k, name), CF.HEAD_LIMITS)
        fault = held(ref, getattr(net_f, name), CF.HEAD_LIMITS)
        print(f"{tag}: {name} {tuple(ref.shape)} at B={BATCH}, fused forward vs the "
              f"plain-trunk forward: {describe(head)}, ulps of at least "
              f"{CF.HEAD_LIMITS['floor']:g}; without the last block's b2: share differing "
              f"{fault['share_differ']:.4g}, max abs err {fault['max_abs_err']:.4g}, "
              f"{'PASSED' if fault['ok'] else 'rejected'}", flush=True)
        if not head["ok"]:
            raise SystemExit(f"{tag}: {name} disagrees with the plain-trunk forward: {head}")
        if fault["ok"]:
            raise SystemExit(f"{tag}: the check passed {name} without the last b2: {fault}")


def search_phase(weights, tables, cfg, boards, stm, sims: int, tag: str, net_apply=None,
                 trunk_launches=None, raw_input: bool = True, trunk_entry: str | None = None,
                 **search_kw):
    """One `run_search` of `sims` simulations (through `net_apply`, by
    default `fused_apply`; `search_kw` passed on) with the kernels' launch
    counts set to 0 just before it and read just after: backup B once a
    step (score_backup at leaf_batch 1, score_scan through
    score_backup_paths above it), the trunk `trunk_launches` times (by
    default once a step and once for the roots), and as many times the
    count of the entry named by `trunk_entry` ("fused_trunk_cluster",
    "fused_trunk_wide" or "fused_trunk_streamed"; the other entries'
    counts 0); the search's invariants; a line with sims/s and launches per
    step.  Returns the final state and the launch counts."""
    import torch
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM
    from alphagomoku_tpu_torch.search import mcts
    from alphagomoku_tpu_torch.search import score as S

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = mcts.run_search(net_apply or CF.fused_apply, weights, tables, cfg, boards, stm,
                            sims, raw_input, device=boards.device, **search_kw)
    move = mcts.select_move(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    steps = -(-sims // cfg.leaf_batch)
    trunk = steps + 1 if trunk_launches is None else trunk_launches
    batched = cfg.leaf_batch > 1
    if launches != {"score_scan": steps if batched else 0,
                    "score_backup": 0 if batched else steps, "fused_trunk": trunk,
                    "fused_trunk_cluster": trunk if trunk_entry == "fused_trunk_cluster" else 0,
                    "fused_trunk_wide": trunk if trunk_entry == "fused_trunk_wide" else 0,
                    "fused_trunk_streamed": trunk if trunk_entry == "fused_trunk_streamed" else 0}:
        raise SystemExit(f"{tag}: the kernels were not launched once per step inside "
                         f"run_search: {launches}")
    tree = state.tree
    root_visits = tree.node_visits[:, 0]
    root_proven = S.is_proven(tree.node_score[:, 0])
    if not bool(((root_visits == 1 + steps * cfg.leaf_batch) | root_proven).all()):
        raise SystemExit(f"{tag}: an unproven root does not hold 1 + sims visits")
    if int(tree.node_count.max()) > cfg.max_nodes:
        raise SystemExit(f"{tag}: node_count exceeds max_nodes")
    if not bool((boards.reshape(boards.shape[0], -1).gather(1, move[:, None]) == 0).all()):
        raise SystemExit(f"{tag}: select_move chose an occupied cell")
    if not bool(torch.isfinite(mcts.root_value(state)).all()):
        raise SystemExit(f"{tag}: non-finite root value")
    summary = state.stats.summary(state.sims_done)
    root = tree.node_score[:, 0]
    bsz = boards.shape[0]
    print(f"{tag}: {sims} sims x batch {bsz} in {dt:.3f} s = {bsz * sims / dt:.1f} sims/s, "
          f"{dt / steps * 1e3:.3f} ms per simulation step of {cfg.leaf_batch} a tree; launches "
          f"{launches}, {sum(launches.values()) / steps:.4f} of the kernels per step; "
          f"proven roots {int(root_proven.sum())} (won {int(S.is_win(root).sum())}, lost "
          f"{int(S.is_loss(root).sum())}); node_count {int(tree.node_count.max())}; "
          f"avg depth {summary['avg_depth']:.3f}, transpositions {summary['transpositions']:.0f}, "
          f"solver-proven leaves {summary['solver_wins']:.0f} won, "
          f"{summary['solver_losses']:.0f} lost", flush=True)
    return state, launches


def renju_search_phase(weights, renju, cfg, boards, stm, sims: int, tag: str,
                       need_forbidden: bool):
    """`search_phase` under renju, through a `fused_apply` that also sums,
    on the device, the cells that feature bit 6 (raw plane 6) marks in the
    positions the search evaluates; then the gate: no move chosen for black
    lies on a cell that the root's bit 6 marks.  With `need_forbidden` the
    roots must hold such cells, or the gate would check nothing.  Returns
    the final state and the launch counts."""
    import torch
    from alphagomoku_tpu_torch.game import vectorized as V
    from alphagomoku_tpu_torch.game.types import CROSS
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.patterns import features as FEAT
    from alphagomoku_tpu_torch.search import mcts

    plane, residual = V.forbidden_plane_u(renju, boards)
    bit6 = ((FEAT.encode(renju, boards, stm) >> 6) & 1).reshape(boards.shape[0], -1) == 1
    root_cells = int(bit6.sum())
    print(f"{tag}: the roots hold {int(plane.sum())} forbidden cells for black, residual "
          f"{int(residual.sum())}; bit 6 marks {root_cells} cells on "
          f"{int(bit6.any(1).sum())} roots with black to move", flush=True)
    if need_forbidden and root_cells == 0:
        raise SystemExit(f"{tag}: no root cell is marked forbidden; the gate checks nothing")
    seen = torch.zeros(2, dtype=torch.int64, device=boards.device)

    def counting_apply(variables, planes):
        forb = planes[..., 6] > 0
        seen.add_(torch.stack((forb.sum(), forb.any(2).any(1).sum())))
        return CF.fused_apply(variables, planes)

    V.host_gate.syncs = 0
    state, launches = search_phase(weights, renju, cfg, boards, stm, sims, tag, counting_apply)
    gate_syncs = V.host_gate.syncs / sims
    move = mcts.select_move(state)
    on_forbidden = bit6.gather(1, move[:, None])[:, 0] & (stm == CROSS)
    if bool(on_forbidden.any()):
        raise SystemExit(f"{tag}: {int(on_forbidden.sum())} moves chosen for black on cells the "
                         f"root's bit 6 marks forbidden")
    print(f"{tag}: bit 6 marked {int(seen[0])} cells in {int(seen[1])} of the evaluated "
          f"positions; host gates {gate_syncs:.3f} syncs per step; no move chosen for black on "
          f"a forbidden cell", flush=True)
    return state, launches


def clustered_boards(n: int, seed: int = 7):
    """Black-heavy random-walk clusters of 8 to 29 stones around the
    center (the generator of tests/test_torch_renju.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    boards = np.zeros((n, H, W), np.int8)
    for i in range(n):
        r, c = H // 2, W // 2
        for s in range(rng.integers(8, 30)):
            boards[i, r, c] = 1 if s % 3 != 2 else 2
            r = int(np.clip(r + rng.integers(-2, 3), 0, H - 1))
            c = int(np.clip(c + rng.integers(-2, 3), 0, W - 1))
    return boards


def solvers_phase(tables) -> None:
    """forbidden_plane_u, the VCT and VCF solves and solve_loss(levels=2)
    on BATCH clustered renju boards on the card, each bit-equal to the same
    function on CPU copies, at the search's root budgets (the loss proof
    at the leaves' 16 steps)."""
    import torch
    from alphagomoku_tpu_torch.game import vectorized as V
    from alphagomoku_tpu_torch.search import vcf, vct_batched

    cpu_b = torch.from_numpy(clustered_boards(BATCH))
    cpu_s = torch.where(torch.arange(BATCH) % 2 == 0, 1, 2).to(torch.int8)
    dev_b, dev_s = cpu_b.cuda(), cpu_s.cuda()
    runs = [  # name, function, boards checked on the CPU, what its first output counts
        ("forbidden_plane_u", lambda b, s: V.forbidden_plane_u(tables, b), BATCH,
         "forbidden cells"),
        ("vct_batched.solve", lambda b, s: vct_batched.solve(tables, b, s, max_depth=6,
                                                             max_steps=64, max_threes=2), BATCH,
         "proven wins"),
        ("vcf.solve", lambda b, s: vcf.solve(tables, b, s, max_depth=6, max_steps=64), BATCH,
         "proven wins"),
        ("solve_loss(levels=2)", lambda b, s: vct_batched.solve_loss(
            tables, b, s, max_options=8, max_depth=6, max_steps=16, max_threes=2, levels=2),
         LOSS2_CPU_BOARDS, "proven losses"),
    ]
    for name, fn, n_cpu, what in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = [t.cpu() for t in fn(dev_b, dev_s)]
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = fn(cpu_b[:n_cpu], cpu_s[:n_cpu])
        cpu_s_ = time.perf_counter() - t0
        for a, b in zip(card, host):
            if not torch.equal(a[:n_cpu], b):
                raise SystemExit(f"solvers renju: {name} on the card differs from the CPU")
        extra = (f", residual {int(card[1].sum())} cells" if name == "forbidden_plane_u" else "")
        print(f"solvers renju: {name} on {BATCH} boards: {card_s:.3f} s on the card, bit-equal "
              f"to the CPU's on {n_cpu} boards ({cpu_s_:.3f} s); {int(card[0].sum())} {what}"
              f"{extra}", flush=True)


class MoveChecks:
    """`play_games_resumable`'s `on_move` hook: after each searched move,
    the search's gates (node_count <= max_nodes, `sims` simulations on
    every tree, at least 1 + `sims` visits on every unproven root, the
    noisy root priors summing to 1 over the valid edges, and the lanes
    reused being those the reuse rule picks from the previous move: its
    move a root edge with an expanded child, and the tree with room for
    `reserve` more nodes), the move's wall time and the share of lanes
    reused."""

    def __init__(self, tag: str, mcfg, scfg):
        self.tag, self.mcfg, self.scfg = tag, mcfg, scfg
        self.seconds, self.reused = [], []
        self.prev = self.last = None

    def start(self) -> None:
        """Before a play call: its first move reuses nothing."""
        import torch

        torch.cuda.synchronize()
        self.t = time.perf_counter()
        self.prev = None

    def fail(self, what: str):
        raise SystemExit(f"{self.tag}: move {len(self.seconds)}: {what}")

    def __call__(self, _, carry) -> None:
        import torch
        from alphagomoku_tpu_torch.search import mcts
        from alphagomoku_tpu_torch.search import score as S

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds.append(now - self.t)
        self.t = now
        st, sims = carry.search, self.scfg.num_simulations
        tree = st.tree
        rb = torch.arange(tree.batch, device=st.root_node.device)
        if int(tree.node_count.max()) > self.mcfg.max_nodes:
            self.fail("node_count exceeds max_nodes")
        if not bool((st.sims_done == sims).all()):
            self.fail(f"a tree did not run {sims} simulations")
        proven = S.is_proven(tree.node_score[rb, st.root_node])
        if not bool(((tree.node_visits[rb, st.root_node] >= 1 + sims) | proven).all()):
            self.fail("an unproven root holds fewer than 1 + sims visits")
        valid = tree.edge_action[rb, st.root_node] != mcts.NULL
        total = torch.where(valid, st.noisy_prior, 0.0).sum(-1)
        if not bool((((total - 1).abs() <= 1e-5) | ~valid.any(-1)).all()):
            self.fail("the noisy root priors do not sum to 1 over the valid edges")
        reused = st.root_node > 0
        expected = torch.zeros_like(reused)
        if self.prev is not None:
            prev, move = self.prev.search, self.prev.prev_move.long()
            hit = prev.tree.edge_action[rb, prev.root_node] == move[:, None]
            child = prev.tree.edge_child[rb, prev.root_node, hit.int().argmax(-1)]
            room = prev.tree.node_count + sims + 8 <= prev.tree.capacity
            expected = hit.any(-1) & (child >= 0) & room
        if not torch.equal(reused, expected):
            self.fail("the lanes reused are not those the reuse rule picks")
        self.reused.append(float(reused.float().mean()))
        self.prev = self.last = carry


def check_games(tag: str, env0, result, tables, draw_after: int) -> None:
    """Every move recorded for a live game lies on an empty cell; the
    recorded moves replayed through `env_step` on the CPU from the
    openings give the recorded boards, outcomes and game lengths bit for
    bit; the game lengths count the stones on the final boards.  (`tables`
    holds no tensors: its functions build what they need on the device of
    their inputs.)"""
    import torch
    from alphagomoku_tpu_torch.game import vectorized as V

    rec = result.record
    cell = rec.board.flatten(2).gather(2, rec.move.long()[..., None])[..., 0]
    if not bool((cell[rec.alive] == 0).all()):
        raise SystemExit(f"{tag}: a move recorded for a live game lies on an occupied cell")
    env = V.EnvState(*[t.cpu() for t in env0])
    boards, moves = rec.board.cpu(), rec.move.cpu().long()
    for m in range(moves.shape[0]):
        if not torch.equal(env.board, boards[m]):
            raise SystemExit(f"{tag}: the CPU replay's board before move {m} differs")
        env = V.env_step(tables, env, moves[m] // W, moves[m] % W, draw_after=draw_after)
    if not (torch.equal(env.outcome, result.outcome.cpu())
            and torch.equal(env.move_count, result.game_length.cpu())):
        raise SystemExit(f"{tag}: the CPU replay's outcomes or game lengths differ")
    if not torch.equal(env.move_count, (env.board != 0).sum((1, 2)).int()):
        raise SystemExit(f"{tag}: move_count differs from the stones on the board")


def selfplay_run(tag, weights, tables, mcfg, scfg, chunk: int, stop_after_first: bool):
    """Balanced openings and `play_games_resumable` from a seeded
    generator on the card, with the kernels' launch counts set to 0 just
    before and read just after, `MoveChecks` on every move and the launch
    gate (score_backup once a step; the trunk once a step, once a move for
    the fresh roots, once for the openings and once per call for the first
    roots); with `stop_after_first`, stopped after the first chunk and
    resumed from the snapshot.  Returns the openings' env, the result, the
    checks, the launch counts and the seconds (openings, games)."""
    import torch
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM
    from alphagomoku_tpu_torch.selfplay import play_games_resumable
    from alphagomoku_tpu_torch.tools import selfplay_generation as SG

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    snap = ROOT / "build" / "chip_smoke" / f"{tag.replace(' ', '_')}_snapshot.npz"
    snap.parent.mkdir(parents=True, exist_ok=True)
    snap.unlink(missing_ok=True)
    checks = MoveChecks(tag, mcfg, scfg)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env0 = SG.balanced_openings(weights, tables, gen, SG.GAMES)
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t0

    def run(stop):
        checks.start()
        return play_games_resumable(
            CF.fused_apply, weights, tables, mcfg, scfg, gen, SG.GAMES, H, W,
            chunk_moves=chunk, should_stop=stop, snapshot_path=str(snap), init_env=env0,
            on_move=checks, device=dev)

    calls = 1
    if stop_after_first:
        if run(lambda: True) is not None or not snap.exists():
            raise SystemExit(f"{tag}: the run did not stop with a snapshot after its first chunk")
        calls = 2
    result = run(None)
    torch.cuda.synchronize()
    t_games = time.perf_counter() - t0 - t_open
    launches = _counts()
    moves, sims = len(checks.seconds), scfg.num_simulations
    want = {"score_scan": 0, "score_backup": moves * sims,
            "fused_trunk": moves * (sims + 1) + 1 + calls, "fused_trunk_cluster": 0,
            "fused_trunk_wide": 0, "fused_trunk_streamed": 0}
    if result is None or snap.exists() or launches != want:
        raise SystemExit(f"{tag}: launches {launches}, expected {want} for {moves} moves "
                         f"searched, or the run did not finish")
    check_games(tag, env0, result, tables, scfg.draw_after)
    return env0, result, checks, launches, (t_open, t_games)


def selfplay_summary(tag, result, checks, launches, seconds, sims: int) -> str:
    """The line of a self-play phase: times per move and step, the lanes
    reused per move, the games finished and the launches."""
    from alphagomoku_tpu_torch.game.types import GameOutcome

    moves = len(checks.seconds)
    ms_move = 1e3 * seconds[1] / moves
    finished = int((result.outcome != int(GameOutcome.UNKNOWN)).sum())
    return (f"{tag}: {len(result.outcome)} games, {moves} moves searched at {sims} sims: openings "
            f"{seconds[0]:.3f} s, games {seconds[1]:.3f} s = {ms_move:.3f} ms per move, "
            f"{ms_move / sims:.3f} ms per simulation step (median move "
            f"{1e3 * statistics.median(checks.seconds):.3f} ms); lanes reused per move "
            f"{[round(r, 4) for r in checks.reused]}; games finished {finished}; launches "
            f"{launches}, {sum(launches.values()) / (moves * sims):.4f} of the kernels per step")


def selfplay_phases(weights, tables, paths: dict) -> dict:
    """Self-play at the training manager's configuration, cut to
    SELFPLAY_MOVES moves, stopped and resumed, with the kernels held
    against their plain versions at its shapes (the trunk at its batch,
    score_backup on its last tree's paths of max_depth 32, the
    `score_backup_kernel<32>` instantiation); then self-play to the end
    (no leaf solver, TO_END_SIMS sims, a draw horizon TO_END_PLIES plies on)
    with its targets, a replay-buffer round trip and the gate that tree
    reuse took place from the second move on.  Returns `backup_phase`'s
    dict for the self-play tree and the to-the-end generation's targets,
    the replay window of phase 19."""
    import numpy as np
    import torch
    from alphagomoku_tpu_torch.data import ReplayBuffer
    from alphagomoku_tpu_torch.game.types import GameOutcome
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.patterns import features as FEAT
    from alphagomoku_tpu_torch.search import mcts
    from alphagomoku_tpu_torch.selfplay import make_targets
    from alphagomoku_tpu_torch.tools import selfplay_generation as SG

    mcfg, scfg = SG.manager_configs(max_moves=SELFPLAY_MOVES)
    _, result, checks, paths["selfplay"], seconds = selfplay_run(
        "selfplay", weights, tables, mcfg, scfg, SELFPLAY_CHUNK, stop_after_first=True)
    print(selfplay_summary("selfplay", result, checks, paths["selfplay"], seconds,
                           scfg.num_simulations), flush=True)
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, mcfg)
    profile = profile_steps(simulate, weights, checks.last.search, PROFILE_STEPS)
    print(profile.replace("profile:", "profile selfplay:"), flush=True)
    kernel_ms = json.loads(profile.removeprefix("profile: "))["traced_ms_per_launch"]
    st = checks.last.search
    planes = FEAT.unpack_raw_planes(FEAT.encode(tables, st.root_board, st.root_stm))
    with torch.no_grad():
        x = weights.net.stem_forward(planes).permute(0, 2, 3, 1).contiguous()
        trunk = held(CF.fused_trunk_plain(x, weights.trunk), CF.fused_trunk(x, weights.trunk),
                     CF.TRUNK_LIMITS)
    if not trunk["ok"]:
        raise SystemExit(f"selfplay: the trunk kernel disagrees with the plain version at "
                         f"batch {x.shape[0]}: {trunk}")
    print(f"selfplay: trunk kernel at B={x.shape[0]} on the last move's roots: "
          f"{describe(trunk)}", flush=True)
    # half the paths start from their leaf's score, half from the random
    # generator's proven and unknown scores, as on the flagship tree; the
    # kernel's device time is the traced self-play steps' (a profiler
    # run of 20 lone launches after the big traces caught none)
    pn, ps, leaf_score = most_visited_paths(st.tree, mcfg.max_depth)
    games, K = leaf_score.shape[0], st.tree.edge_score.shape[2]
    rand_start = torch.from_numpy(random_scan_inputs(games, 1, K, seed=3)[0]).to(pn.device)
    start = torch.where(torch.arange(games, device=pn.device) % 2 == 0, leaf_score, rand_start)
    _, changed = backup_check(dict(
        edge_score=st.tree.edge_score, edge_action=st.tree.edge_action,
        node_complete=st.tree.node_complete, node_score=st.tree.node_score, pn=pn, ps=ps,
        start_score=start), "score_backup on the self-play tree")
    levels = int((pn != -1).sum())
    backup = dict(ms=kernel_ms["score_backup_kernel"],
                  bound_ms=backup_bytes(pn, K) / HBM_BPS * 1e3,
                  bound_full_depth_ms=backup_bytes(torch.zeros_like(pn), K) / HBM_BPS * 1e3,
                  valid_levels=levels, changed=changed, trunk_ms=kernel_ms["convnext_trunk"])
    print(f"score_backup on the self-play tree: bit-equal at B={games} N={st.tree.capacity} "
          f"D={pn.shape[1]} K={K} ({levels} valid levels, {changed} scores changed); in the "
          f"traced self-play steps {backup['ms']:.5f} ms a launch on the device (the trunk at "
          f"B={games} {backup['trunk_ms']:.4f} ms), bound {backup['bound_ms']:.5f} ms at these "
          f"valid levels, {backup['bound_full_depth_ms']:.5f} ms at full depth", flush=True)
    del result, checks, simulate, st, planes, x, pn, ps, leaf_score, start

    # to the end: every game ends within TO_END_PLIES plies; max_nodes
    # stays at the manager's 208 (its formula at 16 sims, 40, leaves no
    # room to reuse)
    mcfg, scfg = SG.manager_configs(TO_END_SIMS, max_nodes=2 * SG.SIMS + 8, leaf_solver="none")
    scfg = scfg._replace(draw_after=SG.OPENING_STONES + TO_END_PLIES)
    _, result, checks, paths["selfplay_to_end"], seconds = selfplay_run(
        "selfplay to the end", weights, tables, mcfg, scfg, SG.CHUNK_MOVES,
        stop_after_first=False)
    print(selfplay_summary("selfplay to the end", result, checks, paths["selfplay_to_end"],
                           seconds, TO_END_SIMS), flush=True)
    if not bool((result.outcome != int(GameOutcome.UNKNOWN)).all()):
        raise SystemExit("selfplay to the end: a game has no final outcome")
    if not all(r > 0 for r in checks.reused[1:]):
        raise SystemExit("selfplay to the end: no lane reused its tree at a move after the first")
    targets = make_targets(result, H * W)
    valid = targets["valid"]
    wdl = targets["value_wdl"][valid]
    if not bool(valid.any()) or not bool((wdl.sum(-1) == 1).all()):
        raise SystemExit("selfplay to the end: no valid sample, or a value_wdl row not summing "
                         "to 1")
    buffer, again = ReplayBuffer(), ReplayBuffer()
    n = buffer.add_generation(0, targets)
    path = ROOT / "build" / "chip_smoke" / "buffer_0.npz"
    buffer.save_generation(0, str(path))
    again.load_generation(0, str(path))
    if not all(np.array_equal(buffer.generations[0][k], again.generations[0][k])
               for k in buffer.generations[0]):
        raise SystemExit("selfplay to the end: the replay buffer's save and load differ")
    outcomes = result.outcome.long().bincount(minlength=4).tolist()
    print(f"selfplay to the end: every game has a final outcome ({outcomes} unknown, draw, "
          f"cross and circle wins); {n} valid samples, value_wdl rows sum to 1; the replay "
          f"buffer's save and load are equal; the card's moves replayed on the CPU give the same "
          f"boards and outcomes", flush=True)
    return backup, targets


RUN = ROOT / "runs" / "flagship_r4"
# phase 19's gating, cut through the manager's own configuration: 2
# balanced openings (4 games) at 4 sims a move (the defaults: 64 games at
# 100).  The match runs until every game has ended, so one game drawn on a
# full board costs 221 plies of two searches (a CPU rehearsal at 2 sims
# drew one of 8 games that way)
TRAIN_GATING_GAMES = 4
TRAIN_GATING_SIMS = 4
TRAIN_CHECK_SAMPLES = 32  # samples of the train step held against the CPU


def _step_on(net, batch: dict, modes, dtype=None) -> dict:
    """One train step of a copy of `net` on `batch`'s device (and, with
    `dtype`, at that compute dtype): the losses, gradients and BatchNorm
    statistics after it, on the host, by state_dict key."""
    import copy
    import dataclasses
    import torch
    from alphagomoku_tpu_torch.game import vectorized as V
    from alphagomoku_tpu_torch.game.types import GameRules
    from alphagomoku_tpu_torch.models.networks import AGNetwork
    from alphagomoku_tpu_torch.training import train as T

    dev = batch["board"].device
    if dtype is None:
        copy_ = copy.deepcopy(net).to(dev)
    else:
        copy_ = AGNetwork(dataclasses.replace(net.cfg, dtype=dtype), H, W)
        copy_.load_state_dict(net.state_dict())
        copy_ = copy_.to(dev)
    cfg = T.TrainConfig()
    state, tx = T.create_train_state(copy_, cfg)
    _, parts = T.make_train_step(copy_, tx, V.device_tables(GameRules.FREESTYLE), cfg)(
        state, batch, modes.to(dev))
    return {"loss": {k: float(v) for k, v in parts.items()},
            "grads": {k: p.grad.float().cpu() for k, p in copy_.named_parameters()},
            "stats": {k: b.float().cpu() for k, b in copy_.named_buffers()}}


def _rel(a, b, floor: float = 1e-30) -> float:
    return float((a.double() - b.double()).norm() / max(float(a.double().norm()), floor))


def hold_train_step(net, batch_np: dict) -> str:
    """The train step on the card against the same step on a CPU copy, on
    the first TRAIN_CHECK_SAMPLES samples with the same modes, at the CPU
    tests' tolerances (tests/test_torch_train.py): losses within
    1e-2 max(1, |loss|), BatchNorm statistics within 1e-2 relative L2; the
    card's bfloat16 gradients no farther from a float32 CPU step's than the
    CPU's bfloat16 ones (over all tensors within 1.25 times, each tensor
    within twice, at least 0.1 and at most 0.5; norms floored at 1e-3 of
    the largest)."""
    import torch
    from alphagomoku_tpu_torch.training import train as T

    n = TRAIN_CHECK_SAMPLES
    host = {k: torch.from_numpy(v[:n]) for k, v in batch_np.items()}
    modes = T.draw_modes(torch.Generator().manual_seed(0), n, H, W)
    card = _step_on(net, {k: v.cuda() for k, v in host.items()}, modes)
    cpu = _step_on(net, host, modes)
    exact = _step_on(net, host, modes, torch.float32)
    for k, v in cpu["loss"].items():
        if not abs(card["loss"][k] - v) <= 1e-2 * max(1.0, abs(v)):
            raise SystemExit(f"train: loss {k} on the card {card['loss'][k]} vs the CPU {v}")
    worst_stat = max(_rel(cpu["stats"][k], card["stats"][k]) for k in cpu["stats"])
    if not worst_stat <= 1e-2:
        raise SystemExit(f"train: BatchNorm statistics differ by {worst_stat} from the CPU's")
    floor = 1e-3 * max(float(g.norm()) for g in exact["grads"].values())
    worst = 0.0
    for k, g in exact["grads"].items():
        d_cpu, d_card = _rel(g, cpu["grads"][k], floor), _rel(g, card["grads"][k], floor)
        if not d_card <= min(max(2 * d_cpu, 0.1), 0.5):
            raise SystemExit(f"train: gradient {k} on the card {d_card} from float32, the "
                             f"CPU's {d_cpu}")
        worst = max(worst, d_card)
    flat = lambda t: torch.cat([t[k].flatten() for k in exact["grads"]])
    g_cpu, g_card = _rel(flat(exact["grads"]), flat(cpu["grads"])), _rel(
        flat(exact["grads"]), flat(card["grads"]))
    if not g_card <= 1.25 * g_cpu:
        raise SystemExit(f"train: the card's gradients {g_card} from float32, the CPU's {g_cpu}")
    return (f"train step on the card vs the CPU at B={n}: losses within 1e-2 "
            f"({', '.join(f'{k} {v:.5f}/{cpu['loss'][k]:.5f}' for k, v in card['loss'].items())}); "
            f"statistics worst {worst_stat:.3g}; gradients from a float32 step: card "
            f"{g_card:.4f}, CPU {g_cpu:.4f} over all tensors, the card's worst tensor "
            f"{worst:.4f}")


def hold_zoo_train_step(net, batches: list) -> str:
    """A zoo network's train step on the card against the same step on a
    CPU copy, on each of `batches` (the first TRAIN_CHECK_SAMPLES samples,
    the same modes on both sides).  At a float32 compute dtype on each
    batch at tests/test_torch_train.py's float32 tolerances (losses and
    statistics within 1e-2, each gradient tensor within 3e-2 relative L2,
    norms floored at 1e-3 of the largest), which holds the arithmetic.  In
    bfloat16 phase 19's bands (`hold_train_step`): on each batch losses
    within 1e-2 max(1, |loss|) and statistics within 1e-2; the card's
    gradients no farther from the float32 CPU step's than the CPU's, with
    the distances averaged over the batches: over all tensors within 1.25
    times, each tensor within twice, at least 0.1.  Phase 19's cap of 0.5
    on a tensor is not held: a zoo network's own bfloat16 step, on the CPU
    as in flax, lies farther than that from its float32 step
    (tests/torch_golden/bf16_spread.py: bottleneck_v2's BatchNorm scales),
    so the cap would fail a correct card.  The line prints each batch's
    distances and the CPU's worst tensor."""
    import torch
    from alphagomoku_tpu_torch.training import train as T

    n = TRAIN_CHECK_SAMPLES
    modes = T.draw_modes(torch.Generator().manual_seed(0), n, H, W)
    d_cpu, d_card, g_cpu, g_card = {}, {}, [], []
    worst32, worst_stat = {"loss": 0.0, "grads": 0.0, "stats": 0.0}, 0.0
    for batch_np in batches:
        host = {k: torch.from_numpy(v[:n]) for k, v in batch_np.items()}
        on_card = {k: v.cuda() for k, v in host.items()}
        exact = _step_on(net, host, modes, torch.float32)
        exact_card = _step_on(net, on_card, modes, torch.float32)
        cpu, card = _step_on(net, host, modes), _step_on(net, on_card, modes)
        floor = 1e-3 * max(float(g.norm()) for g in exact["grads"].values())
        parts32 = {
            "loss": max(abs(exact_card["loss"][k] - v) / max(1.0, abs(v))
                        for k, v in exact["loss"].items()),
            "grads": max(_rel(exact["grads"][k], g, floor)
                         for k, g in exact_card["grads"].items()),
            "stats": max(_rel(exact["stats"][k], b) for k, b in exact_card["stats"].items())}
        if not (parts32["loss"] <= 1e-2 and parts32["grads"] <= 3e-2
                and parts32["stats"] <= 1e-2):
            raise SystemExit(f"zoo train: the float32 step on the card vs the CPU's: {parts32}")
        worst32 = {k: max(v, parts32[k]) for k, v in worst32.items()}
        for k, v in cpu["loss"].items():
            if not abs(card["loss"][k] - v) <= 1e-2 * max(1.0, abs(v)):
                raise SystemExit(f"zoo train: loss {k} on the card {card['loss'][k]} vs the "
                                 f"CPU {v}")
        worst_stat = max([worst_stat] + [_rel(cpu["stats"][k], card["stats"][k])
                                         for k in cpu["stats"]])
        if not worst_stat <= 1e-2:
            raise SystemExit(f"zoo train: BatchNorm statistics differ by {worst_stat}")
        for k, g in exact["grads"].items():
            d_cpu[k] = d_cpu.get(k, 0.0) + _rel(g, cpu["grads"][k], floor) / len(batches)
            d_card[k] = d_card.get(k, 0.0) + _rel(g, card["grads"][k], floor) / len(batches)
        flat = lambda t: torch.cat([t[k].flatten() for k in exact["grads"]])
        g_cpu.append(_rel(flat(exact["grads"]), flat(cpu["grads"])))
        g_card.append(_rel(flat(exact["grads"]), flat(card["grads"])))
    mean_cpu, mean_card = statistics.fmean(g_cpu), statistics.fmean(g_card)
    ratio = max(d_card[k] / max(2 * d_cpu[k], 0.1) for k in d_cpu)
    cpu_worst = max(d_cpu, key=d_cpu.get)
    readings = (f"bfloat16 gradients from float32 per batch: card "
                f"{', '.join(f'{g:.4f}' for g in g_card)}, CPU "
                f"{', '.join(f'{g:.4f}' for g in g_cpu)} (mean ratio {mean_card / mean_cpu:.3f}, "
                f"at most 1.25); each tensor at most {ratio:.3f} of its band; the CPU's worst "
                f"tensor {d_cpu[cpu_worst]:.4f} ({cpu_worst}), the card's "
                f"{max(d_card.values()):.4f}")
    if not (mean_card <= 1.25 * mean_cpu and ratio <= 1.0):
        raise SystemExit(f"zoo train: {readings}")
    return (f"train step at B={n} on {len(batches)} batches: float32 on the card vs the CPU's, "
            f"worst relative {json.dumps({k: float(f'{v:.3g}') for k, v in worst32.items()})}; "
            f"bfloat16 losses within 1e-2, statistics worst {worst_stat:.3g}; {readings}")


def train_phase(paths: dict, generation: dict) -> dict:
    """19. train: the training manager (`training/manager.py`) at its
    defaults, resumed from a copy of runs/flagship_r4/'s checkpoints and
    records (network_28, best 23); the replay window's buffer files written
    from `generation` (phase 18's targets, split into train and validation
    samples as the manager splits them, the same files for each of the 20
    iterations) and loaded through the manager's own skip path; one train
    step held against the CPU; `train_iteration(29)` (200 steps at batch
    256); the trunk kernel and the fused forward on the freshly packed
    trained weights; gating (`gating(29)`, cut through the config) with
    its launches counted.  Returns the trunk kernel's figures on the
    trained pack."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from alphagomoku_tpu_torch.data import ReplayBuffer
    from alphagomoku_tpu_torch.game.types import GameOutcome
    from alphagomoku_tpu_torch.models.convert import from_flax
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM
    from alphagomoku_tpu_torch.patterns import features as FEAT
    from alphagomoku_tpu_torch.training import manager as TMGR
    from alphagomoku_tpu_torch.training import train as T
    from alphagomoku_tpu_torch.utils import checkpoint

    stage = {}
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    wd = Path(tmp.name) / "run"
    shutil.copytree(RUN, wd, ignore=shutil.ignore_patterns("train_buffer", "valid_buffer"))
    mgr = TMGR.TrainingManager(TMGR.ManagerConfig(
        working_dir=str(wd), gating_games=TRAIN_GATING_GAMES,
        num_simulations=TRAIN_GATING_SIMS), device="cuda")
    if mgr.metadata != {"last_checkpoint": 28, "best_checkpoint": 23, "learning_steps": 11600}:
        raise SystemExit(f"train: the manager resumed {mgr.metadata}")
    tv = generation["valid"].cpu().numpy()
    split = np.random.default_rng(0).random(tv.shape) < mgr.cfg.validation_fraction
    parts = {"train_buffer": ReplayBuffer(), "valid_buffer": ReplayBuffer()}
    parts["train_buffer"].add_generation(0, dict(generation, valid=tv & ~split))
    parts["valid_buffer"].add_generation(0, dict(generation, valid=tv & split))
    first = 29 - mgr.cfg.buffer_window
    _zero_counts()
    for i in range(first, 29):
        for sub, buf in parts.items():
            buf.save_generation(0, str(wd / sub / f"buffer_{i}.npz"))
        mgr.generate_games(i)
        mgr.valid_buffer.load_generation(i, str(wd / "valid_buffer" / f"buffer_{i}.npz"))
    samples = mgr.buffer.num_samples
    if (sorted(mgr.buffer.generations) != list(range(first, 29)) or CF.fused_trunk.launches
            or samples != mgr.cfg.buffer_window * parts["train_buffer"].num_samples):
        raise SystemExit("train: the replay window did not load through the skip path")
    stage["resume"] = time.perf_counter() - t0
    print(f"train: resumed {mgr.metadata} on {wd.name}; replay window {first}..28 (phase 18's "
          f"generation in each) loaded through generate_games' skip path: {samples} samples, "
          f"valid {mgr.valid_buffer.num_samples}", flush=True)

    t0 = time.perf_counter()
    print(hold_train_step(mgr.net, mgr.buffer.sample(TRAIN_CHECK_SAMPLES,
                                                     np.random.default_rng(0))), flush=True)
    stage["step_check"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mean = mgr.train_iteration(29)
    torch.cuda.synchronize()
    stage["train_iteration"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps_s = mgr.cfg.train_steps_per_iteration / mgr.last_timings["train_steps"]
    if not all(np.isfinite(v) for v in mean.values()) or CF.fused_trunk.launches:
        raise SystemExit(f"train: a loss is not finite, or training launched the trunk: {mean}")
    if mgr.metadata["learning_steps"] != 11800 or mgr.metadata["last_checkpoint"] != 29:
        raise SystemExit(f"train: metadata after the iteration {mgr.metadata}")
    live = {k: v.detach().cpu().numpy() for k, v in mgr.net.state_dict().items()}
    back = from_flax(checkpoint.load(mgr.checkpoint_path(29)))
    swa = checkpoint.load(mgr.checkpoint_path(0, swa=True))
    avg = T.average_params([checkpoint.load(mgr.checkpoint_path(i))["params"]
                            for i in range(20, 30)])
    swa_ok = (all(np.array_equal(back[k].numpy(), v) for k, v in live.items())
              and _same_tree(swa["params"], avg)
              and _same_tree(swa["batch_stats"], checkpoint.load(mgr.checkpoint_path(29))[
                  "batch_stats"]))
    hist = json.loads((wd / "training_history.txt").read_text().splitlines()[-1])
    if not swa_ok or hist["iteration"] != 29:
        raise SystemExit("train: network_29 or network_swa do not read back as the live "
                         "weights and the last ten checkpoints' mean, or no history line")
    ref = json.loads((RUN / "training_history.txt").read_text().splitlines()[-1])
    heads = ("policy", "value", "q", "moves_left", "total")
    print(f"train: train_iteration(29): 200 steps at batch {mgr.cfg.train_batch_size}, "
          f"{steps_s:.3f} steps/s ({mgr.last_timings['train_steps']:.3f} s of steps, "
          f"{stage['train_iteration']:.3f} s with validation, checkpoint and SWA), peak device "
          f"memory {peak} bytes ({peak - base} over the {base} held before); learning_steps "
          f"{mgr.metadata['learning_steps']}; network_29 and network_swa read back equal; "
          f"means {json.dumps({k: round(mean[k], 5) for k in heads})} valid "
          f"{json.dumps({k: round(v, 5) for k, v in mean.items() if k.startswith('valid_')})}; "
          f"for the reader, the JAX run's iteration 28 on its TPU: "
          f"{json.dumps({k: round(ref[k], 5) for k in heads})}", flush=True)

    # the hand-over: a fresh pack of the trained module
    t0 = time.perf_counter()
    weights = mgr._host_vars()
    batch = mgr.buffer.sample(256, np.random.default_rng(1))
    boards = torch.from_numpy(batch["board"]).cuda()
    stm = torch.from_numpy(batch["stm"]).cuda()
    planes = FEAT.unpack_raw_planes(FEAT.encode(mgr.tables, boards, stm))
    with torch.no_grad():
        x = weights.net.stem_forward(planes).permute(0, 2, 3, 1).contiguous()
        trunk = held(CF.fused_trunk_plain(x, weights.trunk), CF.fused_trunk(x, weights.trunk),
                     CF.TRUNK_LIMITS)
        trunk_ms = time_cuda(lambda: [CF.fused_trunk(x, weights.trunk) for _ in range(20)],
                             reps=3) / 20
    if not trunk["ok"]:
        raise SystemExit(f"train: the trunk kernel disagrees on the trained pack: {trunk}")
    # the pack is the trained module's weights, exactly
    fresh = CF.pack_trunk_weights(mgr.net)
    if not (all(torch.equal(a, b) for a, b in zip(fresh, weights.trunk))
            and all(torch.equal(a, b) for a, b in zip(mgr.net.state_dict().values(),
                                                       weights.net.state_dict().values()))):
        raise SystemExit("train: the pack is not the trained module's weights")
    # the fused forward: kernel trunk vs plain trunk under HEAD_LIMITS, and
    # vs the module's own forward under the absolute rule of tests/test_ops.py
    # (the module rounds the depthwise output to bf16 before its BatchNorm,
    # where the fused forward folds BatchNorm into the f32 sum, as the Pallas
    # kernel does: more elements differ than HEAD_LIMITS allow)
    fused, fused_p = CF.fused_apply(weights, planes), CF.fused_apply(
        weights, planes, trunk=CF.fused_trunk_plain)
    module = mgr.net(planes)
    shares = {}
    for name in ("policy_logits", "value_logits", "q_logits", "moves_left_logits"):
        head = held(getattr(fused_p, name), getattr(fused, name), CF.HEAD_LIMITS)
        mod = held(getattr(module, name), getattr(fused, name), CF.HEAD_LIMITS)
        if not head["ok"] or not mod["abs_ok"]:
            raise SystemExit(f"train: the fused forward's {name} disagrees: with the plain "
                             f"trunk {head}; with the trained module {mod}")
        shares[name] = (round(head["share_differ"], 4), round(mod["share_differ"], 4),
                        round(mod["max_abs_err"], 4))
    if not mgr.net.training:
        raise SystemExit("train: the training module left train mode")
    stage["hand_over"] = time.perf_counter() - t0
    print(f"train: trunk kernel on the trained pack at B={x.shape[0]}: {describe(trunk)}; "
          f"{trunk_ms:.4f} ms a launch; the pack equals the trained weights; fused forward "
          f"(share differing from the plain-trunk forward, from the module's forward, max abs "
          f"err from the module's): {json.dumps(shares)}; the module still in train mode",
          flush=True)

    # gating, the launches counted around it alone
    plies, on_empty = [0], []

    def on_ply(env, moves):
        plies[0] += 1
        cell = env.board.flatten(1).gather(1, moves[:, None])[:, 0]
        on_empty.append(((cell == 0) | (env.outcome != int(GameOutcome.UNKNOWN))).all())

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gate = mgr.gating(29, on_ply=on_ply)
    torch.cuda.synchronize()
    stage["gating"] = time.perf_counter() - t0
    paths["train"] = _counts()
    res = mgr.last_gating
    sims = mgr.cfg.num_simulations
    want = {"score_scan": 0, "score_backup": plies[0] * 2 * sims,
            "fused_trunk": plies[0] * 2 * (sims + 1) + 1, "fused_trunk_cluster": 0,
            "fused_trunk_wide": 0, "fused_trunk_streamed": 0}
    line = json.loads((wd / "gating.txt").read_text().splitlines()[-1])
    ended = (res.outcomes != int(GameOutcome.UNKNOWN)).sum() + res.truncated
    if (line["iteration"] != 29 or int(res.pentanomial.sum()) != TRAIN_GATING_GAMES // 2
            or ended != TRAIN_GATING_GAMES or not bool(torch.stack(on_empty).all())
            or paths["train"] != want):
        raise SystemExit(f"train: gating {line}, {ended} games ended, launches "
                         f"{paths['train']} (expected {want})")
    print(f"train: gating(29) vs network_23: {TRAIN_GATING_GAMES} games at {sims} sims from "
          f"balanced openings, {plies[0]} plies, {stage['gating']:.3f} s; {json.dumps(gate)}, "
          f"pentanomial {res.pentanomial.tolist()}, lengths {res.game_lengths.tolist()}; every "
          f"game ended, every live move on an empty cell; launches {paths['train']}", flush=True)
    print("train: seconds by stage " + json.dumps({k: round(v, 3) for k, v in stage.items()}),
          flush=True)
    tmp.cleanup()
    return dict(trained_pack=dict(ms=trunk_ms, share_differ=trunk["share_differ"],
                                  max_abs_err=trunk["max_abs_err"], batch=x.shape[0]),
                train_steps_per_s=steps_s, train_peak_bytes=peak)


# phase 20: the playing engine at its launcher's configuration (400 sims:
# a 1,208-node tree, K = 32, D = 40), each search cut to ENGINE_MAX_NODE
# simulations by the protocol's own node limit
ENGINE_MAX_NODE = 50
BENCH_DIR = ROOT / "build" / "chip_smoke" / "engine_benchmark"


class _EngineLog:
    """Records every search the port's Engine runs while installed: the
    position, the summary, the stage seconds and the kernels' launches
    during that search."""

    def __init__(self):
        from alphagomoku_tpu_torch.engine import engine as E

        self.E = E
        self.searches: list[dict] = []

    def __enter__(self):
        import torch
        from alphagomoku_tpu_torch.ops import convnext_fused as CF
        from alphagomoku_tpu_torch.ops import score_scan as SSM

        orig = self.orig = self.E.Engine.search
        log = self.searches

        def search(eng, *a, **k):
            board, stm, reuse0 = eng.board_array(), eng.sign_to_move(), eng.reuse_count
            n0 = (SSM.score_backup.launches, CF.fused_trunk.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = orig(eng, *a, **k)
            torch.cuda.synchronize()
            log.append(dict(board=board, stm=stm, rules=eng.rules, summary=s,
                            seconds=time.perf_counter() - t0, timings=dict(eng.last_timings),
                            reused=eng.reuse_count > reuse0,
                            score_backup=SSM.score_backup.launches - n0[0],
                            fused_trunk=CF.fused_trunk.launches - n0[1]))
            return s

        self.E.Engine.search = search
        return self

    def __exit__(self, *exc):
        self.E.Engine.search = self.orig


def _drive(mgr, *lines) -> list[str]:
    """Feed protocol lines to a ProgramManager and pump until they are
    read; returns the lines it wrote."""
    out: list[str] = []
    orig = mgr.sender._sink
    mgr.sender._sink = out.append
    try:
        for line in lines:
            mgr.listener.push_line(line)
        while not mgr.listener.is_empty():
            mgr.run_once()
    finally:
        mgr.sender._sink = orig
    return out


def _answers(out: list[str]) -> list[str]:
    import re

    return [x for x in out if re.fullmatch(r"\d+,\d+( \d+,\d+)*", x)]


def _reply_along_tree(eng, answer) -> str:
    """TURN with the most visited reply to the engine's `answer` (a Move)
    in its last search's tree (so that the next search can reuse it)."""
    st = eng._last_state
    root = int(st.root_node[0])
    ea, ec = st.tree.edge_action[0].cpu().numpy(), st.tree.edge_child[0].cpu().numpy()
    nv = st.tree.node_visits[0].cpu().numpy()
    move = answer.row * eng.cols + answer.col
    child = int(ec[root, list(ea[root]).index(move)])
    visits = [nv[c] if c >= 0 else -1 for c in ec[child]]
    a = int(ea[child, max(range(len(visits)), key=visits.__getitem__)])
    return f"TURN {a // eng.cols},{a % eng.cols}"


def root_planes(tables, board, stm):
    """The network's raw input planes of boards [B, H, W] and sides to move."""
    from alphagomoku_tpu_torch.patterns import features as FEAT

    return FEAT.unpack_raw_planes(FEAT.encode(tables, board, stm))


def engine_phase() -> dict:
    """Phase 20: the port's ProgramManager (extended protocol, network_23,
    the launcher's defaults) through a game transcript, gated move by
    move; then the kernels at the engine's shapes against their plain
    versions; the 20x20 engine with seeded weights; one realtime search
    over the YixinBoard protocol; the benchmark sweep.  Returns the
    launch counts of the transcript and the kernels' entries."""
    import io

    import numpy as np
    import torch
    from alphagomoku_tpu_torch.engine.benchmark import create_config, run_benchmark
    from alphagomoku_tpu_torch.engine.manager import ProgramManager
    from alphagomoku_tpu_torch.game import rules as R
    from alphagomoku_tpu_torch.game import vectorized as V
    from alphagomoku_tpu_torch.game.types import CROSS, GameRules
    from alphagomoku_tpu_torch.models.networks import create_network, init_random_
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM
    from alphagomoku_tpu_torch.search import mcts

    t_phase = time.perf_counter()
    mgr = ProgramManager(protocol="extended", checkpoint=str(CKPT), device="cuda",
                         instream=None, outstream=io.StringIO())
    opening = ["START 15", f"INFO max_node {ENGINE_MAX_NODE}"]
    own4 = [(7, 4), (7, 5), (7, 6), (7, 7)]
    _zero_counts()
    with _EngineLog() as log:
        out = _drive(mgr, *opening, "BEGIN")
        eng15 = mgr.engine
        for _ in range(2):
            out += _drive(mgr, _reply_along_tree(eng15, log.searches[-1]["summary"].best_move))
        reuse_tree = eng15._last_state
        # an open four (the root VCF: WIN in 1), a four chain (WIN in 5) and
        # the opponent's half-open four to block, which the search answers
        win = _drive(mgr, "START 15", "BOARD", *[f"{r},{c},1" for r, c in own4],
                     "9,3,2", "9,4,2", "9,5,2", "0,0,2", "DONE")
        chain = _drive(mgr, "START 15", "BOARD", "7,5,1", "7,6,1", "7,7,1", "9,9,1", "10,10,1",
                       "7,4,2", "0,0,2", "0,2,2", "14,14,2", "14,12,2", "DONE")
        block = _drive(mgr, "START 15", "BOARD", "7,2,1", "2,2,1", "3,3,1", "4,4,1", "7,3,2",
                       "7,4,2", "7,5,2", "7,6,2", "DONE")
        takeback = _drive(mgr, "TAKEBACK 7,7")
        # renju: black's 3x3 fork at 7,7, then a search for black
        renju = _drive(mgr, "RESTART", "INFO rule 4", "PLAY 7,5", "PLAY 0,0", "PLAY 7,6",
                       "PLAY 0,14", "PLAY 5,7", "PLAY 14,0", "PLAY 6,7", "SHOWFORBID",
                       "TURN 14,14", "SHOWFORBID")
        out += win + chain + block + takeback + renju
        launches = _counts()
    searches = log.searches
    # a 15x15 checkpoint has no 20x20 moves-left head: the engine refuses it
    try:
        _drive(mgr, "START 20", "BEGIN")
        raise SystemExit("engine: network_23 was accepted for a 20x20 board")
    except ValueError as e:
        refused20 = str(e)

    # -- gates ------------------------------------------------------------
    for i, s in enumerate(searches):
        mv, board = s["summary"].best_move, s["board"]
        if board[mv.row, mv.col] != 0:
            raise SystemExit(f"engine: search {i} answered the occupied cell {mv}")
        if s["rules"] == GameRules.RENJU and mv.sign == CROSS and R.is_forbidden(board, mv):
            raise SystemExit(f"engine: search {i} answered the forbidden cell {mv}")
        steps = s["timings"].get("steps", 0)
        want = (steps, steps + (steps > 0 and not s["reused"]))
        if (s["score_backup"], s["fused_trunk"]) != want:
            raise SystemExit(f"engine: search {i} launched score_backup {s['score_backup']} "
                             f"and the trunk {s['fused_trunk']} times in {steps} steps, "
                             f"expected {want}")
        if not np.isfinite([s["summary"].expectation, s["summary"].win_rate]).all():
            raise SystemExit(f"engine: search {i} has a non-finite value: {s['summary']}")
    if _answers(win) not in (["7,3"], ["7,8"]) or not searches[3]["summary"].proven.startswith(
            "WIN in "):
        raise SystemExit(f"engine: the open four was not won: {win}")
    if not searches[4]["summary"].proven.startswith("WIN in ") or _answers(chain) != ["7,8"]:
        raise SystemExit(f"engine: the VCF position was not proven: {chain}")
    if _answers(block) != ["7,7"]:
        raise SystemExit(f"engine: the four was not blocked: {block}")
    if takeback != ["OK"]:
        raise SystemExit(f"engine: TAKEBACK answered {takeback}")
    forbid = [x for x in renju if x.startswith("FORBID")]
    if len(forbid) != 2 or "7,7" not in forbid[0].split():
        raise SystemExit(f"engine: SHOWFORBID did not list the 3x3 fork 7,7: {renju}")
    if eng15.reuse_count < 1 or not searches[1]["reused"]:
        raise SystemExit(f"engine: the TURNs did not reuse the tree ({eng15.reuse_count})")
    if min(launches["score_backup"], launches["fused_trunk"]) < 1 or launches["score_scan"]:
        raise SystemExit(f"engine: the kernels were not launched on its path: {launches}")
    ran = [s for s in searches if s["timings"].get("steps", 0) > 0]
    steps = sum(s["timings"]["steps"] for s in ran)
    sim_s = sum(s["timings"]["simulate"] for s in ran)
    step_ms = 1e3 * sim_s / steps
    print(f"engine: {len(searches)} searches ({len(ran)} through the tree, "
          f"{ENGINE_MAX_NODE} sims each) at B=1, N={reuse_tree.tree.capacity}, K=32, D=40: "
          f"{step_ms:.2f} ms per simulation step, "
          f"{(launches['score_backup'] + launches['fused_trunk']) / steps:.4f} of the kernels "
          f"per step (launches {launches}); reuse count {eng15.reuse_count}; seconds per move "
          + ", ".join(f"{s['seconds']:.2f}" for s in searches)
          + "; stages of the first search " + ", ".join(
              f"{k} {v:.3f}" for k, v in searches[0]["timings"].items()), flush=True)
    print("engine answers: " + " | ".join(
        f"{s['summary'].best_move.row},{s['summary'].best_move.col} "
        f"{s['summary'].proven or 'ev %.3f' % s['summary'].expectation}" for s in searches)
        + f"; FORBID lines {forbid}; 20x20 with network_23 refused: {refused20}", flush=True)

    # -- kernels at the engine's shapes -----------------------------------
    tables = V.device_tables(GameRules.FREESTYLE)
    tree = reuse_tree.tree
    pn, ps, leaf = most_visited_paths(tree, 40)
    engine_backup = backup_phase(dict(
        edge_score=tree.edge_score, edge_action=tree.edge_action,
        node_complete=tree.node_complete, node_score=tree.node_score, pn=pn, ps=ps,
        start_score=leaf), "score_backup on the engine tree (D=40)")
    # a full 40-level path over the engine tree's rows: both chunks of
    # score_backup_kernel<32> (levels 32..39, then 0..31)
    rng = np.random.default_rng(5)
    count = int(tree.node_count[0])
    nodes = torch.from_numpy(rng.permutation(count)[:40][None].copy()).to(pn.device)
    deep = backup_phase(dict(
        edge_score=tree.edge_score, edge_action=tree.edge_action,
        node_complete=tree.node_complete, node_score=tree.node_score, pn=nodes,
        ps=torch.from_numpy(rng.integers(0, 32, size=(1, 40))).to(pn.device),
        start_score=leaf), "score_backup on the engine tree, a full 40-level path")
    # the engine's next steps traced: every launch of a B = 1 step
    simulate = mcts.make_simulate_fn(CF.fused_apply, eng15.tables, eng15._mcfg)
    print(profile_steps(simulate, eng15.variables, reuse_tree, PROFILE_STEPS).replace(
        "profile:", "profile engine:"), flush=True)
    board15 = torch.from_numpy(searches[1]["board"][None]).to("cuda")
    stm15 = torch.full((1,), searches[1]["stm"], dtype=torch.int8, device="cuda")
    trunk15 = trunk_phase(eng15.net, root_planes(tables, board15, stm15), "fused_trunk B=1 15x15")

    # -- the 20x20 engine (seeded weights) and the trunk there -------------
    mgr20 = ProgramManager(protocol="extended", device="cuda", instream=None,
                           outstream=io.StringIO())
    with _EngineLog() as log20:
        n0 = (SSM.score_backup.launches, CF.fused_trunk.launches)
        out20 = _drive(mgr20, "START 20", f"INFO max_node {ENGINE_MAX_NODE}", "BEGIN")
        launches20 = (SSM.score_backup.launches - n0[0], CF.fused_trunk.launches - n0[1])
    s20 = log20.searches[0]
    if len(_answers(out20)) != 1 or launches20 != (s20["timings"]["steps"],
                                                    s20["timings"]["steps"] + 1):
        raise SystemExit(f"engine 20x20: {out20} {launches20}")
    print(f"engine 20x20 (seeded 6x64): answer {_answers(out20)[0]} in {s20['seconds']:.2f} s, "
          f"{1e3 * s20['timings']['simulate'] / s20['timings']['steps']:.2f} ms per step, "
          f"launches score_backup {launches20[0]}, trunk {launches20[1]}", flush=True)
    board20 = torch.zeros((1, 20, 20), dtype=torch.int8, device="cuda")
    stm20 = torch.full((1,), CROSS, dtype=torch.int8, device="cuda")
    trunk20 = trunk_phase(mgr20.engine.net, root_planes(tables, board20, stm20),
                          "fused_trunk B=1 20x20")

    # -- one realtime search over the YixinBoard protocol ------------------
    yx = ProgramManager(protocol="yixin", checkpoint=str(CKPT), device="cuda", instream=None,
                        outstream=io.StringIO())
    yx_out = _drive(yx, "START 15", f"INFO max_node {ENGINE_MAX_NODE}", "info show_detail 1",
                    "BEGIN")
    if not any(x.startswith("MESSAGE REALTIME BEST") for x in yx_out) or len(
            _answers(yx_out)) != 1:
        raise SystemExit(f"engine yixin: no realtime stream or no answer: {yx_out}")
    print(f"engine yixin: {sum(x.startswith('MESSAGE REALTIME') for x in yx_out)} realtime "
          f"lines, answer {_answers(yx_out)[0]}", flush=True)

    # -- the benchmark sweep and config derivation (engine/benchmark.py) ---
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    report = run_benchmark(seconds_per_point=0.2, output_path=str(BENCH_DIR / "benchmark.json"))
    config = create_config(str(BENCH_DIR / "benchmark.json"), str(BENCH_DIR / "config.json"))
    print("engine benchmark (seeded 6x64, fused forward): " + ", ".join(
        f"B={r['batch_size']} {r['samples_per_second']:.0f}/s" for r in report["results"])
        + f"; config batch {config['search_batch_size']}", flush=True)
    print(f"engine phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, step_ms=step_ms, steps=steps,
                seconds_per_move=[s["seconds"] for s in searches],
                score_backup=dict(engine_tree=engine_backup, engine_full_path=deep),
                fused_trunk={"15x15": dict(trunk15, launches=launches["fused_trunk"]),
                             "20x20": dict(trunk20, launches=launches20[1])})


def _same_tree(a: dict, b: dict) -> bool:
    import numpy as np

    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same_tree(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


# ---------------------------------------------------------------------------
# phase 21: the network zoo and --selfcheck
# ---------------------------------------------------------------------------

# (K, D) of the K > 32 kernels held here: edge slots, path depth
WIDE_SHAPES = ((33, 16), (33, 32), (81, 16), (81, 32), (225, 16), (225, 32), (400, 16))
WIDE_NODES = 64  # nodes per tree of the K > 32 backups
WIDE_PLAIN_REPS = 3  # calls timed of their plain versions (20 to 60 ms each)
# score_backup_kernel<16> on the flagship tree's paths before the wide
# kernels were added (PERF.md §6)
BACKUP_MS_BEFORE_WIDE = 0.00577
# the wide kernels of the design before the staged one (each level's row
# loaded after the level below) at WIDE_SHAPES, ms (PERF.md §6: tools/scan_phases.py
# on the parent checkout, the mean of its two runs A B B A in one call,
# NVIDIA H100 80GB HBM3 at 700 W)
WIDE_MS_PARENT = {
    "score_scan": {"K=33 D=16": 0.015485, "K=33 D=32": 0.029726,
                   "K=81 D=16": 0.022525, "K=81 D=32": 0.043565,
                   "K=225 D=16": 0.056464, "K=225 D=32": 0.205107,
                   "K=400 D=16": 0.157288},
    "score_backup": {"K=33 D=16": 0.017072, "K=33 D=32": 0.031657,
                     "K=81 D=16": 0.026108, "K=81 D=32": 0.046835,
                     "K=225 D=16": 0.07389, "K=225 D=32": 0.240208,
                     "K=400 D=16": 0.166119},
}
ZOO_SIMS = 8
ZOO_BATCH = 256
ZOO_SEED = 0  # torch.Generator seed of every zoo network's weights
ZOO_TRAIN_BATCHES = 2  # batches of TRAIN_CHECK_SAMPLES of each zoo network's train step hold
ZOO_CHECK_BOARDS = 16  # boards of each zoo network's forward held against the CPU
ZOO_ENGINE_ARCH = "Transformer_v2"
# every trunk family but convnext (phases 5-20) at the launcher's width
# (--blocks 6 --filters 64; the unets take no block count), and the
# selfcheck's FastPolicy at its registry's 2x32; bottleneck v1 has no
# registry name and is built from its ModelConfig
ZOO = {
    "resnet": "ResnetPVQraw",
    "bottleneck_v1": dict(trunk="bottleneck_v1", heads="pv", raw_input=True),
    "bottleneck_v2": "BottleneckPV",
    "bottleneck_v3": "BottleneckBroadcastPVraw",
    "transformer": "Transformer_v2",
    "unet": "ConvUnet",
    "unet_transformer": "TransformerUnet",
    "convnext_moe": "ConvNextMoE_PVQMraw",
    "fast_policy": "FastPolicy",
}


def zoo_network(family: str):
    """The zoo network of `family` with seeded weights, on the card."""
    import torch
    from alphagomoku_tpu_torch.models import networks as TN

    spec = ZOO[family]
    if isinstance(spec, dict):
        net = TN.AGNetwork(TN.ModelConfig(**spec, blocks=6, filters=64), H, W)
    elif spec == "FastPolicy":
        net = TN.create_network(spec)
    else:
        net = TN.create_network(spec, blocks=6, filters=64)
    return TN.init_random_(net, torch.Generator().manual_seed(ZOO_SEED)).to("cuda").eval()


def wide_kernels_phase() -> dict:
    """Phase 21, part 1 (run after phase 4, before the first trace of
    search steps, after which torch.profiler misses lone launches):
    score_scan and score_backup at each of `WIDE_SHAPES`, each bit-equal to
    its plain version and timed beside its bytes bound, and printed beside
    the parent design's time (`WIDE_MS_PARENT`, kept out of the returned
    entries, which this run did not measure); then what the card gives the wide
    kernels at each K (registers, blocks per SM, dynamic shared memory,
    spills, which must be 0).  Returns the measurements by entry point and
    shape, the occupancy at K = 81 and by K, and the seconds."""
    import torch
    from alphagomoku_tpu_torch.ops import score_scan as SSM

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    out = {"score_scan": {}, "score_backup": {}}
    R = BATCH
    for K, D in WIDE_SHAPES:
        shape = f"K={K} D={D}"
        args = tuple(torch.from_numpy(a).to(dev) for a in random_scan_inputs(R, D, K, K + D))
        e_k, ns_k = SSM.score_scan(*args)
        e_p, ns_p = SSM.score_scan_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(e_k, e_p) and torch.equal(ns_k, ns_p)):
            raise SystemExit(f"score_scan {shape}: kernel disagrees with the plain version")
        ms = kernel_device_ms(lambda: SSM.score_scan(*args), "score_scan_wide_kernel")
        plain_ms = time_cuda(lambda: SSM.score_scan_plain(*args), reps=WIDE_PLAIN_REPS, warmup=1)
        nbytes = 2 * (R + R * D * K + 3 * R * D) + (R * D * K + 3 * R * D)
        bound_ms = nbytes / HBM_BPS * 1e3
        out["score_scan"][shape] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        print(f"score_scan K={K}: bit-equal at R={R} D={D}; kernel {ms:.5f} ms on the "
              f"device, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({nbytes} bytes "
              "at u16 scores)", flush=True)
        del args, e_k, ns_k, e_p, ns_p
        tree = {k: torch.from_numpy(v).to(dev) for k, v in
                random_backup_inputs(R, WIDE_NODES, D, K, K + D).items()}
        out["score_backup"][shape] = backup_phase(
            tree, f"score_backup K={K}", "score_backup_wide_kernel", WIDE_PLAIN_REPS)
        del tree
        for name in out:
            ms, parent_ms = out[name][shape]["ms"], WIDE_MS_PARENT[name][shape]
            print(f"{name} {shape}: {ms:.5f} ms, the parent design {parent_ms:.5f} ms "
                  f"({parent_ms / ms:.2f}x)", flush=True)
    by_k = {K: SSM.scan_occupancy(32, K) for K in sorted({K for K, _ in WIDE_SHAPES})}
    for K, occ in by_k.items():
        if any(o["local_bytes"] or o["blocks_per_sm"] < 1 for o in occ.values()):
            raise SystemExit(f"K={K}: a wide kernel spills to local memory or does not fit an "
                             f"SM: {occ}")
        print(f"wide kernels at K={K}: " + "; ".join(
            f"{name}: {o['registers']} registers per thread, {o['blocks_per_sm']} blocks per SM "
            f"of {o['warps_per_block']} rows, {o['dyn_smem_bytes']} bytes of dynamic shared "
            f"memory a block, {o['local_bytes']} bytes of local memory"
            for name, o in occ.items()), flush=True)
    seconds = time.perf_counter() - t0
    print(f"phase 21 part 1: {seconds:.1f} s", flush=True)
    return dict(entries=out, occupancy=by_k[81],
                occupancy_by_k={f"K={K}": occ for K, occ in by_k.items()}, seconds=seconds)


def forward_on_card_vs_cpu(net, planes, tag: str) -> str:
    """A zoo network's module forward on the card against a CPU copy's on
    the same planes.  At a float32 compute dtype within 1e-3 of the
    largest magnitude, which holds the arithmetic.  In bfloat16 within
    tests/test_ops.py's absolute rule, and no farther from the CPU's
    float32 heads than the CPU's bfloat16 heads are (relative L2 over all
    heads, within 1.25 times, as phase 19 holds the gradients).
    HEAD_LIMITS' share of logits differing is printed, not required: flax
    and the port, both correct, differ in more than a quarter of their
    bfloat16 logits at this width on one CPU, and lie equally far from the
    float32 heads (tests/torch_golden/bf16_spread.py), since each library
    sums in its own order and a flipped rounding spreads through the
    blocks.  Returns the line's summary."""
    import copy
    import dataclasses

    import torch
    from alphagomoku_tpu_torch.models.networks import AGNetwork
    from alphagomoku_tpu_torch.ops import convnext_fused as CF

    f32 = AGNetwork(dataclasses.replace(net.cfg, dtype=torch.float32), H, W)
    f32.load_state_dict(net.state_dict())
    f32 = f32.to(planes.device).eval()
    host = planes.cpu()
    heads = lambda out: {k: getattr(out, k).float().cpu() for k in out._fields
                         if getattr(out, k) is not None}
    with torch.no_grad():
        exact, exact_card = heads(copy.deepcopy(f32).cpu()(host)), heads(f32(planes))
        cpu, card = heads(copy.deepcopy(net).cpu()(host)), heads(net(planes))
    share, worst_rel = 0.0, 0.0
    for name, a in exact.items():
        rel = float((a - exact_card[name]).abs().max()) / max(float(a.abs().max()), 1e-6)
        if not rel <= 1e-3:
            raise SystemExit(f"{tag}: {name} at float32 on the card vs the CPU: {rel}")
        worst_rel = max(worst_rel, rel)
        stats = held(cpu[name], card[name], CF.HEAD_LIMITS)
        if not stats["abs_ok"]:
            raise SystemExit(f"{tag}: {name} on the card vs the CPU: {stats}")
        share = max(share, stats["share_differ"])
    flat = lambda t: torch.cat([t[k].flatten() for k in exact])
    d_cpu, d_card = _rel(flat(exact), flat(cpu)), _rel(flat(exact), flat(card))
    summary = (f"float32 within {worst_rel:.3g} of the largest logit; bf16 within the absolute "
               f"rule, from the CPU's float32 heads: card {d_card:.5f}, CPU {d_cpu:.5f} (ratio "
               f"{d_card / d_cpu:.3f}, at most 1.25); HEAD_LIMITS' share differing "
               f"{share:.4f} (printed)")
    if not d_card <= 1.25 * d_cpu:
        raise SystemExit(f"{tag}: forward: {summary}")
    return summary


def zoo_phase(generation: dict, flagship_backup_ms: float) -> dict:
    """Phase 21, parts 2-4.  First what is timed, with no other process at
    work: for each zoo network a ZOO_SIMS-sim search at B = ZOO_BATCH on
    the bench boards through `network_apply` (score_backup once a step,
    the trunk kernel never) and ms per step of ZOO_SIMS more steps.  Then
    `python -m alphagomoku_tpu_torch.engine.manager --selfcheck` as a
    child process, and while it runs: one 50-sim BEGIN through the port's
    ProgramManager with `--arch Transformer_v2`; each zoo network's
    forward on the card against a CPU copy's (`forward_on_card_vs_cpu`)
    and its train step against a CPU copy's on ZOO_TRAIN_BATCHES batches
    (`hold_zoo_train_step`); the selfcheck's search in this process with
    the launches counted (K = 81: the wide kernel); last the child's rc 0
    and five PASS lines.  Returns the launches by path, the ms per step
    and the seconds."""
    import io

    import numpy as np
    import torch
    from alphagomoku_tpu_torch.data import ReplayBuffer
    from alphagomoku_tpu_torch.engine.manager import ProgramManager
    from alphagomoku_tpu_torch.game import vectorized as V
    from alphagomoku_tpu_torch.game.types import CROSS, GameRules
    from alphagomoku_tpu_torch.models.forward import network_apply
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM
    from alphagomoku_tpu_torch.patterns import features as FEAT
    from alphagomoku_tpu_torch.search import mcts
    from alphagomoku_tpu_torch.utils import selfcheck

    t_phase = time.perf_counter()
    print(f"phase 21: the 81-edge score_backup of --selfcheck beside the K = 32 one: the flagship "
          f"tree's score_backup_kernel<16> {flagship_backup_ms:.5f} ms in this run, "
          f"{BACKUP_MS_BEFORE_WIDE} ms before the wide kernels were added", flush=True)
    dev = torch.device("cuda")
    tables = V.device_tables(GameRules.FREESTYLE)
    boards = torch.from_numpy(bench_boards(ZOO_BATCH)).to(dev)
    stm = torch.full((ZOO_BATCH,), CROSS, dtype=torch.int8, device=dev)
    cfg = mcts.MCTSConfig(max_nodes=2 * ZOO_SIMS + 8, max_edges=32, max_depth=16)
    paths, step_ms, nets = {}, {}, {}
    for family in ZOO:
        net = nets[family] = zoo_network(family)
        raw = net.cfg.raw_input
        apply, variables = network_apply(net)
        if apply is CF.fused_apply:
            raise SystemExit(f"zoo {family}: network_apply chose the convnext kernel")
        state, paths[family] = search_phase(variables, tables, cfg, boards, stm, ZOO_SIMS,
                                            f"zoo {family}", apply, 0, raw)
        simulate = mcts.make_simulate_fn(apply, tables, cfg, raw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ZOO_SIMS):
            state = simulate(variables, state)
        torch.cuda.synchronize()
        step_ms[family] = (time.perf_counter() - t0) / ZOO_SIMS * 1e3
        print(f"zoo {family} ({net.cfg.trunk} {net.cfg.blocks}x{net.cfg.filters}, "
              f"{'raw' if raw else 'feature'} planes, heads {net.cfg.heads}): "
              f"{step_ms[family]:.3f} ms per simulation step at B={ZOO_BATCH}", flush=True)
        del variables, state, simulate
    timed = time.perf_counter() - t_phase

    # nothing below is timed: the selfcheck child runs beside the checks.
    # Its processes each need device memory of their own (a context,
    # cuBLAS's workspace), so this process hands back its cached blocks
    # first: with them held, a 4-context start failed in cublasCreate
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 21: device memory before the selfcheck child: this process reserved "
          f"{reserved} bytes, {torch.cuda.memory_reserved()} after empty_cache; free "
          f"{free} of {total}", flush=True)
    t_child = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "alphagomoku_tpu_torch.engine.manager", "--selfcheck"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        # one engine move through the launcher's ProgramManager
        mgr = ProgramManager(protocol="extended", architecture=ZOO_ENGINE_ARCH, device="cuda",
                             instream=None, outstream=io.StringIO())
        _zero_counts()
        with _EngineLog() as log:
            answer = _answers(_drive(mgr, "START 15", f"INFO max_node {ENGINE_MAX_NODE}",
                                     "BEGIN"))
        paths["engine_transformer"] = _counts()
        (s,) = log.searches
        steps = s["timings"].get("steps", 0)
        mv = s["summary"].best_move
        if (len(answer) != 1 or steps < 1 or s["board"][mv.row, mv.col] != 0
                or (s["score_backup"], s["fused_trunk"]) != (steps, 0)
                or not np.isfinite([s["summary"].expectation, s["summary"].win_rate]).all()):
            raise SystemExit(f"zoo engine: --arch {ZOO_ENGINE_ARCH} answered {answer} in "
                             f"{steps} steps, launches {paths['engine_transformer']}")
        print(f"zoo engine: --arch {ZOO_ENGINE_ARCH} (6x64, 32 feature planes, moves-left "
              f"head) answered BEGIN with {answer[0]}, {steps} steps at B=1, beside the "
              f"selfcheck child ({s['seconds']:.2f} s); launches "
              f"{paths['engine_transformer']}", flush=True)
        del mgr, log

        packed = FEAT.encode(tables, boards[:ZOO_CHECK_BOARDS], stm[:ZOO_CHECK_BOARDS])
        buf = ReplayBuffer()
        buf.add_generation(0, generation)
        batches = [buf.sample(TRAIN_CHECK_SAMPLES, np.random.default_rng(2 + i))
                   for i in range(ZOO_TRAIN_BATCHES)]
        for family, net in nets.items():
            t0 = time.perf_counter()
            planes = (FEAT.unpack_raw_planes(packed) if net.cfg.raw_input
                      else FEAT.unpack_planes(packed))
            worst = forward_on_card_vs_cpu(net, planes, f"zoo {family}")
            hold = hold_zoo_train_step(net, batches)
            print(f"zoo {family}: forward on the card vs the CPU: {worst}; {hold} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del nets

        # the selfcheck's search in this process: 16 steps at K = 81
        _zero_counts()
        if selfcheck._check_search("cuda") != "win-in-1 found":
            raise SystemExit("zoo: the selfcheck search failed in process")
        paths["selfcheck"] = _counts()
        if paths["selfcheck"] != {"score_scan": 0, "score_backup": 16, "fused_trunk": 0,
                                  "fused_trunk_cluster": 0, "fused_trunk_wide": 0,
                                  "fused_trunk_streamed": 0}:
            raise SystemExit(f"zoo: the selfcheck search launched {paths['selfcheck']}")

        out, _ = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    passes = [ln for ln in out.splitlines() if ln.startswith("[PASS] ")]
    print(f"selfcheck (child process, {time.perf_counter() - t_child:.1f} s from its start): "
          + " | ".join(out.strip().splitlines()), flush=True)
    if child.returncode != 0 or len(passes) != 5:
        raise SystemExit(f"selfcheck: rc {child.returncode}, {len(passes)} PASS lines:\n{out}")
    seconds = time.perf_counter() - t_phase
    print(f"phase 21 parts 2-4: {seconds:.1f} s ({timed:.1f} s timed, before the selfcheck "
          f"child started); the selfcheck search at K = 81: {paths['selfcheck']}", flush=True)
    return dict(paths=paths, step_ms=step_ms, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 22: the rest of search
# ---------------------------------------------------------------------------

LEAF_BATCH = 4  # descents a step under virtual loss
LB_SIMS = 200  # the flagship at leaf_batch 4: 50 steps
LB9_BATCH = 256  # the 9x9 leaf-batch search at K = 81 (seeded 6x64 convnext at 9x9)
LB9_SIMS = 64  # 16 steps
LB9_SEED = 0  # torch.Generator seed of its weights
OPTION_BATCH = 256  # the policy, init_to, NNUE and root-mask searches
OPTION_SIMS = 16
UTILITY_REL = 2e-6  # tests/test_torch_search_options.py's REL
TP_SEED = 0  # torch.Generator seeds of the tree policy's and the NNUE's weights
NNUE_SEED = 0
NNUE_HIDDEN = 32
TUNE_OPENINGS = 2  # one SPSA step of EngineTuner: 2 openings x 2 colours at 4 sims
TUNE_SIMS = 4
PHASE22_PROFILE_STEPS = 1  # leaf_batch 4 steps traced (the profiler takes ~8 s a step there)
EXACT_TREE = ("node_visits", "node_count", "edge_action", "edge_child", "node_score",
              "edge_score", "node_hash", "node_complete")


def moved_state(state, device=None, lanes=None):
    """A copy of a SearchState, its tensors cloned (or moved to `device`),
    of the boards `lanes` only if given (every tensor has the batch first;
    the allocation frontier, shared by the batch, stays)."""
    def mv(t):
        t = t if lanes is None else t[lanes]
        return t.clone() if device is None else t.to(device, copy=True)

    return state._replace(
        tree=type(state.tree)(*(mv(t) for t in state.tree)),
        root_board=mv(state.root_board), root_stm=mv(state.root_stm),
        root_node=mv(state.root_node), noisy_prior=mv(state.noisy_prior),
        sims_done=mv(state.sims_done), stats=type(state.stats)(*(mv(t) for t in state.stats)))


REPLAY_BOARDS = 160  # boards of a step replayed on the CPU (its cost is the leaves' features)


def replay_step(weights, tables, cfg, state, tag: str) -> dict:
    """One more step of `state`'s search on the card, with the rows its
    backup hands to score_scan captured and its leaf evaluation recorded;
    the same step on a CPU copy of the first REPLAY_BOARDS boards (the
    trees of a step are independent but for the shared frontier, which
    the copy keeps), the card's evaluation of their leaves put in and
    their features recomputed on the CPU and held equal, so that the
    CPU's descents, expansion, dedup, allocation, links and both backups
    run on the same numbers: their integer tree tensors must equal the
    card's.  Returns the captured rows and the evaluated planes (on the
    card)."""
    import torch
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM
    from alphagomoku_tpu_torch.patterns import features as FEAT
    from alphagomoku_tpu_torch.search import mcts

    bsz = state.tree.batch
    n = min(bsz, REPLAY_BOARDS)
    lanes = torch.arange(n, device=state.root_board.device)
    card, cpu = moved_state(state), moved_state(state, "cpu", lanes)
    # the replayed boards' leaves in the step's sub-major order
    leaves = (torch.arange(cfg.leaf_batch)[:, None] * bsz + torch.arange(n)[None]).flatten()
    got: dict = {}
    scan, evaluate = SSM.score_scan, mcts._evaluate

    def capture_scan(*rows):
        got["rows"] = [r.clone() for r in rows]
        return scan(*rows)

    capture_scan.launches = 0

    def record_evaluate(net_apply, variables, tables_, board, stm, raw_input, sym=None):
        out = evaluate(net_apply, variables, tables_, board, stm, raw_input, sym)
        got["board"] = board[leaves.to(board.device)].cpu()
        got["out"] = [t[leaves.to(t.device)].cpu() for t in out]
        return out

    def recording_apply(variables, planes):
        got["planes"] = planes.clone()
        return CF.fused_apply(variables, planes)

    def card_evaluate(net_apply, variables, tables_, board, stm, raw_input, sym=None):
        if not torch.equal(board, got["board"]):
            raise SystemExit(f"{tag}: the CPU replay reached other leaves than the card")
        if not torch.equal(FEAT.encode(tables_, board, stm), got["out"][5]):
            raise SystemExit(f"{tag}: the leaves' features differ between the card and the CPU")
        return tuple(got["out"])

    try:
        SSM.score_scan, mcts._evaluate = capture_scan, record_evaluate
        with torch.no_grad():
            card = mcts.make_simulate_fn(recording_apply, tables, cfg)(weights, card)
        torch.cuda.synchronize()
        SSM.score_scan, mcts._evaluate = scan, card_evaluate
        with torch.no_grad():
            cpu = mcts.make_simulate_fn(None, tables, cfg)(None, cpu)
    finally:
        SSM.score_scan, mcts._evaluate = scan, evaluate
    differ = [k for k in EXACT_TREE if not torch.equal(getattr(card.tree, k)[:n].cpu(),
                                                        getattr(cpu.tree, k))]
    if differ:
        raise SystemExit(f"{tag}: the step replayed on the CPU leaves other trees: {differ}")
    vs = (card.tree.node_value_sum[:n].cpu() - cpu.tree.node_value_sum).abs().max()
    print(f"{tag}: one step replayed on CPU copies of {n} of the {bsz} trees: the integer tree "
          f"tensors equal ({', '.join(EXACT_TREE)}); node_value_sum max |card - CPU| "
          f"{float(vs):.3g}", flush=True)
    return got


def graph_ms(fn, launches: int = 20) -> float:
    """Device milliseconds per call of `fn` (one kernel launch), by CUDA
    events around the replay of a CUDA graph of `launches` calls: the
    host's time to enqueue them does not count.  For kernels of a few
    microseconds late in the run, where torch.profiler has traced none of
    their launches (phase 22's wide scan kernel)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_cuda(graph.replay) / launches


def scan_rows_phase(rows, tag: str) -> dict:
    """score_scan against score_scan_plain on a search's captured rows,
    bit-equal, with its device time (a CUDA graph's replay, `graph_ms`),
    call and plain times and its bytes bound (as phase 3 counts them)."""
    import torch
    from alphagomoku_tpu_torch.ops import score_scan as SSM

    R, D = rows[1].shape
    K = rows[3].shape[2]
    e_k, ns_k = SSM.score_scan(*rows)
    e_p, ns_p = SSM.score_scan_plain(*rows)
    torch.cuda.synchronize()
    if not (torch.equal(e_k, e_p) and torch.equal(ns_k, ns_p)):
        raise SystemExit(f"{tag}: score_scan disagrees with the plain version on the rows")
    changed = int((e_p != rows[3].gather(2, rows[2].long()[..., None])[..., 0])[rows[1]].sum())
    kernel = "score_scan_wide_kernel" if K > 32 else "score_scan_kernel"
    ms = graph_ms(lambda: SSM.score_scan(*rows))
    call_ms = time_cuda(lambda: SSM.score_scan(*rows))
    plain_ms = time_cuda(lambda: SSM.score_scan_plain(*rows), reps=5)
    nbytes = 2 * (R + R * D * K + 3 * R * D) + (R * D * K + 3 * R * D)
    bound_ms = nbytes / HBM_BPS * 1e3
    print(f"{tag}: {kernel} bit-equal on the step's rows R={R} D={D} K={K} "
          f"({int(rows[1].sum())} valid levels, {changed} edge scores changed); kernel "
          f"{ms:.5f} ms on the device in a CUDA graph ({call_ms:.4f} ms a call), plain "
          f"{plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({nbytes} bytes at u16 scores)", flush=True)
    return dict(shape=f"R={R} D={D} K={K}", ms=ms, ms_by="cuda graph", call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, valid_levels=int(rows[1].sum()))


def utility_card_vs_cpu(state, cfg, tp, tag: str) -> float:
    """Each tree's edge utility at its root and at the root's most-visited
    child, with random virtual visits, on the card and on CPU copies of
    the tree: within UTILITY_REL, the same infinities, and the same argmax
    wherever the top two lie farther apart.  Returns the largest relative
    gap."""
    import torch
    from alphagomoku_tpu_torch.search import mcts

    tree = state.tree
    bsz, K = tree.batch, cfg.max_edges
    dev = tree.node_visits.device
    b = torch.arange(bsz, device=dev)
    root = state.root_node
    visits = mcts.edge_stats(tree, b, root).visits
    child = tree.edge_child[b, root, visits.argmax(-1)].long()
    child = torch.where(child >= 0, child, root)
    cpu_tree = type(tree)(*(t.cpu() for t in tree))
    cpu_tp = None if tp is None else tp.to("cpu")
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for node, prior in ((root, state.noisy_prior),
                        (child, tree.edge_prior[b, child].float())):
        for vl in (None, torch.randint(0, 3, (bsz, K), generator=gen, device=dev,
                                       dtype=torch.int32)):
            is_root = node == root
            args = (node, prior, vl, is_root)
            card = mcts._edge_utility(tree, cfg, *args, tp, mcts.pack_node_stats(tree)).cpu()
            cpu = mcts._edge_utility(cpu_tree, cfg, *(None if a is None else a.cpu()
                                                      for a in args), cpu_tp,
                                     mcts.pack_node_stats(cpu_tree))
            fin = torch.isfinite(cpu)
            if not torch.equal(fin, torch.isfinite(card)):
                raise SystemExit(f"{tag}: the card's utility has other infinities than the CPU's")
            gap = ((card - cpu).abs() / (cpu.abs() + 1.0))[fin]
            worst = max(worst, float(gap.max()) if gap.numel() else 0.0)
            if not torch.allclose(card[fin], cpu[fin], rtol=UTILITY_REL, atol=UTILITY_REL):
                raise SystemExit(f"{tag}: the card's utility is {worst:.3g} from the CPU's")
            top2 = torch.where(fin, cpu, float("-inf")).topk(2, -1).values
            clear = (top2[:, 0] - top2[:, 1]) > UTILITY_REL * top2[:, 0].abs() + UTILITY_REL
            if not torch.equal(card.argmax(-1)[clear], cpu.argmax(-1)[clear]):
                raise SystemExit(f"{tag}: the card's argmax differs where the top two are apart")
    return worst


def rest_of_search_phase(weights, tables, boards, stm) -> dict:
    """Phase 22, parts 1-2: the flagship at leaf_batch 4 and the
    9x9 leaf-batch search at K = 81, each with a step replayed on the CPU
    and score_scan held and timed on that step's rows; the trunk kernel
    timed on the 5,120 leaves of a step."""
    import numpy as np
    import torch
    from alphagomoku_tpu_torch.models.networks import create_network, init_random_
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.search import mcts

    t_phase = time.perf_counter()
    dev = boards.device
    out: dict = {"paths": {}}
    # 1. the flagship at leaf_batch 4
    cfg = mcts.MCTSConfig(max_nodes=808, max_edges=32, max_depth=16, leaf_batch=LEAF_BATCH)
    t0 = time.perf_counter()
    state, out["paths"]["leaf_batch"] = search_phase(weights, tables, cfg, boards, stm, LB_SIMS,
                                                     "phase 22 leaf_batch 4")
    out["step_ms"] = (time.perf_counter() - t0) / (LB_SIMS // LEAF_BATCH) * 1e3
    got = replay_step(weights, tables, cfg, state, "phase 22 leaf_batch 4")
    out["scan"] = scan_rows_phase(got["rows"], "phase 22 leaf_batch 4 score_scan")
    # the trunk kernel on the step's S * B leaves
    with torch.no_grad():
        x = weights.net.stem_forward(got["planes"]).permute(0, 2, 3, 1).contiguous()
        plain = CF.fused_trunk_plain(x, weights.trunk)
        trunk = held(plain, CF.fused_trunk(x, weights.trunk), CF.TRUNK_LIMITS)
        if not trunk["ok"]:
            raise SystemExit(f"phase 22: the trunk kernel disagrees at N={x.shape[0]}: {trunk}")
        trunk_ms = time_cuda(lambda: [CF.fused_trunk(x, weights.trunk) for _ in range(5)],
                             reps=3) / 5
    L, (N, h, w, C) = weights.trunk.dw.shape[0], x.shape
    ops_ms = (2.0 * 49 * h * w * C * N * L / F32_FLOPS
              + (2.0 * 2 * h * w * C * C + 2.0 * 2 * C * C) * N * L / BF16_TC_FLOPS) * 1e3
    out["trunk"] = dict(shape=f"N={N}", ms=trunk_ms, bound_ms=ops_ms,
                        share_differ=trunk["share_differ"])
    print(f"phase 22 trunk: the kernel on the step's {N} leaves {trunk_ms:.4f} ms on the device, "
          f"bound {ops_ms:.4f} ms (operations); against the plain trunk {describe(trunk)}",
          flush=True)
    out["state"] = state
    del x, plain, got
    # 2. 9x9 at K = 81 edge slots: the wide scan kernel
    net9 = init_random_(create_network("ConvNextPVQMraw", blocks=6, filters=64, rows=9, cols=9),
                        torch.Generator().manual_seed(LB9_SEED)).to(dev).eval()
    w9 = CF.pack_weights(net9)
    # the bench generator's 2-7 alternating stones, on 9x9
    rng = np.random.default_rng(9)
    b9 = np.zeros((LB9_BATCH, 9, 9), np.int8)
    for i in range(LB9_BATCH):
        n = rng.integers(2, 8)
        b9[i].flat[rng.choice(81, size=n, replace=False)] = np.where(np.arange(n) % 2 == 0, 1, 2)
    b9 = torch.from_numpy(b9).to(dev)
    s9 = torch.ones(LB9_BATCH, dtype=torch.int8, device=dev)
    cfg9 = mcts.MCTSConfig(max_nodes=LB9_SIMS + 8, max_edges=81, max_depth=16,
                           leaf_batch=LEAF_BATCH)
    state9, out["paths"]["leaf_batch_k81"] = search_phase(w9, tables, cfg9, b9, s9, LB9_SIMS,
                                                         "phase 22 9x9 K=81 leaf_batch 4")
    got9 = replay_step(w9, tables, cfg9, state9, "phase 22 9x9 K=81 leaf_batch 4")
    out["scan_wide"] = scan_rows_phase(got9["rows"], "phase 22 9x9 K=81 score_scan")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def search_options_phase(weights, tables, boards, stm) -> dict:
    """Phase 22, parts 3-6: every policy and init_to mode, a seeded
    quantized NNUE blended in, each generator's root move mask, and one
    SPSA step of EngineTuner, all on network_23 at B = OPTION_BATCH."""
    import numpy as np
    import torch
    from alphagomoku_tpu_torch.eval.tuner import EngineTuner
    from alphagomoku_tpu_torch.models import nnue
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM
    from alphagomoku_tpu_torch.patterns import features as FEAT
    from alphagomoku_tpu_torch.search import generators as GEN
    from alphagomoku_tpu_torch.search import mcts, static_solver
    from alphagomoku_tpu_torch.search import tree_policy as TP

    t_phase = time.perf_counter()
    dev = boards.device
    bsz = OPTION_BATCH
    boards, stm = boards[:bsz].clone(), stm[:bsz]
    base = mcts.MCTSConfig(max_nodes=OPTION_SIMS + 8, max_edges=32, max_depth=16)
    tp = TP.init_params(torch.Generator().manual_seed(TP_SEED), device=dev)
    paths, step_ms, gaps = {}, {}, {}

    def run(tag, cfg, b=boards, **kw):
        t0 = time.perf_counter()
        state, paths[tag] = search_phase(weights, tables, cfg, b, stm, OPTION_SIMS,
                                         f"phase 22 {tag}", **kw)
        step_ms[tag] = (time.perf_counter() - t0) / OPTION_SIMS * 1e3
        return state

    # 3. every policy and init_to mode
    cases = [(p, "parent") for p in mcts.POLICIES] + [("puct", m) for m in ("loss", "draw",
                                                                             "q_head")]
    for policy, init_to in cases:
        tag = f"policy_{policy}" if init_to == "parent" else f"init_{init_to}"
        cfg = base._replace(policy=policy, init_to=init_to)
        ptp = tp if policy == "learnable" else None
        state = run(tag, cfg, tp_params=ptp)
        gaps[tag] = utility_card_vs_cpu(state, cfg, ptp, f"phase 22 {tag}")
        if tag == "policy_puct":
            plain_values = mcts.root_value(state)
    print("phase 22 policies: ms per step at B=" + str(bsz) + " " + json.dumps(
        {k: round(v, 2) for k, v in step_ms.items()}) + "; the card's utilities (roots and "
        "most-visited children, with and without virtual visits) within " + str(UTILITY_REL)
        + " relative of the CPU's, largest gap " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in gaps.items()}), flush=True)

    # 4. a seeded quantized NNUE blended in
    model = nnue.NNUEModel(nnue.num_features(H, W), NNUE_HIDDEN,
                           torch.Generator().manual_seed(NNUE_SEED))
    q = nnue.quantize(model).to(dev)
    state = run("nnue", base, nnue=q)
    shift = float((mcts.root_value(state) - plain_values).abs().max())
    feats = nnue.nnue_features(tables, boards, stm)
    feats_cpu = nnue.nnue_features(tables, boards.cpu(), stm.cpu())
    if not torch.equal(feats.cpu(), feats_cpu):
        raise SystemExit("phase 22 nnue: the card's features differ from the CPU's")
    card = nnue.quantized_accumulators(q, feats)
    cpu = nnue.quantized_accumulators(nnue.quantize(model), feats_cpu)
    if not (torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])):
        raise SystemExit("phase 22 nnue: the int32 accumulators differ between card and CPU")
    tail = float(((card[2].cpu() - cpu[2]).abs() / (cpu[2].abs() + 1.0)).max())
    if shift == 0.0:
        raise SystemExit("phase 22 nnue: the blend left every root value as it was")
    print(f"phase 22 nnue: F={feats.shape[1]} features, hidden {NNUE_HIDDEN}; features and both "
          f"int32 accumulators equal between card and CPU (largest |acc| "
          f"{int(card[0].abs().max())}), logits {tail:.3g} apart relative; the blend moved root "
          f"values by up to {shift:.4f}", flush=True)

    # 5. each generator's root move mask
    sym_boards = boards.clone()
    sym_boards[:32] = 0
    sym_boards[16:32, H // 2, W // 2] = 1  # symmetric roots: empty, and a centre stone
    masks = {"center_excluding": (GEN.center_excluding_mask(bsz, H, W, 2, dev), boards),
             "center_only": (GEN.center_only_mask(bsz, H, W, 2, dev), boards),
             "symmetrical_excluding": (GEN.symmetrical_excluding_mask(sym_boards), sym_boards)}
    rb = torch.arange(bsz, device=dev)
    for name, (mask, b) in masks.items():
        state = run(f"mask_{name}", base, b, root_move_mask=mask)
        packed = FEAT.encode(tables, b, stm)
        legal = ((packed & 1) == 1) & ~(((packed >> 6) & 1) == 1)
        restrict = static_solver.analyze(packed, legal,
                                         H * W - (b != 0).sum((1, 2)).int()).restrict
        kept = (restrict & mask).flatten(1).any(-1)  # boards where the mask leaves a move
        actions = state.tree.edge_action[:, 0].long()
        visits = mcts.edge_stats(state.tree, rb, state.root_node).visits
        outside = ~mask.flatten(1).gather(1, actions.clamp(min=0)) & kept[:, None]
        bad = ((actions >= 0) & outside).any(-1) | ((visits > 0) & outside).any(-1)
        if bool(bad.any()):
            raise SystemExit(f"phase 22 mask_{name}: {int(bad.sum())} roots expanded or visited a "
                             f"cell the mask excludes")
        print(f"phase 22 mask_{name}: {int(mask[0].sum())} of {H * W} cells allowed on the first "
              f"board; every root edge and visit on an allowed cell on {int(kept.sum())} boards "
              f"(the other {int((~kept).sum())} keep their restriction: the mask left no move)",
              flush=True)

    # 6. one SPSA step of EngineTuner
    tcfg = mcts.MCTSConfig(max_nodes=TUNE_SIMS + 8, max_edges=32, max_depth=16,
                           policy="puct_fpu")
    tuner = EngineTuner(CF.fused_apply, weights, tables, tcfg, num_simulations=TUNE_SIMS,
                        games_per_step=2 * TUNE_OPENINGS, device=dev)
    grads = []
    inner = tuner.spsa.gradient_func
    tuner.spsa.gradient_func = lambda tp_, tm_: grads.append(inner(tp_, tm_)) or grads[-1]
    _zero_counts()
    t0 = time.perf_counter()
    tuned = tuner.tune(1)
    tune_s = time.perf_counter() - t0
    paths["tuner"] = _counts()
    theta = np.asarray(tuner.spsa.theta)
    if not (tuner.spsa.step == 1 and -0.5 <= grads[0] <= 0.5 and ((0 <= theta) & (theta <= 1)).all()
            and paths["tuner"]["score_backup"] > 0):
        raise SystemExit(f"phase 22 tuner: {tuner.spsa.step} steps, gradient {grads}, theta "
                         f"{theta}, launches {paths['tuner']}")
    print(f"phase 22 tuner: one SPSA step ({2 * TUNE_OPENINGS} games at {TUNE_SIMS} sims) in "
          f"{tune_s:.1f} s, gradient {grads[0]:+.4f}, theta {theta.round(4).tolist()}, tuned "
          + json.dumps({p.name: round(getattr(tuned, p.name), 4) for p in tuner.params})
          + f"; launches {paths['tuner']}", flush=True)
    return dict(paths=paths, step_ms=step_ms, gaps=gaps, tune_seconds=tune_s,
                seconds=time.perf_counter() - t_phase)


# phase 23: the last modules
ANCHOR_PAIRS = 2  # openings of the AnchorV1 match, so 4 games
ANCHOR_MATCH_SIMS = 8  # the match's shared simulations (the tool's default: 200)
# plies played after the 4-stone openings: a ply is two searches of 9
# launch-bound evaluations at B = 2 under the VCT solver, 4.8 s on the
# card (16 plies took 76.8 s, over the phase's 40 s)
ANCHOR_PLIES = 6
DP_BATCH = 256  # the DP train step's batch (the manager's train_batch_size)
DP_TIMED_STEPS = 10  # steps timed of the plain and the DP step each
RL_BATCH = 8  # boards of make_rl_round's self-play
RL_SIMS = 8
RL_MOVES = 4


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def anchor_match_phase(weights, tables) -> dict:
    """23, part 1: network_23 against AnchorV1 (`eval/anchor.py`) through
    `play_multi_match` at the anchor's configuration (`ANCHOR_MCFG`: VCT
    leaf solver, D = 32), `ANCHOR_PAIRS` openings on 15x15, the shared
    sims cut to `ANCHOR_MATCH_SIMS`, `ANCHOR_PLIES` plies: every live move
    on an empty cell, both nets' values on the final boards finite, the
    anchor's logits on every ply's boards bit-equal to its CPU copy's, and
    the launches per ply (the trunk for network_23, score_backup<32> for
    both sides)."""
    import numpy as np
    import torch
    from alphagomoku_tpu_torch.eval import anchor as A
    from alphagomoku_tpu_torch.eval import match as M
    from alphagomoku_tpu_torch.game.types import GameOutcome
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.search import mcts

    openings = M.random_openings(np.random.default_rng(0), ANCHOR_PAIRS, H, W, stones=4)
    plies, legal = [], []

    def on_ply(env, moves):
        plies.append((env.board.clone(), env.to_move.clone()))
        live = env.outcome == int(GameOutcome.UNKNOWN)
        legal.append(((env.board.flatten(1).gather(1, moves[:, None])[:, 0] == 0) | ~live).all())

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = M.play_multi_match(CF.fused_apply, weights, [A.anchor_opponent()], tables,
                             A.ANCHOR_MCFG, ANCHOR_MATCH_SIMS, openings,
                             max_moves=4 + ANCHOR_PLIES, device="cuda", on_ply=on_ply)[0]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    n_plies = len(plies)
    if not bool(torch.stack(legal).all()):
        raise SystemExit("anchor match: a move on an occupied cell")
    # the candidate's search evaluates its roots and once a step; when games
    # are cut, the match evaluates the final boards with the candidate once
    want = {"score_scan": 0, "score_backup": 2 * n_plies * ANCHOR_MATCH_SIMS,
            "fused_trunk": n_plies * (ANCHOR_MATCH_SIMS + 1) + (1 if res.truncated else 0),
            "fused_trunk_cluster": 0, "fused_trunk_wide": 0, "fused_trunk_streamed": 0}
    if launches != want:
        raise SystemExit(f"anchor match: launches {launches}, expected {want}")
    board, stm = torch.cat([b for b, _ in plies]), torch.cat([t for _, t in plies])
    planes = root_planes(tables, board, stm)
    card = A.anchor_apply({}, planes)
    cpu = A.anchor_apply({}, planes.cpu())
    if not (torch.equal(card.policy_logits.cpu(), cpu.policy_logits)
            and torch.equal(card.value_logits.cpu(), cpu.value_logits)):
        raise SystemExit("anchor match: the anchor's logits on the card differ from the CPU's")
    final, final_stm = plies[-1]
    values = [mcts._evaluate(apply, w, tables, final, final_stm, True)[1]
              for apply, w in ((CF.fused_apply, weights), (A.anchor_apply, {}))]
    if not all(bool(torch.isfinite(v).all()) for v in values):
        raise SystemExit("anchor match: a non-finite value on the final boards")
    print(f"anchor match (phase 23): network_23 vs {A.ANCHOR_VERSION}, {2 * ANCHOR_PAIRS} games "
          f"on {H}x{W} at {ANCHOR_MATCH_SIMS} sims, {n_plies} plies in {seconds:.3f} s "
          f"({seconds / n_plies:.3f} s a ply); launches {launches} "
          f"({sum(launches.values()) / n_plies:.1f} of the kernels a ply); outcomes "
          f"{res.outcomes.tolist()}, pentanomial {res.pentanomial.tolist()}, score "
          f"{res.score_a}, unfinished {res.truncated}; the anchor's logits on "
          f"{board.shape[0]} boards bit-equal to the CPU copy's", flush=True)
    return {"launches": launches, "seconds": seconds, "s_per_ply": seconds / n_plies}


def dp_step_phase(net, generation) -> dict:
    """23, parts 2 and 3: over a world-size-1 NCCL group
    (`parallel.distributed.initialize` at tcp://localhost), one DP train
    step of network_23 at batch `DP_BATCH` (`make_dp_train_step`) held
    bitwise equal to the plain train step on the same batch and modes
    (parameters, BatchNorm statistics, gradients, losses), then both timed
    over `DP_TIMED_STEPS` steps; then one `make_rl_round` (`RL_BATCH`
    boards at `RL_SIMS` sims for `RL_MOVES` moves, then a DP step: no game
    ends within `RL_MOVES` moves, so `make_targets` masks every sample,
    the losses are 0 and the step moves the parameters by its weight decay
    alone)."""
    import copy
    import numpy as np
    import torch
    import torch.distributed as dist
    from alphagomoku_tpu_torch.data import ReplayBuffer
    from alphagomoku_tpu_torch.game import vectorized as V
    from alphagomoku_tpu_torch.game.types import GameRules
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.parallel import distributed as D
    from alphagomoku_tpu_torch.parallel import make_mesh
    from alphagomoku_tpu_torch.search import mcts
    from alphagomoku_tpu_torch.selfplay import SelfplayConfig
    from alphagomoku_tpu_torch.training import train as T

    buf = ReplayBuffer()
    buf.add_generation(0, {k: v.cpu().numpy() for k, v in generation.items()})
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             buf.sample(DP_BATCH, np.random.default_rng(0)).items()}
    modes = T.draw_modes(torch.Generator(device="cuda").manual_seed(0), DP_BATCH, H, W)
    tables = V.device_tables(GameRules.FREESTYLE)
    cfg = T.TrainConfig()
    url = f"localhost:{_free_port()}"
    D.initialize(url, 1, 0, backend="nccl")
    out = {}
    try:
        mesh = make_mesh()
        nets, parts, steps = [], [], []
        for dp in (False, True):
            copy_ = copy.deepcopy(net)
            state, tx = T.create_train_state(copy_, cfg)
            step = T.make_train_step(copy_, tx, tables, cfg)
            if dp:
                step = D.make_dp_train_step(step, mesh)
                b = D.global_batch_from_local(mesh, batch)
            else:
                b = batch
            _zero_counts()
            _, p = step(state, b, modes)
            torch.cuda.synchronize()
            out["launches" if dp else "plain_launches"] = _counts()
            nets.append(copy_)
            parts.append(p)
            steps.append((step, state, b))
        plain, dpn = nets
        same = (all(torch.equal(x, y) for x, y in zip(plain.state_dict().values(),
                                                       dpn.state_dict().values()))
                and all(torch.equal(x.grad, y.grad) for x, y in zip(plain.parameters(),
                                                                    dpn.parameters()))
                and all(torch.equal(parts[0][k], parts[1][k]) for k in parts[0]))
        if not same:
            raise SystemExit("dp step: the world-size-1 NCCL DP step differs from the plain "
                             "step")
        if any(out["launches"].values()):
            raise SystemExit(f"dp step: launched a kernel {out['launches']}")
        ms = [time_cuda(lambda s=s, st=st, b=b: s(st, b, modes), reps=DP_TIMED_STEPS)
              for s, st, b in steps]
        out.update(plain_ms=ms[0], dp_ms=ms[1])
        print(f"dp step (phase 23): over NCCL at world size 1 ({url}), network_23 at batch "
              f"{DP_BATCH}: parameters, BatchNorm statistics, gradients and losses bitwise "
              f"equal to the plain step's (total {float(parts[1]['total']):.6f}); DP step "
              f"{ms[1]:.3f} ms, plain step {ms[0]:.3f} ms (medians of {DP_TIMED_STEPS}); "
              f"launches {out['launches']}", flush=True)
        del nets, steps, plain, dpn

        rl_net = copy.deepcopy(net)
        state, tx = T.create_train_state(rl_net, cfg)
        round_fn, _ = D.make_rl_round(
            CF.fused_apply, T.make_train_step(rl_net, tx, tables, cfg), tables,
            mcts.MCTSConfig(max_nodes=RL_SIMS + 8, max_edges=32, max_depth=32),
            SelfplayConfig(num_simulations=RL_SIMS, max_moves=RL_MOVES),
            batch_per_host=RL_BATCH, rows=H, cols=W, mesh=mesh)
        before = [p.detach().clone() for p in rl_net.parameters()]
        _zero_counts()
        t0 = time.perf_counter()
        state, p = round_fn(CF.pack_weights(rl_net), state, 0)
        torch.cuda.synchronize()
        out["rl_round_s"] = time.perf_counter() - t0
        out["rl_launches"] = _counts()
        moved = any(not torch.equal(a, b) for a, b in zip(before, rl_net.parameters()))
        if not (moved and all(bool(torch.isfinite(v)) for v in p.values())
                and float(p["total"]) == 0.0):
            raise SystemExit(f"rl round: parameters moved {moved}, losses {p}")
        print(f"rl round (phase 23): {RL_BATCH} boards x {RL_MOVES} moves at {RL_SIMS} sims, "
              f"then one DP step: {out['rl_round_s']:.3f} s, total loss "
              f"{float(p['total']):.5f} (every sample masked: no game ends in {RL_MOVES} moves), "
              f"parameters moved by the weight decay; launches {out['rl_launches']}", flush=True)
    finally:
        dist.destroy_process_group()
    return out


def last_modules_phase(net, weights, tables, generation) -> dict:
    """23. the last modules: `anchor_match_phase`, then `dp_step_phase`."""
    t0 = time.perf_counter()
    anchor = anchor_match_phase(weights, tables)
    dp = dp_step_phase(net, generation)
    seconds = time.perf_counter() - t0
    print(f"phase 23: {seconds:.1f} s by its own clock (the anchor match "
          f"{anchor['seconds']:.1f} s)", flush=True)
    return {"seconds": seconds, "paths": {"anchor_match": anchor["launches"],
                                          "dp_step": dp["launches"],
                                          "rl_round": dp["rl_launches"]},
            "anchor": anchor, "dp": dp}


# phase 24: the trunk kernel at the widths and boards the kernel is built
# for only through padding, the cluster entry or the wide entry
TRUNK_SHAPES = {  # tag -> (filters, blocks, batch, rows, cols)
    "C=16 15x15": (16, 2, 64, 15, 15),  # the dry run's round network, padded to 64
    "C=96 15x15": (96, 6, 64, 15, 15),  # padded to 128
    "C=128 16x16": (128, 8, 32, 16, 16),  # the cluster entry
    "C=128 20x20": (128, 8, 32, 20, 20),
    "C=256 15x15": (256, 8, 32, 15, 15),  # the wide entry, 2 CTAs a board
    "C=256 20x20": (256, 8, 32, 20, 20),  # 5 CTAs a board
    "C=192 15x15": (192, 6, 32, 15, 15),  # padded to 256
    "C=136 16x16": (136, 2, 32, 16, 16),  # padded to 256, 3 CTAs a board
    "C=384 15x15": (384, 8, 32, 15, 15),  # the streamed entry, 4 L + 1 launches a call
    "C=384 20x20": (384, 8, 32, 20, 20),
    "C=512 20x20": (512, 2, 32, 20, 20),
    "C=300 16x16": (300, 2, 32, 16, 16),  # padded to 320
    "C=1024 9x9": (1024, 1, 8, 9, 9),
}
SHAPES_SEED = 0  # torch.Generator seed of each network's weights
SEARCH20_BATCH = 64  # boards of the 20x20 searches (8x128, 8x256, 8x384)
SEARCH20_SIMS = 1  # the counted search: one simulation step, cold
SEARCH20_TIMED = 5  # steps timed after it, one warm-up step first
WIDE256_SIMS = 50  # the 8x256 search at the bench configuration (B = 1280, 15x15)
WIDE384_SIMS = 16  # the 8x384 search at the bench configuration
VECTORIZED_BOARDS = 64  # seeded boards of the vectorized functions' card check


def random_boards(batch: int, rows: int, cols: int, seed: int = 0):
    """`bench_boards`' generator on rows x cols boards."""
    import numpy as np

    rng = np.random.default_rng(seed)
    boards = np.zeros((batch, rows, cols), np.int8)
    for b in range(batch):
        n = rng.integers(2, 8)
        cells = rng.choice(rows * cols, size=n, replace=False)
        boards[b].flat[cells] = np.where(np.arange(n) % 2 == 0, 1, 2)
    return boards


def search20_phase(weights, tables, tag: str, trunk_entry: str) -> tuple[dict, list[float]]:
    """One counted simulation step of `weights` on `SEARCH20_BATCH` seeded
    20x20 boards (`search_phase`, every trunk launch `trunk_entry`'s), then
    `SEARCH20_TIMED` warm steps on from its tree, each timed.  Returns the
    launches and the warm steps' ms."""
    import torch
    from alphagomoku_tpu_torch.game.types import CROSS
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.search import mcts

    boards = torch.from_numpy(random_boards(SEARCH20_BATCH, 20, 20, seed=1)).to("cuda")
    stm = torch.full((SEARCH20_BATCH,), CROSS, dtype=torch.int8, device="cuda")
    cfg = mcts.MCTSConfig(max_nodes=16, max_edges=32, max_depth=16)
    state, launches = search_phase(weights, tables, cfg, boards, stm, SEARCH20_SIMS, tag,
                                   trunk_entry=trunk_entry)
    # the step's time: warm steps on from that search's tree (1 + 1 +
    # SEARCH20_TIMED simulations stay within max_nodes)
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, cfg)
    step_ms = []
    with torch.no_grad():
        for i in range(1 + SEARCH20_TIMED):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state = simulate(weights, state)
            torch.cuda.synchronize()
            if i:
                step_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"{tag}: {SEARCH20_TIMED} warm simulation steps at batch {SEARCH20_BATCH} after one "
          f"warm-up step: median {statistics.median(step_ms):.3f} ms, min {min(step_ms):.3f} "
          f"ms, max {max(step_ms):.3f} ms (the line above times one cold step with the roots' "
          "evaluation)", flush=True)
    return launches, step_ms


def engine_wide_phase(filters: int, entry: str) -> dict:
    """The launcher's engine with a seeded 8-block network of `filters`
    (`ProgramManager(blocks=8, filters=filters)`): START 20 and one TURN,
    its search cut to one chunk of `ENGINE_MAX_NODE` sims at B = 1; the
    answer on an empty cell, every trunk launch `entry`'s."""
    import io

    from alphagomoku_tpu_torch.engine.manager import ProgramManager

    tag = f"engine 8x{filters}"
    mgr = ProgramManager(protocol="extended", blocks=8, filters=filters, device="cuda",
                         instream=None, outstream=io.StringIO())
    _zero_counts()
    with _EngineLog() as log:
        out = _drive(mgr, "START 20", f"INFO max_node {ENGINE_MAX_NODE}", "TURN 10,10")
    launches = _counts()
    answers = _answers(out)
    if len(log.searches) != 1 or len(answers) != 1:
        raise SystemExit(f"{tag}: {len(log.searches)} searches, answered {out}")
    s = log.searches[0]
    steps = s["timings"].get("steps", 0)
    want = {"score_scan": 0, "score_backup": steps, "fused_trunk": steps + 1,
            "fused_trunk_cluster": 0, "fused_trunk_wide": 0, "fused_trunk_streamed": 0}
    want[entry] = steps + 1
    if steps < 1 or launches != want:
        raise SystemExit(f"{tag}: {steps} steps, launches {launches} (expected {want})")
    row, col = map(int, answers[0].split(","))
    if s["board"][row, col] != 0 or (row, col) == (10, 10):
        raise SystemExit(f"{tag}: answered the occupied cell {answers[0]}")
    step_ms = 1e3 * s["timings"]["simulate"] / steps
    print(f"{tag} 20x20 (seeded): answer {answers[0]} in {s['seconds']:.2f} s, "
          f"{steps} steps, {step_ms:.2f} ms per step, launches {launches}", flush=True)
    return dict(launches=launches, seconds=s["seconds"], step_ms=step_ms, steps=steps)


def vectorized_on_card(tables) -> None:
    """`vectorized.windows_at_many` and `pattern_types` (int64 windows) on
    the card, bit-equal to the same calls on the CPU (which
    tests/test_torch_vectorized_rest.py holds against the JAX package)."""
    import numpy as np
    import torch
    from alphagomoku_tpu_torch.game import vectorized as V

    rng = np.random.default_rng(3)
    board = torch.from_numpy(rng.choice(np.array([0, 1, 2], np.int8),
                                        size=(VECTORIZED_BOARDS, H, W), p=[0.5, 0.25, 0.25]))
    rows = torch.from_numpy(rng.integers(-1, H + 1, size=(VECTORIZED_BOARDS, 32)))
    cols = torch.from_numpy(rng.integers(0, W, size=(VECTORIZED_BOARDS, 32)))
    circle = torch.from_numpy(rng.random((VECTORIZED_BOARDS, 1)) < 0.5)
    cpu_w = V.windows_at_many(board, rows, cols)
    cpu_p = V.pattern_types(tables, cpu_w, circle)
    card_w = V.windows_at_many(board.cuda(), rows.cuda(), cols.cuda())
    card_p = V.pattern_types(tables, card_w, circle.cuda())
    if not (torch.equal(card_w.cpu(), cpu_w) and torch.equal(card_p.cpu(), cpu_p)):
        raise SystemExit("vectorized: windows_at_many or pattern_types differ on the card")
    print(f"vectorized: windows_at_many and pattern_types on the card bit-equal to the CPU on "
          f"{VECTORIZED_BOARDS} boards x 32 queries ({int((cpu_p > 0).sum())} nonzero "
          "pattern types)", flush=True)


def bench_wide_phase(tables, boards, stm, filters: int, sims: int, entry: str) -> dict:
    """The seeded 8-block network of `filters` at the bench configuration
    (`boards`, `stm`): its trunk held and timed at B = 1280 (`trunk_phase`,
    the plain trunk timed once), `sims` sims of its search, every trunk
    launch `entry`'s, and its next steps traced."""
    import torch
    from alphagomoku_tpu_torch.models.networks import create_network, init_random_
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.search import mcts

    net = init_random_(create_network("ConvNextPVQMraw", blocks=8, filters=filters),
                       torch.Generator().manual_seed(SHAPES_SEED)).to("cuda").eval()
    weights = CF.pack_weights(net)
    trunk = trunk_phase(net, root_planes(tables, boards, stm), f"fused_trunk {filters}",
                        plain_reps=1)
    cfg = mcts.MCTSConfig(max_nodes=808, max_edges=32, max_depth=16)
    state, launches = search_phase(weights, tables, cfg, boards, stm, sims,
                                   f"search 8x{filters}", trunk_entry=entry)
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, cfg)
    print(profile_steps(simulate, weights, state, PROFILE_STEPS).replace(
        "profile:", f"profile 8x{filters}:"), flush=True)
    return {"trunk": trunk, "launches": launches}


def trunk_shapes_phase(tables, boards, stm) -> dict:
    """24. The trunk kernel at each of `TRUNK_SHAPES` (a seeded
    `init_random_` network built for the board), through `trunk_phase`:
    held within TRUNK_LIMITS of the plain trunk, block by block within
    BLOCK_LIMITS, a left-out bias rejected, timed beside the plain and
    library trunks and the bound, with the entry's occupancy; then one
    simulation step of the 8x128 network on 20x20 boards, in which every
    trunk launch is the cluster entry's, and warm steps on from its tree,
    each timed; the same for the 8x256 network, on the wide entry, and the
    8x384 network, on the streamed entry; the seeded 8x256 and 8x384
    networks at the bench configuration (`boards`, `stm`, `bench_wide_phase`:
    `WIDE256_SIMS` and `WIDE384_SIMS` sims); the launcher's engine at 8x256
    and 8x384; the two vectorized functions on the card."""
    import torch
    from alphagomoku_tpu_torch.game.types import CROSS
    from alphagomoku_tpu_torch.models.networks import create_network, init_random_
    from alphagomoku_tpu_torch.ops import convnext_fused as CF

    t0 = time.perf_counter()
    out, nets = {}, {}
    for tag, (filters, blocks, batch, rows, cols) in TRUNK_SHAPES.items():
        net = init_random_(create_network("ConvNextPVQMraw", blocks, filters, rows, cols),
                           torch.Generator().manual_seed(SHAPES_SEED)).to("cuda").eval()
        b = torch.from_numpy(random_boards(batch, rows, cols)).to("cuda")
        s = torch.full((batch,), CROSS, dtype=torch.int8, device="cuda")
        out[tag] = trunk_phase(net, root_planes(tables, b, s), f"fused_trunk {tag}")
        out[tag]["plan"] = CF.trunk_plan(filters, rows, cols)._asdict()
        if tag in ("C=128 20x20", "C=256 20x20", "C=384 20x20"):
            nets[tag] = net
    searches20 = {}
    for tag, entry in (("C=128 20x20", "fused_trunk_cluster"), ("C=256 20x20", "fused_trunk_wide"),
                       ("C=384 20x20", "fused_trunk_streamed")):
        filters = TRUNK_SHAPES[tag][0]
        searches20[filters] = search20_phase(CF.pack_weights(nets[tag]), tables,
                                             f"search 8x{filters} 20x20", entry)
    del nets

    bench256 = bench_wide_phase(tables, boards, stm, 256, WIDE256_SIMS, "fused_trunk_wide")
    bench384 = bench_wide_phase(tables, boards, stm, 384, WIDE384_SIMS, "fused_trunk_streamed")
    engine256 = engine_wide_phase(256, "fused_trunk_wide")
    engine384 = engine_wide_phase(384, "fused_trunk_streamed")
    vectorized_on_card(tables)
    seconds = time.perf_counter() - t0
    print(f"phase 24: {seconds:.1f} s by its own clock", flush=True)
    return {"shapes": out, "launches": searches20[128][0], "step_ms": searches20[128][1],
            "launches_8x256_20x20": searches20[256][0],
            "step_ms_8x256_20x20": searches20[256][1],
            "launches_8x384_20x20": searches20[384][0],
            "step_ms_8x384_20x20": searches20[384][1],
            "trunk256": bench256["trunk"], "launches_8x256": bench256["launches"],
            "trunk384": bench384["trunk"], "launches_8x384": bench384["launches"],
            "engine_8x256": engine256, "engine_8x384": engine384, "seconds": seconds}


DRYRUN_N = 2  # processes of tools/dryrun_multichip.py on the one card (tp = 2)
DRYRUN_REPS = 3  # steps timed of the tp step and of the plain step


def tensor_parallel_phase() -> dict:
    """25. `tools/dryrun_multichip.py` at n = 2 (tp = 2) as child processes
    on the one card over gloo with CUDA tensors: the float32 flagship's
    column-parallel step held against the plain step on the card within
    the CPU test's constants and both timed, the flagship's bf16 step on
    the reference's batch, and one `make_rl_round` of a 2x16 network (the
    trunk kernel at 16 channels, padded) with its launches on rank 0."""
    import torch

    torch.cuda.empty_cache()  # the children need the card's memory
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "alphagomoku_tpu_torch.tools.dryrun_multichip", "--n",
         str(DRYRUN_N), "--device", "cuda", "--check", "--reps", str(DRYRUN_REPS),
         "--timeout", "500"], cwd=ROOT, capture_output=True, text=True, timeout=560)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"tensor parallelism: dryrun_multichip exited {proc.returncode}:\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    check = res["check"]
    if not (check["ok"] and res["mesh"] == {"dp": 1, "tp": 2} and res["backend"] == "gloo"):
        raise SystemExit(f"tensor parallelism: {res}")
    if not (res["rl_launches"]["fused_trunk"] > 0 and res["rl_launches"]["score_backup"] > 0):
        raise SystemExit(f"tensor parallelism: the round's searches missed the kernels: {res}")
    for line in lines[:-1]:
        print(f"tensor parallelism: {line}", flush=True)
    print(f"tensor parallelism (phase 25): dryrun_multichip n={DRYRUN_N} on one card over gloo, "
          f"mesh {res['mesh']}: the float32 flagship's tp step against the plain step at batch "
          f"256: parameters {check['param_max_abs_err']:.3g} apart (limit "
          f"{check['limits']['param_atol']:g}), gradients {check['grad_max_abs_err']:.3g} of "
          f"{check['grad_scale']:.3g} (limit {check['limits']['grad_rel']:g} of it), total loss "
          f"{check['losses']['total']:.6f} against {check['plain_losses']['total']:.6f}; tp step "
          f"{check['tp_step_ms']:.3f} ms, plain step {check['plain_step_ms']:.3f} ms (means of "
          f"{DRYRUN_REPS}); bf16 train step {res['train_step_s']:.3f} s, losses "
          f"{res['train_losses']}; rl round {res['rl_round_s']:.3f} s, losses "
          f"{res['rl_losses']}, valid samples on rank 0 {res['rl_valid_samples']}, launches on "
          f"rank 0 {res['rl_launches']}; {seconds:.1f} s in all", flush=True)
    res["seconds"] = seconds
    return res


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from alphagomoku_tpu_torch.game import vectorized as V
    from alphagomoku_tpu_torch.game.types import GameRules, CROSS
    from alphagomoku_tpu_torch.models.convert import network_from_flax
    from alphagomoku_tpu_torch.models.networks import create_network, init_random_
    from alphagomoku_tpu_torch.ops import _build
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM
    from alphagomoku_tpu_torch.search import mcts
    from alphagomoku_tpu_torch.search import vct_batched
    from alphagomoku_tpu_torch.utils import checkpoint

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in (_build.BUILD_DIR / "build.log").read_text().splitlines()
             if "registers" in ln] if (_build.BUILD_DIR / "build.log").exists() else []
    print(f"build: {build_s:.1f} s -> {lib_path.relative_to(ROOT)}; ptxas: {ptxas}", flush=True)

    kernels = []

    # 3. score_scan at the bench shape (not on the search's path since
    # score_backup took backup B over; held here as the Pallas kernel's
    # interface on the same scan core)
    R, D, K = BATCH, 16, 32
    start, valid, sl, es, ea, comp, ns = (
        torch.from_numpy(a).to(dev) for a in random_scan_inputs(R, D, K, seed=0)
    )
    scan_args = (start, valid, sl, es, ea, comp, ns)
    e_k, ns_k = SSM.score_scan(*scan_args)
    e_p, ns_p = SSM.score_scan_plain(*scan_args)
    torch.cuda.synchronize()
    if not (torch.equal(e_k, e_p) and torch.equal(ns_k, ns_p)):
        raise SystemExit("score_scan: kernel disagrees with the plain version")
    scan_ms = kernel_device_ms(lambda: SSM.score_scan(*scan_args), "score_scan_kernel")
    scan_call_ms = time_cuda(lambda: SSM.score_scan(*scan_args))
    scan_plain_ms = time_cuda(lambda: SSM.score_scan_plain(*scan_args))
    # the bytes the function needs, as the Pallas kernel's interface has
    # them: u16 scores (start, es, ns and the two outputs), a byte for each
    # mask and slot; the port's tree stores scores as int32
    scan_bytes = 2 * (R + R * D * K + 3 * R * D) + (R * D * K + 3 * R * D)
    stored_bytes = sum(t.numel() * t.element_size() for t in scan_args) + 2 * R * D * 4
    scan_bound_ms = scan_bytes / HBM_BPS * 1e3
    print(f"score_scan: bit-equal at R={R} D={D} K={K}; kernel {scan_ms:.4f} ms on the "
          f"device ({scan_call_ms:.4f} ms a call), plain {scan_plain_ms:.4f} ms, bound "
          f"{scan_bound_ms:.5f} ms ({scan_bytes} bytes at u16 scores; "
          f"{stored_bytes / HBM_BPS * 1e3:.5f} ms at the port's int32 storage, "
          f"{stored_bytes} bytes)", flush=True)
    occupancy = {f"D={d}": SSM.scan_occupancy(d) for d in (D, 48)}
    print("score_scan occupancy: " + "; ".join(
        f"{name} at {depth}: {o['registers']} registers per thread, {o['blocks_per_sm']} "
        f"blocks per SM, {o['local_bytes']} bytes of local memory (spills) per thread"
        for depth, occ in occupancy.items() for name, o in occ.items()), flush=True)
    if any(o["local_bytes"] for occ in occupancy.values() for o in occ.values()):
        raise SystemExit(f"score_scan: a scan kernel spills to local memory: {occupancy}")
    kernels.append(dict(
        name="score_scan", route="cuda", source="alphagomoku_tpu_torch/csrc/score_scan.cu",
        replaces="alphagomoku_tpu/ops/score_scan.py:111", status="bit-equal", max_abs_err=0.0,
        ms=scan_ms, call_ms=scan_call_ms, plain_ms=scan_plain_ms, bound_ms=scan_bound_ms,
        bound_by="bytes", library_ms=None, **occupancy[f"D={D}"]["score_scan"],
    ))

    # 4. score_backup on random trees at the bench shape
    rand_tree = {k: torch.from_numpy(v).to(dev) for k, v in
                 random_backup_inputs(BATCH, 808, D, K, seed=1).items()}
    backup_random = backup_phase(rand_tree, "score_backup")
    del rand_tree

    # 21, part 1. score_scan and score_backup at K > 32 (the wide kernels)
    wide = wide_kernels_phase()

    # 5. fused_trunk at B = 1280, C = 64, L = 6 with network_23
    net = network_from_flax(checkpoint.load(CKPT)).to(dev)
    weights = CF.pack_weights(net)
    tables = V.device_tables(GameRules.FREESTYLE)
    boards = torch.from_numpy(bench_boards(BATCH)).to(dev)
    stm = torch.full((BATCH,), CROSS, dtype=torch.int8, device=dev)
    planes = root_planes(tables, boards, stm)
    trunk64 = trunk_phase(net, planes, "fused_trunk")

    # 6. network: fused forward, kernel trunk vs plain trunk
    network_phase(weights, planes, "network")

    # 7. search at the bench configuration, and score_backup on its tree
    cfg = mcts.MCTSConfig(max_nodes=808, max_edges=32, max_depth=16)
    t0 = time.perf_counter()
    state, launches = search_phase(weights, tables, cfg, boards, stm, SIMS, "search")
    flagship_step_ms = (time.perf_counter() - t0) / SIMS * 1e3
    paths = {"flagship": launches}
    tree = state.tree
    pn, ps, leaf_score = most_visited_paths(tree, cfg.max_depth)
    # half the paths start from their leaf's score, half from the random
    # generator's proven and unknown scores
    rand_start = torch.from_numpy(random_scan_inputs(BATCH, 1, K, seed=2)[0]).to(dev)
    start = torch.where(torch.arange(BATCH, device=dev) % 2 == 0, leaf_score, rand_start)
    backup_flagship = backup_phase(dict(
        edge_score=tree.edge_score, edge_action=tree.edge_action,
        node_complete=tree.node_complete, node_score=tree.node_score, pn=pn, ps=ps,
        start_score=start), "score_backup on the flagship tree")
    kernels.append(dict(
        name="score_backup", route="cuda", source="alphagomoku_tpu_torch/csrc/score_scan.cu",
        replaces="alphagomoku_tpu/ops/score_scan.py:111", status="bit-equal", max_abs_err=0.0,
        bound_by="bytes", library_ms=None, **backup_flagship, random_trees=backup_random,
        **occupancy[f"D={D}"]["score_backup"],
    ))
    del tree, pn, ps, leaf_score, start

    # 20. the playing engine through the port's ProgramManager, before the
    # first trace of search steps: after such traces torch.profiler catches
    # no lone launch of a few microseconds, and phase 20 times score_backup
    # on the engine's tree by lone launches
    engine = engine_phase()
    paths["engine"] = engine["launches"]
    kernels[-1].update(engine["score_backup"])

    # 22. the rest of search: the flagship at leaf_batch 4 and a 9x9
    # leaf-batch search at K = 81, then every policy and init_to mode, the
    # NNUE blend, the root move masks and one SPSA step; last the
    # leaf_batch 4 steps traced
    rest = rest_of_search_phase(weights, tables, boards, stm)
    options = search_options_phase(weights, tables, boards, stm)
    paths.update(rest["paths"])
    paths.update(options["paths"])
    t0 = time.perf_counter()
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, cfg._replace(leaf_batch=LEAF_BATCH))
    prof4 = profile_steps(simulate, weights, rest.pop("state"), PHASE22_PROFILE_STEPS)
    print(prof4.replace("profile:", "profile leaf_batch 4:"), flush=True)
    phase22_s = rest["seconds"] + options["seconds"] + time.perf_counter() - t0
    print(f"phase 22: {phase22_s:.1f} s by its own clock (leaf-batch searches "
          f"{rest['seconds']:.1f} s, options {options['seconds']:.1f} s, of it the SPSA step "
          f"{options['tune_seconds']:.1f} s)", flush=True)
    del simulate

    # 8. profile: the next steps of the same search, traced
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, cfg)
    prof1 = profile_steps(simulate, weights, state, PROFILE_STEPS)
    print(prof1, flush=True)
    del state, simulate
    s1, s4 = (json.loads(p.split(":", 1)[1]) for p in (prof1, prof4))
    print(f"phase 22 leaf_batch {LEAF_BATCH} against 1 (the flagship, B={BATCH}): "
          f"{rest['step_ms']:.3f} against {flagship_step_ms:.3f} ms per step "
          f"({rest['step_ms'] / LEAF_BATCH:.3f} against {flagship_step_ms:.3f} ms per simulation "
          f"a tree), {s4['kernel_launches_per_step']:.1f} against "
          f"{s1['kernel_launches_per_step']:.1f} launches per traced step, device busy "
          f"{s4['device_busy_share']:.3f} against {s1['device_busy_share']:.3f} of it", flush=True)

    # 9-10. the trunk and the network at C = 128 (8x128, seeded weights)
    wide_net = init_random_(create_network("ConvNextPVQMraw", blocks=8, filters=128),
                            torch.Generator().manual_seed(WIDE_SEED)).to(dev).eval()
    wide_weights = CF.pack_weights(wide_net)
    trunk128 = trunk_phase(wide_net, planes, "fused_trunk 128")
    network_phase(wide_weights, planes, "network 128")

    # 11. the 8x128 search
    state, paths["8x128"] = search_phase(wide_weights, tables, cfg, boards, stm, WIDE_SIMS,
                                         "search 8x128")
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, cfg)
    print(profile_steps(simulate, wide_weights, state, PROFILE_STEPS).replace(
        "profile:", "profile 8x128:"), flush=True)
    del state, simulate

    # 24. the trunk at padded widths and through the cluster and wide
    # entries, one step of the 8x128 and 8x256 networks on 20x20 boards,
    # the 8x256 search at the bench configuration and the 8x256 engine
    shapes = trunk_shapes_phase(tables, boards, stm)
    paths["search_20x20"] = shapes["launches"]
    paths["search_8x256_20x20"] = shapes["launches_8x256_20x20"]
    paths["8x256"] = shapes["launches_8x256"]
    paths["engine_8x256"] = shapes["engine_8x256"]["launches"]
    paths["search_8x384_20x20"] = shapes["launches_8x384_20x20"]
    paths["8x384"] = shapes["launches_8x384"]
    paths["engine_8x384"] = shapes["engine_8x384"]["launches"]

    # 12. the strength search: network_23 and the VCT leaf solver (bench.py's
    # strength configuration)
    scfg = cfg._replace(leaf_solver="vct", leaf_solver_steps=16, leaf_solver_cap=256)
    roots = vct_batched.solve(tables, boards, stm, max_depth=scfg.leaf_solver_depth,
                              max_steps=4 * scfg.leaf_solver_steps,
                              max_threes=scfg.leaf_solver_threes)
    print(f"search strength: the root solve ({4 * scfg.leaf_solver_steps} transitions) proves "
          f"{int(roots.win.sum())} of {BATCH} roots", flush=True)
    state, paths["strength"] = search_phase(weights, tables, scfg, boards, stm, STRENGTH_SIMS,
                                            "search strength")

    # 13. profile of the strength search
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, scfg)
    print(profile_steps(simulate, weights, state, PROFILE_STEPS).replace(
        "profile:", "profile strength:"), flush=True)
    del state, simulate

    # 14. the strength search with the loss prover (bench.py's fourth
    # configuration), and its profile
    lcfg = scfg._replace(loss_prover=True, loss_cap=32, loss_options=8)
    state, paths["loss_prover"] = search_phase(weights, tables, lcfg, boards, stm, LOSS_SIMS,
                                               "search loss_prover")
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, lcfg)
    print(profile_steps(simulate, weights, state, PROFILE_STEPS).replace(
        "profile:", "profile loss_prover:"), flush=True)
    del state, simulate

    # 15. the same search under renju with the VCF leaf solver, on the
    # bench boards and on clustered boards with forbidden cells
    renju = V.device_tables(GameRules.RENJU)
    rcfg = lcfg._replace(leaf_solver="vcf")
    state, paths["renju"] = renju_search_phase(weights, renju, rcfg, boards, stm, RENJU_SIMS,
                                               "search renju", need_forbidden=False)
    simulate = mcts.make_simulate_fn(CF.fused_apply, renju, rcfg)
    print(profile_steps(simulate, weights, state, PROFILE_STEPS).replace(
        "profile:", "profile renju:"), flush=True)
    del state, simulate
    clustered = torch.from_numpy(clustered_boards(BATCH)).to(dev)
    renju_search_phase(weights, renju, rcfg, clustered, stm, CLUSTER_SIMS,
                       "search renju clustered", need_forbidden=True)

    # 16. the renju solvers on the card against CPU copies
    solvers_phase(renju)

    # 17-18. self-play at the training manager's configuration, and to the
    # end of every game
    selfplay_tree, generation = selfplay_phases(weights, tables, paths)
    next(k for k in kernels if k["name"] == "score_backup")["selfplay_tree"] = selfplay_tree

    # 19. the training loop: the manager resumed from the reference run on
    # the generation of phase 18, a train iteration, the kernels on the
    # trained weights, gating
    trained = train_phase(paths, generation)

    # 21, parts 2-4. the network zoo, an engine move with Transformer_v2,
    # and --selfcheck
    zoo = zoo_phase(generation, backup_flagship["ms"])
    paths.update({(f if f in ("engine_transformer", "selfcheck") else f"zoo_{f}"): n
                  for f, n in zoo["paths"].items()})
    print(f"phase 21: {wide['seconds'] + zoo['seconds']:.1f} s by its own clock (part 1 "
          f"{wide['seconds']:.1f} s, parts 2-4 {zoo['seconds']:.1f} s); zoo ms per simulation "
          f"step at B={ZOO_BATCH}: " + json.dumps({k: round(v, 3) for k, v in
                                                  zoo["step_ms"].items()}), flush=True)

    # 23. the last modules: an AnchorV1 match, the DP train step over NCCL
    # at world size 1 and one make_rl_round
    last = last_modules_phase(net, weights, tables, generation)
    paths.update(last["paths"])

    # 25. tensor parallelism: tools/dryrun_multichip.py at n = 2 on this card
    tensor = tensor_parallel_phase()
    paths["dryrun_train_step"] = tensor["train_launches"]
    paths["dryrun_rl_round"] = tensor["rl_launches"]

    trunk = dict(name="fused_trunk", route="cuda",
                 source="alphagomoku_tpu_torch/csrc/convnext_trunk.cu",
                 replaces="alphagomoku_tpu/ops/convnext_fused.py:92", **trunk64)
    trunk["widths"] = {"64": dict(trunk64, launches=paths["flagship"]["fused_trunk"]),
                       "128": dict(trunk128, launches=paths["8x128"]["fused_trunk"]),
                       "16 (padded to 64)": dict(
                           shapes["shapes"]["C=16 15x15"],
                           launches=paths["dryrun_rl_round"]["fused_trunk"]),
                       "96 (padded to 128)": shapes["shapes"]["C=96 15x15"]}
    trunk.update(trained)
    trunk["engine_b1"] = engine["fused_trunk"]
    trunk["leaf_batch"] = rest["trunk"]
    kernels.append(trunk)
    cluster = shapes["shapes"]["C=128 20x20"]
    kernels.append(dict(
        name="fused_trunk_cluster", route="cuda",
        source="alphagomoku_tpu_torch/csrc/convnext_trunk.cu",
        replaces="alphagomoku_tpu/ops/convnext_fused.py:92", shape="C=128 L=8 20x20",
        **cluster, boards={"16x16": shapes["shapes"]["C=128 16x16"], "20x20": cluster}))
    kernels.append(dict(
        name="fused_trunk_wide", route="cuda",
        source="alphagomoku_tpu_torch/csrc/convnext_trunk.cu",
        replaces="alphagomoku_tpu/ops/convnext_fused.py:92", shape="C=256 L=8 B=1280 15x15",
        **shapes["trunk256"], shapes={t: shapes["shapes"][t] for t in
                                      ("C=256 15x15", "C=256 20x20", "C=192 15x15",
                                       "C=136 16x16")},
        engine_8x256=shapes["engine_8x256"],
        step_ms_8x256_20x20=shapes["step_ms_8x256_20x20"]))
    kernels.append(dict(
        name="fused_trunk_streamed", route="cuda",
        source="alphagomoku_tpu_torch/csrc/convnext_trunk_streamed.cu",
        replaces="alphagomoku_tpu/ops/convnext_fused.py:92", shape="C=384 L=8 B=1280 15x15",
        **shapes["trunk384"], shapes={t: shapes["shapes"][t] for t in
                                      ("C=384 15x15", "C=384 20x20", "C=512 20x20",
                                       "C=300 16x16", "C=1024 9x9")},
        engine_8x384=shapes["engine_8x384"],
        step_ms_8x384_20x20=shapes["step_ms_8x384_20x20"]))
    top = "K=81 D=16"  # the wide entries' headline shape: the selfcheck's K
    for name in ("score_scan", "score_backup"):
        kernels.append(dict(
            name=f"{name}_wide", route="cuda", source="alphagomoku_tpu_torch/csrc/score_scan.cu",
            replaces="alphagomoku_tpu/ops/score_scan.py:111", status="bit-equal", max_abs_err=0.0,
            bound_by="bytes", library_ms=None, shape=top, **wide["entries"][name][top],
            shapes=wide["entries"][name], **wide["occupancy"][name],
            occupancy_by_k={k: occ[name] for k, occ in wide["occupancy_by_k"].items()}))
    # score_scan's headline is the leaf-batch search's rows, where backup B
    # launches it; phase 3's random rows and phase 21's shapes stay beside
    timing = ("shape", "ms", "call_ms", "plain_ms", "bound_ms")
    for name, rows in (("score_scan", rest["scan"]), ("score_scan_wide", rest["scan_wide"])):
        k = next(k for k in kernels if k["name"] == name)
        k["random_rows"] = {t: k[t] for t in timing if t in k}
        k.update(rows)
    # the paths at K > 32: the selfcheck's search and the 9x9 leaf-batch one
    wide_paths = ("selfcheck", "leaf_batch_k81")
    main_path = {"score_scan": "leaf_batch", "score_backup": "flagship",
                 "fused_trunk": "flagship", "score_scan_wide": "leaf_batch_k81",
                 "score_backup_wide": "selfcheck", "fused_trunk_cluster": "search_20x20",
                 "fused_trunk_wide": "8x256", "fused_trunk_streamed": "8x384"}
    for k in kernels:
        # the K > 32 scan entries count with their wrappers; the trunk's
        # cluster, wide and streamed entries have counts of their own
        wide_kernel = k["name"] in ("score_scan_wide", "score_backup_wide")
        wrapper = k["name"].removesuffix("_wide") if wide_kernel else k["name"]
        k["launches"] = paths[main_path[k["name"]]][wrapper]
        k["launches_by_path"] = {p: n[wrapper] for p, n in paths.items()
                                 if (p in wide_paths) == wide_kernel}
    # the wide and streamed entries run on their own paths and no other
    for entry, own in (("fused_trunk_wide", ("search_8x256_20x20", "8x256", "engine_8x256")),
                       ("fused_trunk_streamed",
                        ("search_8x384_20x20", "8x384", "engine_8x384"))):
        elsewhere = {p: n[entry] for p, n in paths.items() if p not in own and n[entry]}
        if elsewhere or not all(paths[p][entry] for p in own):
            raise SystemExit(f"{entry}: launched off its paths or not on them: "
                             f"{ {p: n[entry] for p, n in paths.items()} }")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
