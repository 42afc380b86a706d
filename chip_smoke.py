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
  8. profile - 5 more steps of the same search under torch.profiler: the
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
then a `kernels` JSON line and, last, {"ok": true, "device": {...}}.

A kernel's `ms` is its device time per launch: for score_scan and
score_backup as torch.profiler traces it (score_backup's on the flagship
tree's paths), for the trunk (2.8 ms and more a launch) by CUDA
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

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "runs" / "flagship_r4" / "checkpoint" / "network_23.msgpack"
BATCH = 1280
SIMS = 800  # flagship search
# the 8x128 search runs 200 sims: with every search at 800 the whole run
# passed 15 minutes, and the 8x128 path is the first to cut
WIDE_SIMS = 200  # 8x128 search
STRENGTH_SIMS = 800  # strength (VCT leaf solver) search
LOSS_SIMS = 800  # strength search with the loss prover
RENJU_SIMS = 800  # renju search with the VCF leaf solver
CLUSTER_SIMS = 64  # renju search on the clustered boards, black to move
LOSS2_CPU_BOARDS = 32  # boards of the level-2 loss proof checked on the CPU
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


def backup_phase(tree: dict, tag: str) -> dict:
    """score_backup against score_backup_plain on clones of `tree` (a dict
    of its seven arguments), the whole trees bit-equal; its device time
    with the rows in L2 and after a 128 MB write that evicts them, its
    call and plain times, and its bytes bound at this input's valid levels
    and at full depth."""
    import torch
    from alphagomoku_tpu_torch.ops import score_scan as SSM

    names = ("edge_score", "edge_action", "node_complete", "node_score", "pn", "ps",
             "start_score")
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
    del plain_tree
    args = [kernel_tree[k] for k in names]
    flush = torch.empty(32 << 20, dtype=torch.int32, device=args[0].device)
    ms = kernel_device_ms(lambda: SSM.score_backup(*args), "score_backup_kernel")
    cold_ms = kernel_device_ms(lambda: (flush.zero_(), SSM.score_backup(*args)),
                               "score_backup_kernel")
    call_ms = time_cuda(lambda: SSM.score_backup(*args))
    plain_ms = time_cuda(lambda: SSM.score_backup_plain(*args))
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
    depthwise conv2d + matmul): a yardstick, never used by the port."""
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


PROFILE_STEPS = 5
PHASES = ("mcts.select", "mcts.evaluate", "mcts.solve", "mcts.expand", "mcts.backup")


def _traced(fn, reps: int):
    """torch.profiler trace (CPU and CUDA) of `reps` calls of `fn`, and the
    wall milliseconds per call under it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    return prof, wall_ms


def _device_kernels(prof):
    """The trace's CUDA kernel entries (without the phases' device spans)."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in PHASES]


def kernel_device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device milliseconds per launch of the CUDA kernel whose name
    contains `kernel`, over the launches that torch.profiler traced in
    `reps` calls of `fn` (after one warm-up call).  Unlike CUDA events
    around a call, this leaves out the host's time to enqueue the launch.
    The profiler may miss a few launches of a kernel of a few microseconds
    (4 of 20 once, after an 800-sim search): the mean is over those it
    traced, and more than `reps` traced, or fewer than half, is a fault."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof, _ = _traced(fn, reps)
    hits = [e for e in _device_kernels(prof) if kernel in e.key]
    traced = sum(e.count for e in hits)
    if not reps // 2 <= traced <= reps:
        raise SystemExit(f"profiler: {traced} launches of {kernel} traced in {len(hits)} "
                         f"entries, expected {reps}: {[(e.key, e.count) for e in hits]}")
    if traced < reps:
        print(f"profiler: {traced} of {reps} launches of {kernel} traced", flush=True)
    return sum(e.self_device_time_total for e in hits) / traced / 1e3


def _launched(event) -> tuple[int, float]:
    """Kernels launched under a traced CPU event and its children: count
    and device microseconds."""
    n, us = len(event.kernels), sum(k.duration for k in event.kernels)
    for child in event.cpu_children:
        cn, cus = _launched(child)
        n, us = n + cn, us + cus
    return n, us


def profile_steps(simulate, weights, state, steps: int) -> str:
    """Run `steps` simulation steps under torch.profiler and describe
    them: wall and device-busy milliseconds per step, kernel launches per
    step, the host milliseconds, device milliseconds and launches of each
    `mcts.*` phase per step, and the kernels that took the most device
    time."""
    import torch

    box = [state]

    def step():
        with torch.no_grad():
            box[0] = simulate(weights, box[0])

    prof, wall_ms = _traced(step, steps)
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    phases = {name: {"host_ms": 0.0, "device_ms": 0.0, "launches": 0.0} for name in PHASES}
    for e in prof.events():
        if e.name in phases and e.device_type == torch.autograd.DeviceType.CPU:
            n, us = _launched(e)
            ph = phases[e.name]
            ph["host_ms"] += e.cpu_time_total / 1e3 / steps
            ph["device_ms"] += us / 1e3 / steps
            ph["launches"] += n / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    traced = {k: sum(e.count for e in kernels if k in e.key)
              for k in ("convnext_trunk", "score_scan_kernel", "score_backup_kernel")}
    return "profile: " + json.dumps({
        "traced_launches": traced,
        "steps": steps, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "phases": phases,
        "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / 1e3 / steps
                                    for e in top},
    })


def trunk_phase(net, planes, tag: str) -> dict:
    """The trunk kernel against `fused_trunk_plain` on the stem output of
    `planes`: all blocks, each block alone, kernels fed a bias left out
    (which must be rejected), timings, the library yardstick and the
    bound.  Returns the trunk's `kernels` entry at this width."""
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
        trunk_plain_ms = time_cuda(lambda: CF.fused_trunk_plain(x, tw), reps=5)
        lib_out = library_trunk(x, tw)
        trunk_lib_ms = time_cuda(lambda: library_trunk(x, tw))
    L, C = tw.dw.shape[0], x.shape[-1]
    occ = CF.trunk_occupancy(C, H, W)
    print(f"{tag} occupancy: C={C}: {occ['registers']} registers per thread, "
          f"{occ['ctas_per_sm']} CTAs per SM, {occ['smem_bytes']} bytes of shared memory per "
          f"CTA, {occ['local_bytes']} bytes of local memory (spills) per thread", flush=True)
    dw_flops = 2.0 * 49 * H * W * C * BATCH * L
    mm_flops = (2.0 * 2 * H * W * C * C + 2.0 * 2 * C * C) * BATCH * L
    trunk_bytes = 2 * x.numel() * x.element_size() + sum(
        t.numel() * t.element_size() for t in tw
    )
    ops_ms = (dw_flops / F32_FLOPS + mm_flops / BF16_TC_FLOPS) * 1e3
    bytes_ms = trunk_bytes / HBM_BPS * 1e3
    trunk_bound_ms = max(ops_ms, bytes_ms)
    lib = held(out_p, lib_out, CF.TRUNK_LIMITS)
    print(f"{tag}: C={C} L={L} B={BATCH}; library trunk {describe(lib)}; kernel {trunk_ms:.4f} ms "
          f"on the device ({trunk_call_ms:.4f} ms a call), "
          f"plain {trunk_plain_ms:.4f} ms, library {trunk_lib_ms:.4f} ms, bound "
          f"{trunk_bound_ms:.4f} ms (ops {ops_ms:.4f}: {dw_flops / 1e9:.2f} GFLOP depthwise "
          f"f32 + {mm_flops / 1e9:.2f} GFLOP products bf16; bytes {bytes_ms:.4f})", flush=True)
    return dict(
        status="within limits", max_abs_err=trunk["max_abs_err"],
        share_differ=trunk["share_differ"], share_over_2ulps=trunk["share_over"], ms=trunk_ms,
        call_ms=trunk_call_ms, plain_ms=trunk_plain_ms, bound_ms=trunk_bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=trunk_lib_ms,
        **occ,
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


def search_phase(weights, tables, cfg, boards, stm, sims: int, tag: str, net_apply=None):
    """One `run_search` of `sims` simulations (through `net_apply`, by
    default `fused_apply`) with the kernels' launch counts set to 0 just
    before it and read just after; the search's invariants; a line with
    sims/s and launches per step.  Returns the final state and the launch
    counts."""
    import torch
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM
    from alphagomoku_tpu_torch.search import mcts
    from alphagomoku_tpu_torch.search import score as S

    SSM.score_scan.launches = 0
    SSM.score_backup.launches = 0
    CF.fused_trunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = mcts.run_search(net_apply or CF.fused_apply, weights, tables, cfg, boards, stm,
                            sims, device=boards.device)
    move = mcts.select_move(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"score_scan": SSM.score_scan.launches, "score_backup": SSM.score_backup.launches,
                "fused_trunk": CF.fused_trunk.launches}
    if launches != {"score_scan": 0, "score_backup": sims, "fused_trunk": sims + 1}:
        raise SystemExit(f"{tag}: the kernels were not launched once per step inside "
                         f"run_search: {launches}")
    tree = state.tree
    root_visits = tree.node_visits[:, 0]
    root_proven = S.is_proven(tree.node_score[:, 0])
    if not bool(((root_visits == 1 + sims) | root_proven).all()):
        raise SystemExit(f"{tag}: an unproven root does not hold 1 + sims visits")
    if int(tree.node_count.max()) > cfg.max_nodes:
        raise SystemExit(f"{tag}: node_count exceeds max_nodes")
    if not bool((boards.reshape(BATCH, -1).gather(1, move[:, None]) == 0).all()):
        raise SystemExit(f"{tag}: select_move chose an occupied cell")
    if not bool(torch.isfinite(mcts.root_value(state)).all()):
        raise SystemExit(f"{tag}: non-finite root value")
    summary = state.stats.summary(state.sims_done)
    root = tree.node_score[:, 0]
    print(f"{tag}: {sims} sims x batch {BATCH} in {dt:.3f} s = {BATCH * sims / dt:.1f} sims/s, "
          f"{dt / sims * 1e3:.3f} ms per simulation step; launches {launches}, "
          f"{sum(launches.values()) / sims:.4f} of the kernels per step; "
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
    from alphagomoku_tpu_torch.patterns import features as FEAT
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

    # 5. fused_trunk at B = 1280, C = 64, L = 6 with network_23
    net = network_from_flax(checkpoint.load(CKPT)).to(dev)
    weights = CF.pack_weights(net)
    tables = V.device_tables(GameRules.FREESTYLE)
    boards = torch.from_numpy(bench_boards(BATCH)).to(dev)
    stm = torch.full((BATCH,), CROSS, dtype=torch.int8, device=dev)
    planes = FEAT.unpack_raw_planes(FEAT.encode(tables, boards, stm))
    trunk64 = trunk_phase(net, planes, "fused_trunk")

    # 6. network: fused forward, kernel trunk vs plain trunk
    network_phase(weights, planes, "network")

    # 7. search at the bench configuration, and score_backup on its tree
    cfg = mcts.MCTSConfig(max_nodes=808, max_edges=32, max_depth=16)
    state, launches = search_phase(weights, tables, cfg, boards, stm, SIMS, "search")
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

    # 8. profile: the next steps of the same search, traced
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, cfg)
    print(profile_steps(simulate, weights, state, PROFILE_STEPS), flush=True)
    del state, simulate

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

    trunk = dict(name="fused_trunk", route="cuda",
                 source="alphagomoku_tpu_torch/csrc/convnext_trunk.cu",
                 replaces="alphagomoku_tpu/ops/convnext_fused.py:92", **trunk64)
    trunk["widths"] = {"64": dict(trunk64, launches=paths["flagship"]["fused_trunk"]),
                       "128": dict(trunk128, launches=paths["8x128"]["fused_trunk"])}
    kernels.append(trunk)
    for k in kernels:
        k["launches"] = paths["flagship"][k["name"]]
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items()}
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
