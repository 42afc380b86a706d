#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device  - needs CUDA; prints nvidia-smi's name and power limit;
  2. build   - builds the CUDA kernels (csrc/*.cu -> build/torch_kernels/);
  3. score_scan  - kernel vs plain version on the card, bit-equal, at the
     bench shape R = 1280, D = 16, K = 32, with timings;
  4. fused_trunk - kernel vs plain version at B = 1280, C = 64, L = 6 with
     the flagship network_23 weights, in bf16 ulps (utils/bf16.py): all
     six blocks, each block alone, and kernels fed one bias left out, which
     the check must reject; timings, the bound, and the same trunk through
     cuDNN/cuBLAS (bf16 conv2d + matmul) as a yardstick;
  5. network - the full fused forward (kernel trunk) vs the same forward
     with the plain trunk, head by head, in bf16 ulps of at least 1/16
     (`HEAD_LIMITS`);
  6. search  - mcts.run_search, 800 simulations, at the bench configuration (6x64
     network_23, batch 1280, max_nodes 808, max_edges 32, max_depth 16,
     freestyle 15x15, bench boards from seed 0), with both kernels' launch
     counts read around it;
  7. profile - 5 more steps of the same search under torch.profiler: the
     device's busy share, kernel launches per step, and host and device
     milliseconds per step of each phase of the step;
  8. fused_trunk 128 - phase 4 at C = 128, L = 8 with the seeded 8x128
     network (`models.networks.init_random_`, seed 0);
  9. network 128 - phase 5 with the 8x128 network;
 10. search 8x128 - phases 6 and 7 with the 8x128 network (`WIDE_SIMS`
     sims);
 11. search strength - phase 6 with network_23 and the VCT leaf solver at
     the engine default (steps 16, cap 256, depth 6, threes 2;
     `STRENGTH_SIMS` sims), with the roots and leaves it proves;
 12. profile strength - phase 7 for the strength search, `mcts.solve` as
     its own phase;
then a `kernels` JSON line and, last, {"ok": true, "device": {...}}.

A kernel's `ms` is its device time per launch: for score_scan as
torch.profiler traces it, for the trunk (2.8 ms and more a launch) by CUDA
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
WIDE_SIMS = 800  # 8x128 search
STRENGTH_SIMS = 800  # strength (VCT leaf solver) search
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
    contains `kernel`, over `reps` traced calls of `fn` (after one warm-up
    call).  Unlike CUDA events around a call, this leaves out the host's
    time to enqueue the launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof, _ = _traced(fn, reps)
    hits = [e for e in _device_kernels(prof) if kernel in e.key]
    traced = sum(e.count for e in hits)
    if traced != reps:
        raise SystemExit(f"profiler: {traced} launches of {kernel} traced in {len(hits)} "
                         f"entries, expected {reps}: {[(e.key, e.count) for e in hits]}")
    return sum(e.self_device_time_total for e in hits) / reps / 1e3


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
              for k in ("convnext_trunk", "score_scan_kernel")}
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


def search_phase(weights, tables, cfg, boards, stm, sims: int, tag: str):
    """One `run_search` of `sims` simulations with the kernels' launch
    counts set to 0 just before it and read just after; the search's
    invariants; a line with sims/s and launches per step.  Returns the
    final state and the launch counts."""
    import torch
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.ops import score_scan as SSM
    from alphagomoku_tpu_torch.search import mcts
    from alphagomoku_tpu_torch.search import score as S

    SSM.score_scan.launches = 0
    CF.fused_trunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = mcts.run_search(CF.fused_apply, weights, tables, cfg, boards, stm, sims,
                            device=boards.device)
    move = mcts.select_move(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"score_scan": SSM.score_scan.launches, "fused_trunk": CF.fused_trunk.launches}
    if launches != {"score_scan": sims, "fused_trunk": sims + 1}:
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
    print(f"{tag}: {sims} sims x batch {BATCH} in {dt:.3f} s = {BATCH * sims / dt:.1f} sims/s, "
          f"{dt / sims * 1e3:.3f} ms per simulation step; launches {launches}, "
          f"{sum(launches.values()) / sims:.4f} of the two kernels per step; "
          f"proven roots {int(root_proven.sum())}; node_count {int(tree.node_count.max())}; "
          f"avg depth {summary['avg_depth']:.3f}, transpositions {summary['transpositions']:.0f}, "
          f"solver-proven leaves {summary['solver_wins']:.0f}", flush=True)
    return state, launches


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

    # 3. score_scan at the bench shape
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
    kernels.append(dict(
        name="score_scan", route="cuda", source="alphagomoku_tpu_torch/csrc/score_scan.cu",
        replaces="alphagomoku_tpu/ops/score_scan.py:111", status="bit-equal", max_abs_err=0.0,
        ms=scan_ms, call_ms=scan_call_ms, plain_ms=scan_plain_ms, bound_ms=scan_bound_ms,
        bound_by="bytes", library_ms=None,
    ))

    # 4. fused_trunk at B = 1280, C = 64, L = 6 with network_23
    net = network_from_flax(checkpoint.load(CKPT)).to(dev)
    weights = CF.pack_weights(net)
    tables = V.device_tables(GameRules.FREESTYLE)
    boards = torch.from_numpy(bench_boards(BATCH)).to(dev)
    stm = torch.full((BATCH,), CROSS, dtype=torch.int8, device=dev)
    planes = FEAT.unpack_raw_planes(FEAT.encode(tables, boards, stm))
    trunk64 = trunk_phase(net, planes, "fused_trunk")

    # 5. network: fused forward, kernel trunk vs plain trunk
    network_phase(weights, planes, "network")

    # 6. search at the bench configuration
    cfg = mcts.MCTSConfig(max_nodes=808, max_edges=32, max_depth=16)
    state, launches = search_phase(weights, tables, cfg, boards, stm, SIMS, "search")
    paths = {"flagship": launches}

    # 7. profile: the next steps of the same search, traced
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, cfg)
    print(profile_steps(simulate, weights, state, PROFILE_STEPS), flush=True)
    del state, simulate

    # 8-9. the trunk and the network at C = 128 (8x128, seeded weights)
    wide_net = init_random_(create_network("ConvNextPVQMraw", blocks=8, filters=128),
                            torch.Generator().manual_seed(WIDE_SEED)).to(dev).eval()
    wide_weights = CF.pack_weights(wide_net)
    trunk128 = trunk_phase(wide_net, planes, "fused_trunk 128")
    network_phase(wide_weights, planes, "network 128")

    # 10. the 8x128 search
    state, paths["8x128"] = search_phase(wide_weights, tables, cfg, boards, stm, WIDE_SIMS,
                                         "search 8x128")
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, cfg)
    print(profile_steps(simulate, wide_weights, state, PROFILE_STEPS).replace(
        "profile:", "profile 8x128:"), flush=True)
    del state, simulate

    # 11. the strength search: network_23 and the VCT leaf solver (bench.py's
    # strength configuration)
    scfg = cfg._replace(leaf_solver="vct", leaf_solver_steps=16, leaf_solver_cap=256)
    roots = vct_batched.solve(tables, boards, stm, max_depth=scfg.leaf_solver_depth,
                              max_steps=4 * scfg.leaf_solver_steps,
                              max_threes=scfg.leaf_solver_threes)
    print(f"search strength: the root solve ({4 * scfg.leaf_solver_steps} transitions) proves "
          f"{int(roots.win.sum())} of {BATCH} roots", flush=True)
    state, paths["strength"] = search_phase(weights, tables, scfg, boards, stm, STRENGTH_SIMS,
                                            "search strength")

    # 12. profile of the strength search
    simulate = mcts.make_simulate_fn(CF.fused_apply, tables, scfg)
    print(profile_steps(simulate, weights, state, PROFILE_STEPS).replace(
        "profile:", "profile strength:"), flush=True)

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
