"""torch.profiler readings of the port on the GPU: a kernel's device time
per launch, and the simulation step's time, launches and `mcts.*` phases.

`chip_smoke.py` and the tools under `alphagomoku_tpu_torch/tools/` print
these; each function needs CUDA and traces only the calls it is given."""

from __future__ import annotations

import json
import time

PHASES = ("mcts.select", "mcts.evaluate", "mcts.solve", "mcts.expand", "mcts.backup")
_TRIES = 3  # traces of a kernel before too few traced launches is a fault


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
    (4 of 20 once, after an 800-sim search; all 20 once, late in a long
    run): the mean is over those it traced, a trace with fewer than half
    is taken again, up to `_TRIES` times, and more than `reps` traced, or
    fewer than half in every try, is a fault."""
    import torch

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, _TRIES + 1):
        prof, _ = _traced(fn, reps)
        hits = [e for e in _device_kernels(prof) if kernel in e.key]
        traced = sum(e.count for e in hits)
        if traced >= reps // 2:
            break
        print(f"profiler: try {attempt}: {traced} of {reps} launches of {kernel} traced",
              flush=True)
    if not reps // 2 <= traced <= reps:
        raise SystemExit(f"profiler: {traced} launches of {kernel} traced in {len(hits)} "
                         f"entries, expected {reps}: {[(e.key, e.count) for e in hits]}")
    if traced < reps:
        print(f"profiler: {traced} of {reps} launches of {kernel} traced", flush=True)
    return sum(e.self_device_time_total for e in hits) / traced / 1e3


def kernel_split_ms(fn, names, reps: int = 3) -> dict:
    """For each of `names`, the mean device milliseconds per launch of the
    CUDA kernels whose names contain it and the launches traced, over `reps`
    calls of `fn` traced by torch.profiler after one warm-up call (None
    where none was traced: late in a long run the profiler can miss some
    or all of a call's launches, see `kernel_device_ms`)."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof, _ = _traced(fn, reps)
    kernels = _device_kernels(prof)
    out = {}
    for n in names:
        hits = [e for e in kernels if n in e.key]
        traced = sum(e.count for e in hits)
        us = sum(e.self_device_time_total for e in hits)
        out[n] = {"ms_per_launch": us / 1e3 / traced if traced else None, "traced": traced}
    return out


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
    # "streamed_": the 4 L + 1 kernels of the trunk's streamed entry
    names = ("convnext_trunk", "streamed_", "score_scan_kernel", "score_backup_kernel")
    traced = {k: sum(e.count for e in kernels if k in e.key) for k in names}
    traced_us = {k: sum(e.self_device_time_total for e in kernels if k in e.key) for k in names}
    return "profile: " + json.dumps({
        "traced_launches": traced,
        "traced_ms_per_launch": {k: traced_us[k] / 1e3 / traced[k] for k in names if traced[k]},
        "steps": steps, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "phases": phases,
        "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / 1e3 / steps
                                    for e in top},
    })
