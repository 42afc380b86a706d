"""Install-time benchmark + auto-configuration.

Port of the reference package's `engine/benchmark.py` (reference:
src/player/benchmark.cpp:25-143, src/player/configuration.cpp:151-199):
measure NN inference samples/s over a sweep of batch sizes on the device,
write `benchmark.json`, then derive `config.json` picking the
throughput-maximizing batch size plus the reference's search defaults
(max_children=32, c_puct ~ the exploration constant, solver enabled).

The forward measured is the one the port's engine runs,
`models.forward.network_apply` of a network with seeded weights (for the
convnext trunk `fused_apply`, the trunk kernel on the card, on a
`pack_weights` snapshot; for the other trunks the module's forward), on
bf16 planes of empty boards.  Each point times whole
calls, the device synchronised after each, as the reference package blocks
until each result is ready.
"""

from __future__ import annotations

import json
import os
import time

import torch

from ..models.forward import network_apply
from ..models.networks import create_network, init_random_

BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_benchmark(
    architecture: str = "ConvNextPVQMraw",
    blocks: int = 6,
    filters: int = 64,
    rows: int = 15,
    cols: int = 15,
    seconds_per_point: float = 2.0,
    output_path: str = "benchmark.json",
    batch_sizes=BATCH_SIZES,
    device: str | torch.device = "cuda",
) -> dict:
    """Sweep batch sizes, measure samples/s, write benchmark.json
    (reference: run_benchmark, benchmark.cpp:99-143)."""
    device = torch.device(device)
    net = create_network(architecture, blocks, filters, rows, cols)
    init_random_(net, torch.Generator().manual_seed(0))
    apply, weights = network_apply(net.to(device))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    results = []
    for batch in batch_sizes:
        x = torch.zeros((batch, rows, cols, net.cfg.input_planes), dtype=torch.bfloat16,
                        device=device)
        apply(weights, x)
        _sync(device)
        t_end = time.perf_counter() + seconds_per_point
        samples = 0
        while time.perf_counter() < t_end:
            apply(weights, x)
            _sync(device)
            samples += batch
        results.append(
            {
                "device": name,
                "batch_size": batch,
                "samples_per_second": samples / seconds_per_point,
            }
        )
    report = {
        "architecture": architecture,
        "blocks": blocks,
        "filters": filters,
        "rows": rows,
        "cols": cols,
        "results": results,
    }
    with open(output_path, "w") as fh:
        json.dump(report, fh, indent=2)
    return report


def create_config(
    benchmark_path: str = "benchmark.json",
    config_path: str = "config.json",
) -> dict:
    """Pick the throughput-maximizing batch size and write engine defaults
    (reference: createConfig, configuration.cpp:151-199)."""
    with open(benchmark_path) as fh:
        bench = json.load(fh)
    best = max(bench["results"], key=lambda r: r["samples_per_second"])
    config = {
        "version": "0.1",
        "architecture": bench["architecture"],
        "blocks": bench["blocks"],
        "filters": bench["filters"],
        "device": best["device"],
        "search_batch_size": best["batch_size"],
        "search": {
            # (reference defaults: configuration.cpp:151-199)
            "max_children": 32,
            "exploration_constant": 1.25,
            "init_to": "q_head",
            "solver": "static",
        },
        "measured_samples_per_second": best["samples_per_second"],
    }
    with open(config_path, "w") as fh:
        json.dump(config, fh, indent=2)
    return config


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="benchmark + auto-configuration")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--configure", action="store_true")
    p.add_argument("--arch", default="ConvNextPVQMraw")
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--output-dir", default=".")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench_path = os.path.join(args.output_dir, "benchmark.json")
    conf_path = os.path.join(args.output_dir, "config.json")
    if args.benchmark or not os.path.exists(bench_path):
        report = run_benchmark(
            args.arch,
            args.blocks,
            args.filters,
            seconds_per_point=args.seconds,
            output_path=bench_path,
            device=args.device,
        )
        best = max(report["results"], key=lambda r: r["samples_per_second"])
        print(f"best: batch {best['batch_size']} -> {best['samples_per_second']:.0f} samples/s")
    if args.configure:
        config = create_config(bench_path, conf_path)
        print(f"wrote {conf_path}: batch {config['search_batch_size']}")


if __name__ == "__main__":
    main()
