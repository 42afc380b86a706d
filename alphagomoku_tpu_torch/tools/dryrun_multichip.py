"""Multi-process dry run of the learner at tensor parallelism: the port's
counterpart of the reference package's `dryrun_multichip`
(`__graft_entry__.py:36-175`).

    python3 -m alphagomoku_tpu_torch.tools.dryrun_multichip [--n N] [--device cuda|cpu]
        [--check] [--reps R]

Spawns N processes joined at tcp://localhost:<a free port>: gloo on the
CPU; on cards NCCL when N is at most the cards there are, else gloo over
CUDA tensors, the processes sharing the cards (rank modulo the count).
The mesh is (N / tp, tp) with tp = 2 when N is even.  Each process:

1. takes one train step of the flagship ConvNextPVQMraw 6x64 (flax's
   initialisers, seed 0) at 15x15 on a global batch of max(256, 2N)
   samples (the reference's: two stones, a uniform policy over the empty
   cells, value (0.4, 0.2, 0.4)), its dp slice, with the state placed by
   `param_shardings(tensor_parallel=tp > 1)` (`sharding.shard_state_`:
   the column-parallel step), and checks the losses finite;
2. plays one `make_rl_round` of a 2x16 ConvNextPVQMraw (self-play of 8N
   boards over the dp coordinates, `MCTSConfig(max_nodes=12, max_edges=8,
   max_depth=6)`, 8 sims, 48 moves, 8 temperature moves, then one train
   step of the placed state), the searches through the fused forward (on
   the card the trunk kernel at 16 channels, padded to 64), and checks the
   losses finite (0 where no game ended in 48 moves: the targets mask
   unfinished games; the valid samples are reported).

With `--check`, before both: the flagship in float32 (TF32 off), its
column-parallel step against the plain step of one process on the whole
batch (rank 0), held within tests/test_torch_distributed.py's constants
(parameters 1e-6 absolute, losses 1e-5 relative, gradients 5e-5 of the
largest), and both timed over `--reps` more steps (CUDA events on the
card; the plain step timed while the other ranks wait).

Rank 0 prints the losses as the reference prints them, then, last, one
JSON line: the mesh, the backend, the losses, the check, the times and
the kernel launches of each leg on rank 0.  Any failure exits non-zero;
every process started is stopped.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
H = W = 15
FLAGSHIP = "ConvNextPVQMraw"
PARAM_ATOL = 1e-6  # tests/test_torch_distributed.py's constants
REL = 1e-5
GRAD_REL = 5e-5


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sample_batch(batch: int, device):
    """The reference dry run's global batch (`__graft_entry__.py:71-89`)."""
    import numpy as np
    import torch
    from ..game.types import CIRCLE, CROSS

    boards = np.zeros((batch, H, W), np.int8)
    boards[:, 4, 4] = CROSS
    boards[:, 4, 5] = CIRCLE
    policy = (boards == 0).astype(np.float32)
    policy /= policy.sum((1, 2), keepdims=True)
    out = {
        "board": boards,
        "stm": np.full((batch,), CROSS, np.int8),
        "policy": policy,
        "value_wdl": np.tile(np.asarray([[0.4, 0.2, 0.4]], np.float32), (batch, 1)),
        "q_value": np.zeros((batch, H, W, 2), np.float32),
        "q_mask": np.zeros((batch, H, W), bool),
        "moves_left": np.full((batch,), 10, np.int32),
        "valid": np.ones((batch,), bool),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _counts() -> dict:
    from ..ops import convnext_fused as CF
    from ..ops import score_scan as SSM

    return {"score_scan": SSM.score_scan.launches, "score_backup": SSM.score_backup.launches,
            "fused_trunk": CF.fused_trunk.launches,
            "fused_trunk_cluster": CF.fused_trunk.cluster_launches}


def _zero_counts() -> None:
    from ..ops import convnext_fused as CF
    from ..ops import score_scan as SSM

    SSM.score_scan.launches = SSM.score_backup.launches = 0
    CF.fused_trunk.launches = CF.fused_trunk.cluster_launches = 0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(fn, reps: int, device) -> float:
    """Milliseconds a call of `fn`, the mean over `reps` calls (CUDA events
    on the card, the host's clock on the CPU)."""
    import torch

    _sync(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _rel_close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(1.0, abs(b))


def check_step(mesh, tables, batch, modes, reps: int, device) -> dict:
    """The float32 flagship's column-parallel step against one process's
    plain step on the whole batch (rank 0), then both timed."""
    import torch
    import torch.distributed as dist

    from ..models.networks import create_network, init_flax_
    from ..parallel import distributed as D
    from ..parallel import full_state_dict, gather_state, shard_state_
    from ..parallel.sharding import mesh_size
    from ..training import train as T

    cfg = T.TrainConfig()

    def make(parallel: bool):
        net = init_flax_(create_network(FLAGSHIP, 6, 64, H, W, dtype=torch.float32),
                         torch.Generator().manual_seed(0)).to(device)
        state, tx = T.create_train_state(net, cfg)
        step = T.make_train_step(net, tx, tables, cfg)
        if parallel:
            shard_state_(state, mesh)
            step = D.make_dp_train_step(step, mesh)
        return net, state, step

    dp, dp_rank = mesh_size(mesh, "dp"), mesh.get_local_rank("dp")
    per = len(batch["stm"]) // dp
    local = D.global_batch_from_local(
        mesh, {k: v[dp_rank * per:(dp_rank + 1) * per] for k, v in batch.items()})
    net, state, step = make(True)
    state, parts = step(state, local, modes)
    whole = full_state_dict(net)
    grads = gather_state(mesh, {k: p.grad for k, p in net.named_parameters()},
                         net.tp_shards.placements)
    out = {}
    if dist.get_rank() == 0:
        ref, ref_state, ref_step = make(False)
        ref_state, ref_parts = ref_step(ref_state, batch, modes)
        param_err = max(float((whole[k] - v).abs().max()) for k, v in ref.state_dict().items())
        scale = max(float(p.grad.abs().max()) for p in ref.parameters())
        grad_err = max(float((grads[k] - p.grad).abs().max()) for k, p in ref.named_parameters())
        loss_ok = all(_rel_close(float(parts[k]), float(ref_parts[k])) for k in ref_parts)
        out = {"param_max_abs_err": param_err, "grad_max_abs_err": grad_err, "grad_scale": scale,
               "losses": {k: float(v) for k, v in parts.items()},
               "plain_losses": {k: float(v) for k, v in ref_parts.items()},
               "limits": {"param_atol": PARAM_ATOL, "loss_rel": REL, "grad_rel": GRAD_REL}}
        out["ok"] = bool(param_err <= PARAM_ATOL and grad_err <= GRAD_REL * scale and loss_ok)
    D.barrier("check_done")
    out["tp_step_ms"] = _ms(lambda: step(state, local, modes), reps, device)
    D.barrier("tp_timed")
    if dist.get_rank() == 0:
        out["plain_step_ms"] = _ms(lambda: ref_step(ref_state, batch, modes), reps, device)
    D.barrier("plain_timed")
    return out


def worker(rank: int, n: int, port: int, device_type: str, check: bool, reps: int) -> dict:
    import torch
    import torch.distributed as dist

    from ..game import vectorized as V
    from ..game.types import GameRules
    from ..models.forward import network_apply
    from ..models.networks import create_network, init_flax_
    from ..parallel import distributed as D
    from ..parallel import make_mesh, shard_state_
    from ..parallel.sharding import mesh_size
    from ..search import mcts
    from ..selfplay import SelfplayConfig
    from ..training import train as T

    if device_type == "cuda":
        count = torch.cuda.device_count()
        torch.cuda.set_device(rank % count)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        backend = "nccl" if n <= count else "gloo"
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)
        backend, device = "gloo", torch.device("cpu")
    D.initialize(f"localhost:{port}", n, rank, backend=backend)
    result = {"n": n, "backend": backend, "device": device_type}
    try:
        tp = 2 if n % 2 == 0 else 1
        mesh = make_mesh(tp=tp, device=device_type)
        dp, dp_rank = mesh_size(mesh, "dp"), mesh.get_local_rank("dp")
        result["mesh"] = {"dp": dp, "tp": tp}
        tables = V.device_tables(GameRules.FREESTYLE)
        cfg = T.TrainConfig()
        batch_size = max(256, 2 * n)
        batch = sample_batch(batch_size, device)
        modes = T.draw_modes(torch.Generator(device=device).manual_seed(1), batch_size, H, W)
        if check:
            result["check"] = check_step(mesh, tables, batch, modes, reps, device)
            if rank == 0 and not result["check"]["ok"]:
                raise SystemExit(f"dryrun: the tp step is not the plain step: {result['check']}")

        # 1. the flagship train step at its real shapes, the state placed
        # over tp as the reference places it
        net = init_flax_(create_network(FLAGSHIP, 6, 64, H, W),
                         torch.Generator().manual_seed(0)).to(device)
        state, tx = T.create_train_state(net, cfg)
        if tp > 1:
            shard_state_(state, mesh)
        step = D.make_dp_train_step(T.make_train_step(net, tx, tables, cfg), mesh)
        per = batch_size // dp
        local = D.global_batch_from_local(
            mesh, {k: v[dp_rank * per:(dp_rank + 1) * per] for k, v in batch.items()})
        _zero_counts()
        t0 = time.perf_counter()
        state, parts = step(state, local, modes)
        _sync(device)
        result["train_step_s"] = time.perf_counter() - t0
        losses = {k: float(v) for k, v in parts.items()}
        if not all(map(math.isfinite, losses.values())):
            raise SystemExit(f"dryrun: non-finite loss: {losses}")
        result["train_losses"] = losses
        result["train_launches"] = _counts()
        if rank == 0:
            print(f"dryrun_multichip({n}): mesh={result['mesh']}, losses={losses}", flush=True)
        del net, state, step

        # 2. one actor -> learner round of a 2x16 network
        net_rl = init_flax_(create_network(FLAGSHIP, 2, 16, H, W),
                            torch.Generator().manual_seed(3)).to(device)
        apply, weights = network_apply(net_rl)
        state_rl, tx_rl = T.create_train_state(net_rl, cfg)
        if tp > 1:
            shard_state_(state_rl, mesh)
        step_rl, valid = T.make_train_step(net_rl, tx_rl, tables, cfg), []

        def counted_step(state, batch, modes):  # the samples a finished game gave
            valid.append(int(batch["valid"].sum()))
            return step_rl(state, batch, modes)

        round_fn, _ = D.make_rl_round(
            apply, counted_step, tables,
            mcts.MCTSConfig(max_nodes=12, max_edges=8, max_depth=6),
            SelfplayConfig(num_simulations=8, max_moves=48, temperature_moves=8),
            batch_per_host=8 * n // dp, rows=H, cols=W, mesh=mesh)
        _zero_counts()
        t0 = time.perf_counter()
        state_rl, parts = round_fn(weights, state_rl, 2)
        _sync(device)
        result["rl_round_s"] = time.perf_counter() - t0
        losses = {k: float(v) for k, v in parts.items()}
        if not all(map(math.isfinite, losses.values())):
            raise SystemExit(f"dryrun: non-finite RL-loop loss: {losses}")
        result["rl_losses"] = losses
        result["rl_valid_samples"] = valid[0]
        result["rl_launches"] = _counts()
        if rank == 0:
            print(f"dryrun rl-loop: mesh={result['mesh']}, losses={losses}, valid samples "
                  f"on rank 0 {valid[0]}", flush=True)
        D.barrier("dryrun_done")
    finally:
        dist.destroy_process_group()
    return result


def launch(n: int, device_type: str, check: bool, reps: int, timeout: float) -> dict:
    """Run the dry run in `n` child processes; rank 0's result."""
    port = _free_port()
    cmd = [sys.executable, "-m", "alphagomoku_tpu_torch.tools.dryrun_multichip", "--n", str(n),
           "--device", device_type, "--port", str(port), "--reps", str(reps)]
    if check:
        cmd.append("--check")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"dryrun_multichip: rank {r} exited {p.returncode}:\n{log[-6000:]}")
    lines = logs[0].strip().splitlines()
    last = max(i for i, line in enumerate(lines) if line.startswith("{"))
    for line in lines[:last]:
        print(line, flush=True)
    return json.loads(lines[last])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2, help="processes")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--check", action="store_true",
                    help="hold the float32 tp step against the plain step, and time both")
    ap.add_argument("--reps", type=int, default=5, help="steps timed of each, with --check")
    ap.add_argument("--timeout", type=float, default=1200.0, help="seconds the children may take")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        result = worker(args.rank, args.n, args.port, args.device, args.check, args.reps)
        if args.rank == 0:
            print(json.dumps(result), flush=True)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("dryrun_multichip: no CUDA device; pass --device cpu", file=sys.stderr)
            return 1
    print(json.dumps(launch(args.n, args.device, args.check, args.reps, args.timeout)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
