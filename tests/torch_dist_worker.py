"""Worker for the gloo tests of the port's data and tensor parallelism
(tests/test_torch_distributed.py).  Each process joins a gloo group through
a FileStore and, on the CPU, at world size 2:

1. takes two data-parallel train steps (`make_dp_train_step`) on its half
   of a global batch, for FastPolicy 1x8 and ConvNextPVQMraw 1x8 in
   float32, and saves its parameters, BatchNorm statistics, gradients and
   losses;
2. on a (1, 2) mesh: (rank 0) lists `param_shardings` of the flagship's
   parameters; takes the same two steps with the state placed by
   `param_shardings(tensor_parallel=True)` (`shard_state_`: the
   column-parallel step) on the whole batch, for both and for
   Transformer_v2 1x8, and saves its local tensors,
   the gathered state, gradients and losses; checks that the gathered
   state writes the single-process checkpoint bytes, and that a step with
   the replicated state is bitwise the plain step;
3. runs one `make_rl_round` at tp = 1 and one at tp = 2 (sharded state),
   and saves their parameters;
4. runs one distributed `TrainingManager` iteration, recording through an
   audit hook every file it opens for writing, replaces or removes;

and at world size 4, on a (2, 2) mesh, one column-parallel step of
FastPolicy 1x8 on its dp half of the batch.  It writes what it saw under
the output directory for the parent test, and imports no JAX.

Usage: python tests/torch_dist_worker.py <rank> <world> <init url> <batch.npz> <out dir> <work dir>
"""

import json
import os
import sys

rank, world, url, batch_path, out_dir, work_dir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5], sys.argv[6])
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

torch.set_num_threads(1)

from alphagomoku_tpu_torch.game import vectorized as V
from alphagomoku_tpu_torch.game.types import GameRules
from alphagomoku_tpu_torch.models.forward import network_apply
from alphagomoku_tpu_torch.models.networks import create_network, init_random_
from alphagomoku_tpu_torch.parallel import distributed as D
from alphagomoku_tpu_torch.models.convert import to_flax
from alphagomoku_tpu_torch.parallel import (full_state_dict, gather_state, make_mesh,
                                            param_shardings, shard_state_)
from alphagomoku_tpu_torch.search import mcts
from alphagomoku_tpu_torch.selfplay import SelfplayConfig
from alphagomoku_tpu_torch.training import train as T
from alphagomoku_tpu_torch.training.manager import ManagerConfig, TrainingManager
from alphagomoku_tpu_torch.utils import checkpoint

D.initialize(url, world, rank, backend="gloo")
assert D.process_index() == rank and D.process_count() == world
H = W = 9
ARCHS = ("FastPolicy", "ConvNextPVQMraw")
# the tp steps also take a transformer: a positional embedding and the
# attention projections' biases are placed over tp as well
TP_ARCHS = ARCHS + ("Transformer_v2",)
STEPS = 2


def dp_net(arch):
    net = create_network(arch, 1, 8, H, W, dtype=torch.float32)
    return init_random_(net, torch.Generator().manual_seed(5))


def save(name, arrays):
    np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def grads(net):
    return {k: p.grad for k, p in net.named_parameters()}


def tp_steps(arch, mesh, local, steps):
    """`steps` column-parallel steps of `arch` on `local`, this rank's dp
    slice: the state placed by param_shardings(tensor_parallel=True)."""
    net = dp_net(arch)
    state, tx = T.create_train_state(net, T.TrainConfig())
    shard_state_(state, mesh)
    placements = net.tp_shards.placements
    step = D.make_dp_train_step(T.make_train_step(net, tx, tables, T.TrainConfig()), mesh)
    out = {}
    for i in range(steps):
        state, parts = step(state, D.global_batch_from_local(mesh, local), all_modes[i])
        out.update({f"loss{i}/{k}": v.numpy() for k, v in parts.items()})
    out.update({f"p/{k}": v.numpy() for k, v in full_state_dict(net).items()})
    out.update({f"g/{k}": v.numpy() for k, v in gather_state(mesh, grads(net), placements).items()})
    out.update({f"local/{k}": v.detach().numpy() for k, v in net.state_dict().items()})
    return out


tables = V.device_tables(GameRules.FREESTYLE)
with np.load(batch_path) as data:
    full = {k: data[k] for k in data.files if k != "modes"}
    all_modes = torch.from_numpy(data["modes"])

if world == 4:
    # -- the (2, 2) mesh: dp and tp together, one step -------------------------
    mesh22 = make_mesh(tp=2, device="cpu")
    half = len(full["stm"]) // 2
    dp_rank = mesh22.get_local_rank("dp")
    local = {k: v[dp_rank * half:(dp_rank + 1) * half] for k, v in full.items()}
    save("tp22_FastPolicy", tp_steps("FastPolicy", mesh22, local, 1))
    torch.distributed.destroy_process_group()
    sys.exit(0)

# -- part 1: the DP train step ------------------------------------------------
mesh = make_mesh(device="cpu")
per = len(full["stm"]) // world
local = {k: v[rank * per:(rank + 1) * per] for k, v in full.items()}
for arch in ARCHS:
    net = dp_net(arch)
    state, tx = T.create_train_state(net, T.TrainConfig())
    step = D.make_dp_train_step(T.make_train_step(net, tx, tables, T.TrainConfig()), mesh)
    out = {}
    for i in range(STEPS):
        batch = D.global_batch_from_local(mesh, local)
        assert batch.global_size == len(full["stm"]) and batch.offset == rank * per
        state, parts = step(state, batch, all_modes[i])
        out.update({f"loss{i}/{k}": v.numpy() for k, v in parts.items()})
    out.update({f"p/{k}": v.detach().numpy() for k, v in net.state_dict().items()})
    out.update({f"g/{k}": p.grad.numpy() for k, p in net.named_parameters()})
    save(f"dp_{arch}", out)

# -- part 2: tensor parallelism on a (1, 2) mesh -------------------------------
mesh_tp = make_mesh(tp=world, device="cpu")
flagship = create_network("ConvNextPVQMraw")
placements = param_shardings(mesh_tp, flagship.state_dict(), tensor_parallel=True)
replicated = param_shardings(mesh_tp, flagship.state_dict(), tensor_parallel=False)
for arch in TP_ARCHS:
    save(f"tp_{arch}", tp_steps(arch, mesh_tp, full, STEPS))

# the gathered state writes the single-process checkpoint bytes
net = dp_net("ConvNextPVQMraw")
want = checkpoint.to_bytes(to_flax(net.state_dict()))
state, _ = T.create_train_state(net, T.TrainConfig())
shard_state_(state, mesh_tp)
same_file = checkpoint.to_bytes(to_flax(full_state_dict(net))) == want
sharded_keys = sorted(k for k, v in net.tp_shards.placements.items() if "Shard" in repr(v[1]))

# a replicated state at tp = 2: bitwise the plain step on both ranks
plain_equal = True
for arch in ARCHS:
    nets, losses = [], []
    for wrapped in (False, True):
        net = dp_net(arch)
        state, tx = T.create_train_state(net, T.TrainConfig())
        step = T.make_train_step(net, tx, tables, T.TrainConfig())
        batch = {k: torch.from_numpy(v) for k, v in full.items()}
        if wrapped:
            step = D.make_dp_train_step(step, mesh_tp)
            batch = D.global_batch_from_local(mesh_tp, batch)
        state, parts = step(state, batch, all_modes[0])
        nets.append(net)
        losses.append(parts)
    a, b = nets
    plain_equal &= all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                         b.state_dict().values()))
    plain_equal &= all(torch.equal(x.grad, y.grad) for x, y in zip(a.parameters(),
                                                                   b.parameters()))
    plain_equal &= all(torch.equal(losses[0][k], losses[1][k]) for k in losses[0])
with open(os.path.join(out_dir, f"tp_checks_r{rank}.json"), "w") as fh:
    json.dump({"same_file": same_file, "sharded_keys": sharded_keys,
               "replicated_step_is_plain": bool(plain_equal)}, fh)
if rank == 0:
    with open(os.path.join(out_dir, "shardings.json"), "w") as fh:
        json.dump({"tp": {k: repr(v[1]) for k, v in placements.items()},
                   "dp": sorted({repr(v[0]) for v in placements.values()}),
                   "off": sorted({repr(v) for v in replicated.values()})}, fh)

# -- part 3: one fused actor -> learner round ---------------------------------
net = create_network("FastPolicy", 1, 8, H, W)
init_random_(net, torch.Generator().manual_seed(2))
apply, weights = network_apply(net)
state, tx = T.create_train_state(net, T.TrainConfig())
round_fn, _ = D.make_rl_round(
    apply, T.make_train_step(net, tx, tables, T.TrainConfig()), tables,
    mcts.MCTSConfig(max_nodes=10, max_edges=8, max_depth=6),
    SelfplayConfig(num_simulations=4, max_moves=6, temperature_moves=4),
    batch_per_host=4, rows=H, cols=W, mesh=mesh,
)
state, parts = round_fn(weights, state, 1)
save("rl_round", {**{f"p/{k}": v.detach().numpy() for k, v in net.state_dict().items()},
                  "total": parts["total"].numpy()})
# the same round at tp = 2, the state placed over tp
net = create_network("FastPolicy", 1, 8, H, W)
init_random_(net, torch.Generator().manual_seed(2))
apply, weights = network_apply(net)
state, tx = T.create_train_state(net, T.TrainConfig())
shard_state_(state, mesh_tp)
round_fn, _ = D.make_rl_round(
    apply, T.make_train_step(net, tx, tables, T.TrainConfig()), tables,
    mcts.MCTSConfig(max_nodes=10, max_edges=8, max_depth=6),
    SelfplayConfig(num_simulations=4, max_moves=6, temperature_moves=4),
    batch_per_host=4, rows=H, cols=W, mesh=mesh_tp,
)
state, parts = round_fn(weights, state, 1)
save("rl_round_tp", {**{f"p/{k}": v.numpy() for k, v in full_state_dict(net).items()},
                     **{f"local/{k}": v.detach().numpy() for k, v in net.state_dict().items()
                        if "Shard" not in repr(net.tp_shards.placements[k][1])},
                     "total": parts["total"].numpy()})
D.barrier("rl_round_done")

# -- part 4: TrainingManager in distributed mode ------------------------------
written = []


def audit(event, args):
    if event == "open" and isinstance(args[0], str) and args[0].startswith(work_dir):
        mode, flags = args[1], args[2]
        if (mode and any(c in mode for c in "wax+")) or (
                mode is None and flags & (os.O_WRONLY | os.O_RDWR)):
            written.append(os.path.relpath(args[0], work_dir))
    elif event in ("os.rename", "os.remove") and str(args[0]).startswith(work_dir):
        written.append(os.path.relpath(str(args[1] if event == "os.rename" else args[0]),
                                       work_dir))


sys.addaudithook(audit)
cfg = ManagerConfig(
    working_dir=work_dir, rows=6, cols=6, architecture="FastPolicy", blocks=1, filters=8,
    games_per_iteration=4, selfplay_batch=4, num_simulations=2, train_steps_per_iteration=2,
    train_batch_size=8, balanced_openings=False, use_gating=True, gating_games=2,
    leaf_solver="none", tree_reuse=False, distributed=True, seed=3,
)
mgr = TrainingManager(cfg, device="cpu")
metrics0 = mgr.run_iteration_rl(0)
metrics1 = mgr.run_iteration_rl(1)
D.barrier("two_iterations_done")
with open(os.path.join(out_dir, f"manager_r{rank}.json"), "w") as fh:
    json.dump({"written": sorted(set(written)), "total": [metrics0.get("total"),
               metrics1.get("total")], "samples": [metrics0["samples"], metrics1["samples"]],
               "metadata": mgr.metadata}, fh)
save("manager", {f"p/{k}": v.detach().numpy() for k, v in mgr.net.state_dict().items()})
torch.distributed.destroy_process_group()
