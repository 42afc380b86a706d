"""Worker for the 2-process gloo test of the port's data parallelism
(tests/test_torch_distributed.py).  Each process joins a gloo group through
a FileStore and, on the CPU,

1. takes two data-parallel train steps (`make_dp_train_step`) on its half
   of a global batch, for FastPolicy 1x8 and ConvNextPVQMraw 1x8 in
   float32, and saves its parameters, BatchNorm statistics, gradients and
   losses;
2. (rank 0) lists `param_shardings` of the flagship's parameters on a
   (1, 2) mesh, and checks that a step at tp = 2 raises;
3. runs one `make_rl_round` and saves its parameters;
4. runs one distributed `TrainingManager` iteration, recording through an
   audit hook every file it opens for writing, replaces or removes;

and writes what it saw under the output directory for the parent test.
It imports no JAX.

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
from alphagomoku_tpu_torch.parallel import make_mesh, param_shardings
from alphagomoku_tpu_torch.search import mcts
from alphagomoku_tpu_torch.selfplay import SelfplayConfig
from alphagomoku_tpu_torch.training import train as T
from alphagomoku_tpu_torch.training.manager import ManagerConfig, TrainingManager

D.initialize(url, world, rank, backend="gloo")
assert D.process_index() == rank and D.process_count() == world
H = W = 9
ARCHS = ("FastPolicy", "ConvNextPVQMraw")
STEPS = 2


def dp_net(arch):
    net = create_network(arch, 1, 8, H, W, dtype=torch.float32)
    return init_random_(net, torch.Generator().manual_seed(5))


def save(name, arrays):
    np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


# -- part 1: the DP train step ------------------------------------------------
mesh = make_mesh()
tables = V.device_tables(GameRules.FREESTYLE)
with np.load(batch_path) as data:
    full = {k: data[k] for k in data.files if k != "modes"}
    all_modes = torch.from_numpy(data["modes"])
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

# -- part 2: param_shardings at tp = 2, and the tp > 1 step raises ------------
mesh_tp = make_mesh(tp=world)
flagship = create_network("ConvNextPVQMraw")
placements = param_shardings(mesh_tp, flagship.state_dict(), tensor_parallel=True)
replicated = param_shardings(mesh_tp, flagship.state_dict(), tensor_parallel=False)
tp_raise = ""
try:
    D.make_dp_train_step(lambda *a: None, mesh_tp)
except NotImplementedError as e:
    tp_raise = str(e)
if rank == 0:
    with open(os.path.join(out_dir, "shardings.json"), "w") as fh:
        json.dump({"tp": {k: repr(v[1]) for k, v in placements.items()},
                   "dp": sorted({repr(v[0]) for v in placements.values()}),
                   "off": sorted({repr(v) for v in replicated.values()}),
                   "tp_raise": tp_raise}, fh)

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
