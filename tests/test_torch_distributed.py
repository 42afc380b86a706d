"""The port's data and tensor parallelism over `torch.distributed`
(`parallel/`) on the CPU with gloo:

- a 2-process run (tests/torch_dist_worker.py, a FileStore under
  tmp_path): two DP train steps, FastPolicy 1x8 and ConvNextPVQMraw 1x8
  in float32 on 9x9, each rank on half of a 16-sample global batch, leave
  bitwise identical parameters and BatchNorm statistics on both ranks,
  equal to one process's steps on the whole batch with the same
  symmetries within float32 tolerance (parameters 1e-6 absolute, losses
  1e-5 relative, gradients 5e-5 of the network's largest gradient: the
  ranks sum their halves' gradients in another order, and BatchNorm's
  backward cancels; measured 1.3e-5 for ConvNextPVQMraw); one
  `make_rl_round`; two iterations of a distributed `TrainingManager`, in
  which rank 1 writes only its own `_h1` files and the coordinator writes
  every checkpoint, metadata and metric file; `param_shardings` at tp = 2
  makes the JAX package's choice on the flagship's parameters;
- in the same run, on a (1, 2) mesh: the column-parallel step (the state
  placed by `param_shardings(tensor_parallel=True)`) of both networks and
  of Transformer_v2 1x8 (a positional embedding and attention biases
  placed over tp) equals the single-process step within the same constants (the tp
  all-reduce sums the input gradients in another order), the replicated
  leaves are bitwise equal on both ranks and the sharded ones are the
  halves of the gathered state; the gathered state writes the
  single-process checkpoint bytes; a step with the replicated state is
  bitwise the plain step; a `make_rl_round` at tp = 2 leaves both ranks
  with one state;
- a 4-process run on a (2, 2) mesh: one column-parallel step of
  FastPolicy 1x8 on each dp half equals the single-process step;
- in this process, a world-size-1 group: the DP step is bitwise the plain
  step (the check `chip_smoke.py` makes over NCCL on the card).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from alphagomoku_tpu_torch.game import vectorized as V
from alphagomoku_tpu_torch.game.types import GameRules
from alphagomoku_tpu_torch.models.networks import create_network, init_random_
from alphagomoku_tpu_torch.parallel import distributed as D
from alphagomoku_tpu_torch.parallel import make_mesh
from alphagomoku_tpu_torch.training import train as T

torch.set_num_threads(1)

WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
H = W = 9
ARCHS = ("FastPolicy", "ConvNextPVQMraw")
TP_ARCHS = ARCHS + ("Transformer_v2",)  # tests/torch_dist_worker.py's
STEPS = 2
PARAM_ATOL = 1e-6
REL = 1e-5
GRAD_REL = 5e-5


def _global_batch() -> dict:
    from tests.test_torch_train import sample_batch  # B = 16 samples on 9x9

    batch = sample_batch(3)
    gen = torch.Generator().manual_seed(7)
    batch["modes"] = np.stack([T.draw_modes(gen, len(batch["stm"]), H, W).numpy()
                               for _ in range(STEPS)])
    return batch


def _single_process(arch: str, batch: dict, steps: int = STEPS):
    """The steps of one process on the whole batch, with the same modes."""
    net = create_network(arch, 1, 8, H, W, dtype=torch.float32)
    init_random_(net, torch.Generator().manual_seed(5))
    state, tx = T.create_train_state(net, T.TrainConfig())
    step = T.make_train_step(net, tx, V.device_tables(GameRules.FREESTYLE), T.TrainConfig())
    losses = {}
    tensors = {k: torch.from_numpy(v) for k, v in batch.items() if k != "modes"}
    for i in range(steps):
        _, parts = step(state, tensors, torch.from_numpy(batch["modes"][i]))
        losses.update({f"loss{i}/{k}": v.numpy() for k, v in parts.items()})
    return net, losses


def _run_workers(tmp, world: int):
    out, work = tmp / "out", tmp / "work"
    out.mkdir()
    work.mkdir()
    batch = _global_batch()
    np.savez(tmp / "batch.npz", **batch)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), f"file://{tmp}/store",
         str(tmp / "batch.npz"), str(out), str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return out, work, batch


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _run_workers(tmp_path_factory.mktemp("dist"), 2)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _run_workers(tmp_path_factory.mktemp("dist4"), 4)


def _load(out: Path, name: str, rank: int) -> dict:
    with np.load(out / f"{name}_r{rank}.npz") as data:
        return {k: data[k] for k in data.files}


def _same_bits(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.atleast_1d(a[k]), np.atleast_1d(b[k])
        assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_step_replicas_bitwise_identical(two_ranks, arch):
    out, _, _ = two_ranks
    _same_bits(_load(out, f"dp_{arch}", 0), _load(out, f"dp_{arch}", 1))


def _assert_single_process_step(ours: dict, arch: str, batch: dict, steps: int = STEPS):
    """`ours` (the whole state, gradients and losses of a parallel run)
    against one process's steps, within PARAM_ATOL, GRAD_REL and REL."""
    net, losses = _single_process(arch, batch, steps)
    for k, v in net.state_dict().items():
        want = v.detach().numpy()
        got = ours[f"p/{k}"]
        assert np.abs(got - want).max() <= PARAM_ATOL, k
    bn = [k for k in net.state_dict() if k.endswith(("running_mean", "running_var"))]
    assert bn and any(not np.array_equal(ours[f"p/{k}"], np.zeros_like(ours[f"p/{k}"]))
                      for k in bn if k.endswith("running_mean"))
    scale = max(float(p.grad.abs().max()) for p in net.parameters())
    for k, p in net.named_parameters():
        assert np.abs(ours[f"g/{k}"] - p.grad.numpy()).max() <= GRAD_REL * scale, k
    for k, want in losses.items():
        assert abs(float(ours[k]) - float(want)) <= REL * max(1.0, abs(float(want))), k


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_step_equals_single_process_step(two_ranks, arch):
    out, _, batch = two_ranks
    _assert_single_process_step(_load(out, f"dp_{arch}", 0), arch, batch)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_step_equals_single_process_step(two_ranks, arch):
    """The column-parallel step at (1, 2), gathered, against one process's
    steps on the same batch and modes."""
    out, _, batch = two_ranks
    ours = {k: v for k, v in _load(out, f"tp_{arch}", 0).items() if not k.startswith("local/")}
    _assert_single_process_step(ours, arch, batch)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_replicated_leaves_bitwise_identical(two_ranks, arch):
    """Each rank's replicated leaves bitwise equal, its sharded leaves its
    half of the gathered state (equal on both ranks)."""
    out, _, _ = two_ranks
    runs = [_load(out, f"tp_{arch}", r) for r in range(2)]
    gathered = [{k: v for k, v in run.items() if not k.startswith("local/")} for run in runs]
    _same_bits(*gathered)
    halves = 0
    for key in (k[len("local/"):] for k in runs[0] if k.startswith("local/")):
        a, b = runs[0][f"local/{key}"], runs[1][f"local/{key}"]
        whole = runs[0][f"p/{key}"]
        if a.shape == whole.shape:
            _same_bits({key: a}, {key: b})
        else:
            halves += 1
            dim = next(d for d in range(a.ndim) if a.shape[d] != whole.shape[d])
            assert np.array_equal(np.concatenate([a, b], axis=dim), whole), key
    assert halves > 0


def test_tp_state_gathers_to_the_single_process_checkpoint(two_ranks):
    out, _, _ = two_ranks
    for r in range(2):
        checks = json.loads((out / f"tp_checks_r{r}.json").read_text())
        assert checks["same_file"] and checks["sharded_keys"], checks


def test_tp_replicated_state_step_is_bitwise_the_plain_step(two_ranks):
    out, _, _ = two_ranks
    for r in range(2):
        assert json.loads((out / f"tp_checks_r{r}.json").read_text())["replicated_step_is_plain"]


def test_rl_round_tp_leaves_one_state(two_ranks):
    out, _, _ = two_ranks
    a, b = _load(out, "rl_round_tp", 0), _load(out, "rl_round_tp", 1)
    _same_bits(a, b)
    assert np.isfinite(a["total"])


def test_tp_dp_2x2_step_equals_single_process_step(four_ranks):
    """dp and tp together on a (2, 2) mesh: every rank gathers one state,
    one process's step on the whole batch within the constants."""
    out, _, batch = four_ranks
    runs = [{k: v for k, v in _load(out, "tp22_FastPolicy", r).items()
             if not k.startswith("local/")} for r in range(4)]
    for run in runs[1:]:
        _same_bits(runs[0], run)
    _assert_single_process_step(runs[0], "FastPolicy", batch, steps=1)


def test_rl_round_replicated(two_ranks):
    out, _, _ = two_ranks
    a, b = _load(out, "rl_round", 0), _load(out, "rl_round", 1)
    _same_bits(a, b)
    assert np.isfinite(a["total"])


def test_manager_writes_from_the_coordinator_only(two_ranks):
    out, work, _ = two_ranks
    runs = [json.loads((out / f"manager_r{r}.json").read_text()) for r in range(2)]
    _same_bits(_load(out, "manager", 0), _load(out, "manager", 1))
    for r, run in enumerate(runs):
        assert all(np.isfinite(t) for t in run["total"]) and min(run["samples"]) > 0
        assert run["metadata"] == runs[0]["metadata"] == {
            "last_checkpoint": 1, "best_checkpoint": run["metadata"]["best_checkpoint"],
            "learning_steps": 4}
    # rank 1 writes its own replay shard and nothing else
    mine = runs[1]["written"]
    assert mine and all("_h1" in Path(p).name for p in mine), mine
    assert {"train_buffer/buffer_0_h1.npz", "train_buffer/buffer_1_h1.npz"} <= set(mine)
    coord = set(runs[0]["written"])
    for name in ("checkpoint/network_0.msgpack", "checkpoint/network_1.msgpack",
                 "checkpoint/network_swa.msgpack", "metadata.json", "training_history.txt",
                 "gating.txt", "train_buffer/buffer_0_h0.npz"):
        assert name in coord, (name, sorted(coord))
    assert not any("_h1" in Path(p).name for p in coord)
    assert sorted(p.name for p in (work / "train_buffer").iterdir()) == [
        "buffer_0_h0.npz", "buffer_0_h1.npz", "buffer_1_h0.npz", "buffer_1_h1.npz"]
    lines = (work / "training_history.txt").read_text().splitlines()
    assert len(lines) == 2  # one line an iteration, from the coordinator alone


def test_param_shardings_make_the_jax_choice(two_ranks):
    """At tp = 2, the flagship's kernels whose flax output axis divides by 2
    are sharded over tp on the torch dim that holds that axis, the others
    replicated: the JAX package's `param_shardings` on the flax tree."""
    import jax
    import jax.numpy as jnp

    from alphagomoku_tpu.models import create_network as jax_network
    from alphagomoku_tpu.parallel import sharding as JS
    from alphagomoku_tpu_torch.models import convert

    out, _, _ = two_ranks
    got = json.loads((out / "shardings.json").read_text())
    assert got["dp"] == ["Replicate()"] and got["off"] == ["(Replicate(), Replicate())"]
    net = jax_network("ConvNextPVQMraw")
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros((1, 15, 15, 8)),
                                             train=False))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))
    specs = JS.param_shardings(mesh, shapes, tensor_parallel=True)
    flat = {}
    for coll in ("params", "batch_stats"):
        for path, spec in jax.tree_util.tree_flatten_with_path(specs[coll])[0]:
            flat[(coll,) + tuple(p.key for p in path)] = "tp" in tuple(spec.spec)
    blocks = convert._block_names(got["tp"])
    torch_net = create_network("ConvNextPVQMraw")
    shapes_t = {k: tuple(v.shape) for k, v in torch_net.state_dict().items()}
    assert len(got["tp"]) == len(flat)
    sharded = 0
    for key, placement in got["tp"].items():
        path = convert._flax_path(key, blocks)
        assert flat[path] == placement.startswith("Shard"), (key, placement)
        if flat[path]:
            sharded += 1
            # conv and dense kernels: flax's output axis is torch's dim 0
            assert placement == "Shard(dim=0)", (key, placement, shapes_t[key])
    assert sharded > 0


def test_world_size_one_dp_step_is_bitwise_the_plain_step(tmp_path):
    """A DP step over a world-size-1 gloo group gives the plain step's
    parameters, statistics, gradients and losses bit for bit."""
    batch = _global_batch()
    tensors = {k: torch.from_numpy(v) for k, v in batch.items() if k != "modes"}
    modes = torch.from_numpy(batch["modes"][0])
    tables = V.device_tables(GameRules.FREESTYLE)
    D.initialize(f"file://{tmp_path}/store", 1, 0, backend="gloo")
    try:
        mesh = make_mesh()
        for arch in ARCHS:
            nets, losses = [], []
            for dp in (False, True):
                net = create_network(arch, 1, 8, H, W)  # bf16, as the manager trains
                init_random_(net, torch.Generator().manual_seed(5))
                state, tx = T.create_train_state(net, T.TrainConfig())
                step = T.make_train_step(net, tx, tables, T.TrainConfig())
                if dp:
                    step = D.make_dp_train_step(step, mesh)
                    state, parts = step(state, D.global_batch_from_local(mesh, tensors), modes)
                else:
                    state, parts = step(state, tensors, modes)
                nets.append(net)
                losses.append(parts)
            a, b = nets
            for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
                assert torch.equal(x, y), k
            for (k, x), y in zip(a.named_parameters(), b.parameters()):
                assert torch.equal(x.grad, y.grad), k
            assert all(torch.equal(losses[0][k], losses[1][k]) for k in losses[0])
    finally:
        dist.destroy_process_group()
