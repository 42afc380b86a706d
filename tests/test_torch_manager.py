"""The port's TrainingManager on the CPU: one `run_iteration_rl` of a tiny
run (ConvNextPVQMraw 1x16 on 6x6, 4 games of 2 sims, no leaf solver, 2
train steps, evaluation against network_0 in line, gating on with 2 games
against network_0, saved before it), whose
checkpoints, SWA file and replay buffer the JAX package reads (flax's
`serialization.from_bytes` onto a template, the JAX `ReplayBuffer`),
with no JAX manager built; the port's manager resuming a copy of the JAX
run in `runs/flagship_r4/` with the same metadata and weights and its
idempotent skip; and the hand-over of trained weights to the searches.

The run is cut to 6x6 and 2 sims: at 9x9 and 4 sims the same iteration
took 52 s on a CPU (self-play 22.6 s, gating 29.4 s), over the 30 s a
port test file may take."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.models.convert import to_flax
from alphagomoku_tpu_torch.ops import convnext_fused as CF
from alphagomoku_tpu_torch.training import manager as TMGR
from alphagomoku_tpu_torch.training import train as T
from alphagomoku_tpu_torch.utils import checkpoint
from tests.test_torch_network import _flatten

torch.set_num_threads(1)

RUN = Path(__file__).resolve().parents[1] / "runs" / "flagship_r4"
N = 6


def _cfg(wd, **kw):
    return TMGR.ManagerConfig(
        working_dir=str(wd), rows=N, cols=N, blocks=1, filters=16, games_per_iteration=4,
        selfplay_batch=4, num_simulations=2, train_steps_per_iteration=2, train_batch_size=16,
        gating_games=2, leaf_solver="none", use_evaluation=True, eval_in_parallel=False,
        eval_games=2, eval_opponents=(-1,), **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """network_0 saved from a fresh manager, then iteration 1."""
    wd = tmp_path_factory.mktemp("manager")
    mgr = TMGR.TrainingManager(_cfg(wd), device="cpu")
    mgr.save_checkpoint(0)
    metrics = mgr.run_iteration_rl(1)
    return wd, mgr, metrics


def _flax_template():
    import jax
    import jax.numpy as jnp
    from alphagomoku_tpu.models import create_network as jax_create_network

    net = jax_create_network("ConvNextPVQMraw", blocks=1, filters=16)
    return jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros((1, N, N, 8)),
                                           train=False))


def test_iteration_writes_the_run(run):
    wd, mgr, metrics = run
    for name in ("network_0", "network_1", "network_swa"):
        assert (wd / "checkpoint" / f"{name}.msgpack").exists(), name
    assert (wd / "train_buffer" / "buffer_1.npz").exists()
    assert not list((wd / "saved_state").iterdir())  # round snapshots folded in
    meta = json.loads((wd / "metadata.json").read_text())
    assert meta["last_checkpoint"] == 1 and meta["learning_steps"] == 2
    assert meta["best_checkpoint"] == (1 if metrics["promoted"] else 0)
    hist = [json.loads(l) for l in (wd / "training_history.txt").read_text().splitlines()]
    assert hist[-1]["iteration"] == 1
    assert all(np.isfinite(hist[-1][k]) for k in ("policy", "value", "q", "moves_left", "total"))
    gate = json.loads((wd / "gating.txt").read_text().splitlines()[-1])
    assert gate["iteration"] == 1 and gate["vs_best"] == 0
    assert sum(gate["pentanomial"]) == 1 and gate["truncated"] == 0
    rating = json.loads((wd / "rating.txt").read_text().splitlines()[-1])
    assert rating["iteration"] == 1 and rating["opponent"] == "AG_000"
    assert sum(rating["pentanomial"]) == 1
    res = mgr.last_gating
    assert (res.outcomes != 0).all() and (res.game_lengths > 4).all()
    stats = json.loads((wd / "buffer_stats.txt").read_text().splitlines()[-1])
    assert stats["iteration"] == 1 and stats["samples"] == metrics["samples"] > 0
    assert set(mgr.last_timings) == {"selfplay", "train", "train_steps", "evaluate", "gating"}
    assert mgr.net.training


def test_jax_reads_the_port_run(run):
    """flax reads network_1 (the live weights) and the SWA file (the mean
    of network_0 and network_1) bit for bit; the JAX ReplayBuffer loads the
    port's buffer file."""
    import jax
    from flax import serialization
    from alphagomoku_tpu.data.replay import ReplayBuffer as JaxReplayBuffer
    from alphagomoku_tpu.training.train import average_params as jax_average_params

    wd, mgr, _ = run
    template = _flax_template()
    read = lambda name: jax.tree_util.tree_map(np.asarray, serialization.from_bytes(
        template, (wd / "checkpoint" / f"{name}.msgpack").read_bytes()))
    net1 = read("network_1")
    ours = _flatten(to_flax(mgr.net.state_dict()))
    theirs = _flatten({"params": net1["params"], "batch_stats": net1["batch_stats"]})
    assert sorted(ours) == sorted(theirs)
    assert all(np.array_equal(ours[k], theirs[k]) for k in ours)
    swa = read("network_swa")
    want = jax_average_params([read("network_0")["params"], net1["params"]])
    flat_swa, flat_want = _flatten(swa["params"]), _flatten(jax.tree_util.tree_map(np.asarray, want))
    assert all(np.array_equal(flat_swa[k], flat_want[k]) for k in flat_want)
    jbuf = JaxReplayBuffer()
    jbuf.load_generation(1, str(wd / "train_buffer" / "buffer_1.npz"))
    mine = mgr.buffer.generations[max(mgr.buffer.generations)]
    assert all(np.array_equal(jbuf.generations[1][k], mine[k]) for k in mine)


def test_resume_skips_finished_work(run, monkeypatch):
    """A second manager on the run resumes network_1 and loads buffer_1
    in place of playing."""
    wd, mgr, _ = run
    again = TMGR.TrainingManager(_cfg(wd), device="cpu")
    assert again.metadata["last_checkpoint"] == 1
    for (k, a), b in zip(mgr.net.state_dict().items(), again.net.state_dict().values()):
        assert torch.equal(a, b), k
    monkeypatch.setattr(TMGR, "play_games_resumable", None)  # playing would raise
    n = again.generate_games(1)
    assert n == len(np.load(wd / "train_buffer" / "buffer_1.npz")["stm"])


def test_resume_reference_run(tmp_path, monkeypatch):
    """The port's manager at its defaults resumes a copy of the JAX run's
    files: last checkpoint 28, best 23, 11,600 learning steps, network_28's
    arrays bit for bit, and generate_games(28) loads buffer_28.npz."""
    for rel in ("metadata.json", "checkpoint/network_28.msgpack", "train_buffer/buffer_28.npz"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(RUN / rel, tmp_path / rel)
    mgr = TMGR.TrainingManager(TMGR.ManagerConfig(working_dir=str(tmp_path)), device="cpu")
    assert mgr.metadata == {"last_checkpoint": 28, "best_checkpoint": 23,
                            "learning_steps": 11600}
    ref = _flatten(checkpoint.load(RUN / "checkpoint/network_28.msgpack"))
    ours = _flatten(to_flax(mgr.net.state_dict()))
    assert sorted(ours) == sorted(ref)
    assert all(np.array_equal(ours[k], ref[k]) for k in ref)
    monkeypatch.setattr(TMGR, "play_games_resumable", None)
    assert mgr.generate_games(28) == len(np.load(RUN / "train_buffer/buffer_28.npz")["stm"])
    assert list(mgr.buffer.generations) == [28]


def test_distributed_raises_naming_roadmap(tmp_path):
    """`ManagerConfig(distributed=True)` runs: over a world-size-1 gloo
    group one iteration writes the coordinator's checkpoint and metadata
    and its `_h0` replay shard; the mesh holds the manager's device, and
    the checkpoint is written through `full_state_dict` (which gathers a
    state placed over tp; this one is whole), byte for byte the
    single-process writer's file (the 2-process run, tensor parallelism
    included, is tests/test_torch_distributed.py)."""
    import torch.distributed as dist

    from alphagomoku_tpu_torch.models.convert import to_flax
    from alphagomoku_tpu_torch.parallel import distributed as D
    from alphagomoku_tpu_torch.parallel import full_state_dict
    from alphagomoku_tpu_torch.utils import checkpoint

    D.initialize(f"file://{tmp_path}/store", 1, 0, backend="gloo")
    try:
        wd = tmp_path / "run"
        mgr = TMGR.TrainingManager(_cfg(wd, distributed=True), device="cpu")
        assert (mgr.n_hosts, mgr.host, mgr.is_coordinator) == (1, 0, True)
        assert mgr.mesh.device_type == "cpu"
        metrics = mgr.run_iteration_rl(0)
        assert metrics["samples"] > 0 and np.isfinite(metrics["total"])
        assert (wd / "train_buffer" / "buffer_0_h0.npz").exists()
        written = (wd / "checkpoint" / "network_0.msgpack").read_bytes()
        assert written == checkpoint.to_bytes(to_flax(mgr.net.state_dict()))
        assert written == checkpoint.to_bytes(to_flax(full_state_dict(mgr.net)))
        assert json.loads((wd / "metadata.json").read_text())["learning_steps"] == 2
    finally:
        dist.destroy_process_group()


def test_hand_over_packs_a_fresh_snapshot(run):
    """`_host_vars()` after a train step: its forward is the trained
    module's inference forward, it shares no tensor with the module, a
    later step leaves it as it was, and the module stays in train mode."""
    _, mgr, _ = run
    planes = (torch.rand((4, N, N, 8), generator=torch.Generator().manual_seed(0)) < 0.3).float()
    weights = mgr._host_vars()
    assert mgr.net.training and not weights.net.training
    live = {t.data_ptr() for t in mgr.net.state_dict().values()}
    assert not live & {t.data_ptr() for t in weights.net.state_dict().values()}
    assert not live & {t.data_ptr() for t in weights.trunk}
    want = mgr.net(planes)
    got = weights.net(planes)
    for a, b in zip(want, got):
        assert a is None or torch.equal(a, b)
    fused = CF.fused_apply(weights, planes)  # the plain trunk on the CPU
    assert (fused.value_logits - want.value_logits).abs().max() <= 0.05 * max(
        1e-3, float(want.value_logits.abs().max())) + 5e-3
    before = [t.clone() for t in weights.trunk]
    batch = mgr.buffer.sample(16, np.random.default_rng(0))
    mgr._train_step(mgr.state, mgr._batch(batch), T.draw_modes(mgr.generator, 16, N, N))
    assert all(torch.equal(a, b) for a, b in zip(before, weights.trunk))
    assert not torch.equal(mgr._host_vars().trunk.w1, weights.trunk.w1)
    assert mgr.net.training
