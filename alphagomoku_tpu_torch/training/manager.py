"""Training manager: the reinforcement-learning orchestration loop.

Port of the reference package's `training/manager.py` (reference:
src/selfplay/TrainingManager.cpp), on one device (`device="cuda"` unless
the caller asks for the CPU):

- working-directory layout checkpoint/ train_buffer/ valid_buffer/
  saved_state/ metadata.json (reference: TrainingManager.cpp:141-167)
- runIterationRL = generate games -> train -> (optional) gating
  (reference: :84-137)
- checkpoints network_N.msgpack + SWA average of the last k, in the
  reference package's flax msgpack format, so that either package resumes
  the other's runs (reference: :226-273, NetworkLoader.cpp:41-53)
- metadata {last_checkpoint, best_checkpoint, learning_steps}
- append-only training_history.txt / buffer_stats.txt / gating.txt /
  rating.txt metric logs (reference: SupervisedLearning.cpp:265-304,
  TrainingManager.cpp:393-412)
- SIGINT-graceful stop between phases (reference: os_utils
  setupSignalHandler polling, TrainingManager.cpp:88-92)

The network, of any architecture of the zoo, is trained in place
(`train.TrainState`); self-play, the openings, gating and evaluation
search with `models.forward.network_apply` of it, the fused trunk for the
convnext trunk and the module's forward for the others, on a fresh
snapshot (`_host_vars()`), so that they never share tensors with the
module being trained.  Device-side draws come from `torch.Generator`s
seeded from the manager's numpy generator, one per self-play round and
per opening set, and from one generator for the train step's symmetries.

With `ManagerConfig(distributed=True)` (after
`parallel.distributed.initialize()`, one process per device, a working
directory every rank shares) each rank plays its own games from its own
generators (`host_fold`) into its own replay shard (`_h{rank}` files),
the learner is data-parallel over every rank (`make_dp_train_step`, the
symmetries drawn alike on every rank from the shared seed and the global
step), the replicated train state stays identical on every rank, and the
coordinator alone writes checkpoints, metadata and the metric logs and
plays gating and evaluation; `barrier`s order its writes before the
other ranks read them.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import signal
import time
from typing import Callable

import numpy as np
import torch

from ..data.replay import ReplayBuffer
from ..game import vectorized as V
from ..game.types import GameRules
from ..models.convert import from_flax, to_flax
from ..models.forward import net_apply_for, network_apply
from ..models.networks import AGNetwork, create_network, init_flax_
from ..parallel import distributed as D
from ..search import mcts
from ..selfplay import (
    SelfplayConfig,
    generate_balanced_openings,
    make_targets,
    opening_env,
    play_games_resumable,
)
from ..utils import checkpoint
from ..utils.misc import get_simulations_for_move
from . import train as T


@dataclasses.dataclass
class ManagerConfig:
    """(reference: MasterLearningConfig + TrainingConfig,
    utils/configs.hpp:188-255)"""

    working_dir: str
    rules: GameRules = GameRules.FREESTYLE
    rows: int = 15
    cols: int = 15
    architecture: str = "ConvNextPVQMraw"
    blocks: int = 6
    filters: int = 64
    games_per_iteration: int = 256
    selfplay_batch: int = 256
    num_simulations: int = 100
    train_steps_per_iteration: int = 200
    train_batch_size: int = 256
    buffer_window: int = 20
    swa_checkpoints: int = 10
    learning_rate: float = 1e-3
    gating_games: int = 64
    use_gating: bool = True  # promote a checkpoint only when it beats the
    # incumbent (reference default: gating on)
    use_evaluation: bool = False  # multi-opponent rating of each checkpoint
    # (reference: TrainingManager::evaluate vs config opponents,
    # TrainingManager.cpp:277-309)
    eval_opponents: tuple = (-1, -2, -4)  # relative checkpoint offsets
    eval_games: int = 32  # paired games per opponent
    eval_in_parallel: bool = True  # overlap evaluate() with the next
    # generation (reference: std::async future, TrainingManager.cpp:100-126)
    validation_fraction: float = 0.05  # (reference: validation_percent,
    # TrainingManager.cpp:188 + valid_buffer/ split)
    leaf_solver: str = "vct"  # none | vcf | vct: per-leaf proof search in
    # selfplay searches (reference: Search::solve, Search.cpp:159-183)
    leaf_solver_steps: int = 16
    leaf_solver_cap: int = 256  # >0: per-step solve width cap
    balanced_openings: bool = True  # start selfplay/gating games from
    # NN-balanced openings (reference: OpeningGenerator +
    # GameGenerator PREPARE_OPENING, GameGenerator.cpp:60-75)
    opening_stones: int = 4
    tree_reuse: bool = True  # carry subtrees between selfplay moves
    # (reference: Tree::setBoard reachable-subtree reuse, Tree.cpp:128-151)
    selfplay_chunk_moves: int = 16  # plies per chunk; SIGINT between
    # chunks snapshots every in-flight game (reference: GeneratorManager
    # mid-game state save, GeneratorManager.cpp:240-291)
    sampler: str = "visits"  # visits | values (reference: createSampler,
    # src/dataset/Sampler.cpp)
    distill_from: str = ""  # optional teacher checkpoint path -> distillation
    # training (reference: SupervisedLearning distillation, :155-230)
    distill_architecture: str = ""  # teacher arch (defaults to `architecture`)
    distill_blocks: int = 0
    distill_filters: int = 0
    distributed: bool = False  # multi-device mode: self-play per rank with
    # per-rank generators + per-rank replay, DP learner over every rank,
    # coordinator-only checkpoint/metadata IO (requires
    # parallel.distributed.initialize() first and a shared working_dir)
    seed: int = 0


class _SigintFlag:
    """(reference: setupSignalHandler/hasCapturedSignal,
    utils/os_utils.hpp:47-63)"""

    def __init__(self):
        self.hit = False
        self._prev = signal.signal(signal.SIGINT, self._on)

    def _on(self, *_):
        self.hit = True

    def restore(self):
        signal.signal(signal.SIGINT, self._prev)


class TrainingManager:
    def __init__(self, cfg: ManagerConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # multi-device layout: per-rank replay + per-rank generators + DP
        # learner over every rank; the coordinator owns all file writes
        self.n_hosts = D.process_count() if cfg.distributed else 1
        self.host = D.process_index() if cfg.distributed else 0
        self.is_coordinator = self.host == 0
        if cfg.distributed and self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        wd = cfg.working_dir
        for sub in ("checkpoint", "train_buffer", "valid_buffer", "saved_state"):
            os.makedirs(os.path.join(wd, sub), exist_ok=True)
        self.metadata_path = os.path.join(wd, "metadata.json")
        self.metadata = self._load_metadata()
        self.tables = V.device_tables(cfg.rules)
        # `rng` is consumed alike on every rank (self-play seeds are folded
        # per rank); `host_rng` is the per-rank stream for rank-local draws
        # (the validation split, sampling)
        self.rng = np.random.default_rng(cfg.seed)
        self.host_rng = np.random.default_rng((cfg.seed + 1) * 1_000_003 + self.host)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.buffer = ReplayBuffer(cfg.buffer_window)
        self.valid_buffer = ReplayBuffer(cfg.buffer_window)

        self.net = self._init_or_load_network()
        self.train_cfg = T.TrainConfig(learning_rate=cfg.learning_rate)
        self.state, self.tx = T.create_train_state(self.net, self.train_cfg)
        self._train_step = T.make_train_step(self.net, self.tx, self.tables, self.train_cfg)
        if cfg.distributed:
            from ..parallel import make_mesh

            self.mesh = make_mesh()  # one dp axis over every rank's device
            if cfg.train_batch_size % self.n_hosts != 0:
                raise ValueError(
                    f"train_batch_size={cfg.train_batch_size} not divisible "
                    f"by global dp={self.n_hosts}"
                )
            # replicated train state: the same seed or checkpoint on every
            # rank, made identical bit for bit from the coordinator's copy
            for t in self.net.state_dict().values():
                torch.distributed.broadcast(t, 0)
            self._train_step = D.make_dp_train_step(self._train_step, self.mesh)
        self._apply = net_apply_for(self.net.cfg)
        self._play_mcfg = None
        self.last_timings: dict[str, float] = {}

    def _host_vars(self):
        """The network's variables as the searches take them
        (`network_apply`): a detached snapshot of the module being trained
        (for the convnext trunk a fresh `FusedWeights`), so that self-play,
        openings, gating and evaluation neither see later optimizer steps
        nor share tensors with training.  `self._apply` evaluates them."""
        return network_apply(self.net)[1]

    def _new_net(self, arch: str | None = None, blocks: int = 0, filters: int = 0) -> AGNetwork:
        cfg = self.cfg
        return create_network(arch or cfg.architecture, blocks or cfg.blocks,
                              filters or cfg.filters, cfg.rows, cfg.cols)

    def _load_net(self, path: str, **arch) -> AGNetwork:
        """A network of the manager's architecture holding the weights of
        the checkpoint file `path`, on the manager's device."""
        net = self._new_net(**arch)
        net.load_state_dict(from_flax(checkpoint.load(path)))
        return net.to(self.device)

    def _generator(self, per_rank: bool = False) -> torch.Generator:
        """A generator on the device seeded from the manager's numpy
        generator, as the reference package draws a key from it; with
        `per_rank` in distributed mode, the seed is folded with the rank
        (`host_fold`), so that the ranks play different games."""
        seed = int(self.rng.integers(2**31))
        if per_rank and self.cfg.distributed:
            seed = D.host_fold(seed)
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- metadata / checkpoints -------------------------------------------

    def _load_metadata(self) -> dict:
        if os.path.exists(self.metadata_path):
            with open(self.metadata_path) as fh:
                return json.load(fh)
        return {"last_checkpoint": -1, "best_checkpoint": -1, "learning_steps": 0}

    def _save_metadata(self) -> None:
        if not self.is_coordinator:
            return  # coordinator-only IO; in-memory metadata stays in sync
        tmp = self.metadata_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.metadata, fh, indent=2)
        os.replace(tmp, self.metadata_path)

    def checkpoint_path(self, n: int, swa: bool = False) -> str:
        name = "network_swa.msgpack" if swa else f"network_{n}.msgpack"
        return os.path.join(self.cfg.working_dir, "checkpoint", name)

    def _init_or_load_network(self) -> AGNetwork:
        last = self.metadata["last_checkpoint"]
        if last >= 0 and os.path.exists(self.checkpoint_path(last)):
            return self._load_net(self.checkpoint_path(last))
        net = init_flax_(self._new_net(), torch.Generator().manual_seed(self.cfg.seed))
        return net.to(self.device)

    def save_checkpoint(self, n: int) -> None:
        if self.is_coordinator:
            checkpoint.save(self.checkpoint_path(n), to_flax(self.net.state_dict()))
        self.metadata["last_checkpoint"] = n
        if self.metadata["best_checkpoint"] < 0:
            self.metadata["best_checkpoint"] = n
        self._save_metadata()
        if self.is_coordinator:
            self._save_swa(n)
        if self.cfg.distributed:
            # order the coordinator's writes before any rank reads the
            # checkpoint back
            D.barrier(f"ckpt_{n}")

    def _save_swa(self, n: int) -> None:
        """Average the last k checkpoints (reference: network_swa.bin from 10
        checkpoints, TrainingManager.cpp:270-272)."""
        paths = [
            self.checkpoint_path(i)
            for i in range(max(0, n - self.cfg.swa_checkpoints + 1), n + 1)
        ]
        paths = [p for p in paths if os.path.exists(p)]
        if len(paths) < 2:
            return
        loaded = [checkpoint.load(p) for p in paths]
        swa = {"params": T.average_params([v["params"] for v in loaded]),
               "batch_stats": loaded[-1]["batch_stats"]}
        checkpoint.save(self.checkpoint_path(0, swa=True), swa)

    # -- iteration phases --------------------------------------------------

    def generate_games(self, iteration: int,
                       on_move: Callable[[int, object], None] | None = None) -> int:
        """One selfplay generation -> replay buffer + buffer file
        (reference: TrainingManager::generateGames + idempotent skip,
        TrainingManager.cpp:175-225).  `on_move(move, carry)` sees each
        searched move's carry.  In distributed mode each rank writes its
        own `_h{rank}` files."""
        hs = f"_h{self.host}" if self.cfg.distributed else ""
        buf_path = os.path.join(self.cfg.working_dir, "train_buffer",
                                f"buffer_{iteration}{hs}.npz")
        if os.path.exists(buf_path):
            self.buffer.load_generation(iteration, buf_path)
            return self.buffer.num_samples
        cfg = self.cfg
        # draw-rate-based dynamic simulation reduction (reference:
        # get_simulations_for_move, misc.cpp:171, GameGenerator.cpp:97-99),
        # quantized to quarters
        draw_rate = self.buffer.stats()["draw_rate"] if self.buffer.num_samples else 0.0
        sims = get_simulations_for_move(
            draw_rate, cfg.num_simulations, max(8, cfg.num_simulations // 4)
        )
        quantum = max(1, cfg.num_simulations // 4)
        sims = max(quantum, (sims // quantum) * quantum)
        mcfg = mcts.MCTSConfig(
            max_nodes=(2 * sims + 8) if cfg.tree_reuse else (sims + 8),
            max_edges=32,
            max_depth=32,
            leaf_solver=cfg.leaf_solver,
            leaf_solver_steps=cfg.leaf_solver_steps,
            leaf_solver_cap=cfg.leaf_solver_cap,
        )
        scfg = SelfplayConfig(
            num_simulations=sims,
            max_moves=min(cfg.rows * cfg.cols, 160),
            tree_reuse=cfg.tree_reuse,
        )
        self._play_mcfg = mcfg
        weights = self._host_vars()
        total = 0
        rounds = max(1, cfg.games_per_iteration // cfg.selfplay_batch)
        state_dir = os.path.join(cfg.working_dir, "saved_state")
        sig = _SigintFlag()
        try:
            for r in range(rounds):
                gen_id = iteration * 1000 + r
                part_path = os.path.join(state_dir, f"part_{gen_id}{hs}.npz")
                if os.path.exists(part_path):
                    # interrupted run left a finished round: resume from it
                    # (reference: GeneratorManager state save/load,
                    # GeneratorManager.cpp:240-291)
                    self.buffer.load_generation(gen_id, part_path)
                    total += len(self.buffer.generations[gen_id]["stm"])
                    continue
                gen = self._generator(per_rank=True)
                init_env = None
                if cfg.balanced_openings:
                    # NN+search-balanced openings (reference:
                    # OpeningGenerator, GameGenerator PREPARE_OPENING)
                    boards = generate_balanced_openings(
                        self._apply, weights, self.tables, gen, cfg.selfplay_batch,
                        cfg.rows, cfg.cols, stones=cfg.opening_stones,
                        raw_input=self.net.cfg.raw_input,
                    )
                    init_env = opening_env(boards, cfg.opening_stones)
                last_print = [time.time()]

                def _on_stats(d, gen_id=gen_id):
                    # periodic aggregated stats (reference: GeneratorManager
                    # prints every 60 s, GeneratorManager.cpp:219-239)
                    if time.time() - last_print[0] >= 60.0:
                        print(f"selfplay[{gen_id}]: {json.dumps(d)}")
                        last_print[0] = time.time()

                result = play_games_resumable(
                    self._apply, weights, self.tables, mcfg, scfg, gen, cfg.selfplay_batch,
                    cfg.rows, cfg.cols, chunk_moves=cfg.selfplay_chunk_moves,
                    should_stop=lambda: sig.hit,
                    snapshot_path=os.path.join(state_dir, f"midgame_{gen_id}{hs}.npz"),
                    init_env=init_env, on_stats=_on_stats, on_move=on_move, device=self.device,
                )
                if result is None:
                    # preempted mid-generation; the snapshot resumes next run
                    return total
                targets = make_targets(result, cfg.rows * cfg.cols)
                # train/validation split (reference: splitBuffer into
                # train_buffer/ + valid_buffer/, TrainingManager.cpp:214)
                tv = targets["valid"].cpu().numpy()
                split = self.host_rng.random(tv.shape) < cfg.validation_fraction
                total += self.buffer.add_generation(gen_id, dict(targets, valid=tv & ~split))
                self.valid_buffer.add_generation(gen_id, dict(targets, valid=tv & split))
                self.buffer.save_generation(gen_id, part_path)
                if sig.hit:
                    return total  # partial rounds persist for resume
        finally:
            sig.restore()
        self.buffer.save_generation(max(self.buffer.generations), buf_path)
        if self.valid_buffer.num_samples:
            self.valid_buffer.save_generation(
                max(self.valid_buffer.generations),
                os.path.join(cfg.working_dir, "valid_buffer", f"buffer_{iteration}{hs}.npz"),
            )
        for r in range(rounds):  # round snapshots fold into the buffer file
            part = os.path.join(state_dir, f"part_{iteration * 1000 + r}{hs}.npz")
            if os.path.exists(part):
                os.remove(part)
        with open(os.path.join(cfg.working_dir, f"buffer_stats{hs}.txt"), "a") as fh:
            fh.write(json.dumps({"iteration": iteration, **self.buffer.stats()}) + "\n")
        return total

    def _distill_setup(self):
        """Lazy teacher load + distillation step (reference:
        SupervisedLearning distillation, SupervisedLearning.cpp:155-230)."""
        if not hasattr(self, "_distill"):
            cfg = self.cfg
            arch = dict(arch=cfg.distill_architecture or cfg.architecture,
                        blocks=cfg.distill_blocks or cfg.blocks,
                        filters=cfg.distill_filters or cfg.filters)
            teacher = self._load_net(cfg.distill_from, **arch)
            step = T.make_distill_step(self.net, teacher, self.tx, self.tables, self.train_cfg)
            if cfg.distributed:
                # the same DP treatment as the plain train step
                step = D.make_dp_train_step(step, self.mesh)
            self._distill = (step, teacher)
        return self._distill

    def _batch(self, batch_np: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch_np.items()}

    def train_iteration(self, iteration: int) -> dict:
        """(reference: runIterationSL -> SupervisedLearning::train,
        TrainingManager.cpp:226-273).  The seconds of the step loop, the
        losses read back included, land in `last_timings["train_steps"]`."""
        cfg = self.cfg
        history = []
        distill = self._distill_setup() if cfg.distill_from else None
        t0 = time.perf_counter()
        if cfg.distributed:
            # DP learner over every rank: each rank samples a local
            # sub-batch from ITS replay shard; the symmetries of the global
            # batch must be alike on every rank, so they derive from the
            # shared seed and the global step, never from host_rng
            batches = self.buffer.iter_batches(
                cfg.train_batch_size // self.n_hosts, cfg.train_steps_per_iteration,
                self.host_rng, sampler=cfg.sampler,
            )
        else:
            batches = self.buffer.iter_batches(
                cfg.train_batch_size, cfg.train_steps_per_iteration, self.rng, sampler=cfg.sampler,
            )
        for i, batch_np in enumerate(batches):
            if cfg.distributed:
                batch = D.global_batch_from_local(self.mesh, batch_np)
                sym = torch.Generator(device=self.device).manual_seed(D.fold_seed(
                    (cfg.seed + 1) * 7_919, self.metadata["learning_steps"] + i))
                modes = T.draw_modes(sym, batch.global_size, cfg.rows, cfg.cols)
            else:
                batch = self._batch(batch_np)
                modes = T.draw_modes(self.generator, len(batch_np["stm"]), cfg.rows, cfg.cols)
            if distill is not None:
                step, teacher = distill
                self.state, parts = step(self.state, teacher, batch, modes)
            else:
                self.state, parts = self._train_step(self.state, batch, modes)
            history.append(parts)
        self.metadata["learning_steps"] += len(history)
        mean = {}
        if history:
            # one host read for the whole iteration's losses
            values = torch.stack([torch.stack(list(h.values())) for h in history]).cpu()
            mean = {k: float(np.mean(values[:, i].double().numpy()))
                    for i, k in enumerate(history[0])}
        self.last_timings["train_steps"] = time.perf_counter() - t0
        # validation pass with top-k accuracy (reference:
        # SupervisedLearning validation + training_history.txt,
        # SupervisedLearning.cpp:231-304); in distributed mode each rank
        # validates its local shard on its local copy of the state, with no
        # collective
        if self.valid_buffer.num_samples >= 64:
            if not hasattr(self, "_eval_step"):
                self._eval_step = T.make_eval_step(self.net, self.tables, self.train_cfg)
            vbatch = self.valid_buffer.sample(
                min(1024, self.valid_buffer.num_samples), self.host_rng
            )
            vparts = self._eval_step(self.state, self._batch(vbatch))
            mean.update({f"valid_{k}": float(v) for k, v in vparts.items()})
        if self.is_coordinator:
            with open(os.path.join(cfg.working_dir, "training_history.txt"), "a") as fh:
                fh.write(json.dumps({"iteration": iteration, **mean}) + "\n")
        self.save_checkpoint(iteration)
        return mean

    def evaluate(self, iteration: int) -> list:
        """Rate checkpoint `iteration` against K earlier checkpoints in one
        multi-opponent lockstep run, appending per-opponent results to
        rating.txt (reference: TrainingManager::evaluate with
        EvaluationManager::setSecondPlayer per thread,
        TrainingManager.cpp:277-309, EvaluationManager.hpp:29-52)."""
        from ..eval.match import Opponent, play_multi_match, random_openings

        cfg = self.cfg
        raw = self.net.cfg.raw_input
        opponents = []
        seen = set()
        for off in cfg.eval_opponents:
            idx = max(0, iteration + int(off))
            if idx in seen or idx == iteration:
                continue
            path = self.checkpoint_path(idx)
            if not os.path.exists(path):
                continue
            seen.add(idx)
            opponents.append(Opponent(*network_apply(self._load_net(path)), raw,
                                      name=f"AG_{idx:03d}"))
        if not opponents:
            return []
        # the candidate loads from its checkpoint FILE, not live state: the
        # evaluation may overlap the next training iteration
        apply, last = network_apply(self._load_net(self.checkpoint_path(iteration)))
        openings = random_openings(self.rng, cfg.eval_games // 2, cfg.rows, cfg.cols)
        results = play_multi_match(
            apply, last, opponents, self.tables,
            mcts.MCTSConfig(max_nodes=cfg.num_simulations + 8, max_edges=32, max_depth=32),
            cfg.num_simulations, openings, raw_input_a=raw, device=self.device,
        )
        with open(os.path.join(cfg.working_dir, "rating.txt"), "a") as fh:
            for op, res in zip(opponents, results):
                fh.write(json.dumps({
                    "iteration": iteration, "opponent": op.name, "score": res.score_a,
                    "elo": res.elo_a, "pentanomial": res.pentanomial.tolist(),
                }) + "\n")
        return results

    def gating(self, iteration: int, on_ply=None) -> dict:
        """Play last-vs-best and promote on winrate > 0.5
        (reference: TrainingManager::gating, TrainingManager.cpp:310-356).
        `on_ply` is `play_match`'s; the match's result stays in
        `last_gating`."""
        from ..eval.match import play_match, random_openings

        best = self.metadata["best_checkpoint"]
        if best < 0 or best == iteration:
            self.metadata["best_checkpoint"] = iteration
            self._save_metadata()
            return {"promoted": True, "score": 1.0, "elo": 0.0}
        best_apply, best_vars = network_apply(self._load_net(self.checkpoint_path(best)))
        last_vars = self._host_vars()
        cfg = self.cfg
        raw = self.net.cfg.raw_input
        if cfg.balanced_openings:
            # gating replays NN-balanced openings, like reference gating
            # (EvaluationGame uses OpeningGenerator openings)
            stones = cfg.opening_stones + (cfg.opening_stones % 2)  # even
            openings = generate_balanced_openings(
                self._apply, last_vars, self.tables, self._generator(),
                cfg.gating_games // 2, cfg.rows, cfg.cols, stones=stones, raw_input=raw,
            )
        else:
            openings = random_openings(self.rng, cfg.gating_games // 2, cfg.rows, cfg.cols)
        result = play_match(
            self._apply, last_vars, best_apply, best_vars, self.tables,
            mcts.MCTSConfig(max_nodes=cfg.num_simulations + 8, max_edges=32, max_depth=32),
            cfg.num_simulations, openings, raw_input_a=raw, raw_input_b=raw,
            device=self.device, on_ply=on_ply,
        )
        self.last_gating = result
        promoted = result.score_a > 0.5
        if promoted:
            self.metadata["best_checkpoint"] = iteration
            self._save_metadata()
        with open(os.path.join(cfg.working_dir, "gating.txt"), "a") as fh:
            fh.write(json.dumps({
                "iteration": iteration, "vs_best": best, "score": result.score_a,
                "elo": result.elo_a, "pentanomial": result.pentanomial.tolist(),
                "truncated": result.truncated, "promoted": bool(promoted),
            }) + "\n")
        return {"promoted": bool(promoted), "score": result.score_a, "elo": result.elo_a}

    def _timed(self, stage: str, fn, *args):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_timings[stage] = time.perf_counter() - t0
        return out

    def run_iteration_rl(self, iteration: int, on_move=None, on_ply=None) -> dict:
        """generateGames -> train -> optional async evaluation -> optional
        gating (reference: runIterationRL + runIterationSL,
        TrainingManager.cpp:84-137; evaluation overlaps the NEXT generation
        in a one-thread executor when eval_in_parallel, :100-126).  The
        seconds of each stage land in `last_timings`; `on_move` and
        `on_ply` go to `generate_games` and `gating`."""
        self.last_timings = {}
        sig = _SigintFlag()
        try:
            samples = self._timed("selfplay", self.generate_games, iteration, on_move)
            if sig.hit:
                return {"stopped": True, "samples": samples}
            metrics = self._timed("train", self.train_iteration, iteration)
            # evaluation and gating are match runs on local copies of the
            # nets; in distributed mode only the coordinator plays them (the
            # reference's single EvaluationManager), the other ranks adopt
            # the promotion decision afterwards
            if self.cfg.use_evaluation and not sig.hit and self.is_coordinator:
                if self.cfg.eval_in_parallel:
                    # join the previous evaluation first (reference: "Waiting
                    # for previous evaluation to finish...")
                    self.join_evaluation()
                    if not hasattr(self, "_eval_pool"):
                        self._eval_pool = concurrent.futures.ThreadPoolExecutor(1)
                    self._eval_future = self._eval_pool.submit(self.evaluate, iteration)
                else:
                    self._timed("evaluate", self.evaluate, iteration)
            if self.cfg.use_gating and not sig.hit:
                if self.is_coordinator:
                    metrics.update(self._timed("gating", self.gating, iteration, on_ply))
                if self.cfg.distributed:
                    D.barrier(f"gating_{iteration}")
                    if not self.is_coordinator:
                        # adopt the coordinator's promotion decision
                        self.metadata = self._load_metadata()
            return {"samples": samples, **metrics}
        finally:
            sig.restore()

    def join_evaluation(self) -> None:
        """Block until any in-flight async evaluation has finished."""
        fut = getattr(self, "_eval_future", None)
        if fut is not None:
            fut.result()
            self._eval_future = None

    def run(self, iterations: int) -> None:
        start = self.metadata["last_checkpoint"] + 1
        for i in range(start, start + iterations):
            t0 = time.time()
            metrics = self.run_iteration_rl(i)
            if metrics.get("stopped"):
                break
            print(f"iteration {i}: {metrics} ({time.time()-t0:.1f}s)")
        self.join_evaluation()
