"""Replay buffer: host-side sample store feeding the device learner.

A copy of the reference package's `data/replay.py` (a numpy store on the
host; the `.npz` files each writes, the other reads).  The one change:
`add_generation` also takes torch tensors, on any device, as the port's
`selfplay.make_targets` returns them.

TPU-native counterpart of the reference's dataset layer
(reference: src/dataset/{GameDataBuffer,Dataset,Sampler}.cpp): generation
buffers of flat arrays instead of per-game compressed records, a sliding
window over the last N generations (the reference's `Dataset` epoch map +
`buffer_size` schedule, TrainingManager.cpp:370-383), and the two sampler
flavors (policy target from visit counts vs from action values,
reference: src/dataset/Sampler.cpp:29-37).

Buffers persist as compressed .npz per generation
(reference: zlib-backed buffer_N.bin, GameDataBuffer.hpp:22-63).  The
reference's binary v100/v200/v201 formats are byte-replicated separately in
`data/formats.py` (oracle-verified) for interchange with the C++ engine;
this module's native storage is flat arrays for fast batched sampling.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

def _numpy(x) -> np.ndarray:
    """A host numpy array of `x` (a numpy array, or a torch tensor on any
    device)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


FIELDS = (
    "board",
    "stm",
    "policy",
    "value_wdl",
    "q_value",
    "q_mask",
    "root_value",
    "moves_left",
    "played_move",
)


class ReplayBuffer:
    """Sliding window of per-generation sample buffers."""

    def __init__(self, window_generations: int = 20):
        self.window = window_generations
        self.generations: dict[int, dict[str, np.ndarray]] = {}

    # -- ingest ------------------------------------------------------------

    def add_generation(self, gen: int, samples: dict) -> int:
        """Store the valid samples of one selfplay generation (targets dict
        from selfplay.make_targets, device or host arrays)."""
        valid = _numpy(samples["valid"])
        data = {k: _numpy(samples[k])[valid] for k in FIELDS}
        self.generations[gen] = data
        self._trim()
        return int(valid.sum())

    def set_window(self, window_generations: int) -> None:
        """Schedule hook (reference: buffer_size Parameter schedule)."""
        self.window = window_generations
        self._trim()

    def _trim(self) -> None:
        while len(self.generations) > self.window:
            del self.generations[min(self.generations)]

    # -- stats -------------------------------------------------------------

    @property
    def num_samples(self) -> int:
        return sum(len(g["stm"]) for g in self.generations.values())

    def stats(self) -> dict:
        """(reference: GameDataBuffer stats printed to buffer_stats.txt)"""
        n = self.num_samples
        wdl = (
            np.concatenate([g["value_wdl"] for g in self.generations.values()])
            if n
            else np.zeros((0, 3))
        )
        return {
            "generations": sorted(self.generations),
            "samples": n,
            "win_rate": float(wdl[:, 0].mean()) if n else 0.0,
            "draw_rate": float(wdl[:, 1].mean()) if n else 0.0,
        }

    # -- sampling ----------------------------------------------------------

    def sample(
        self, batch_size: int, rng: np.random.Generator, sampler: str = "visits"
    ) -> dict[str, np.ndarray]:
        """Uniform sample over the window.

        sampler="visits": policy target = normalized visit counts (default,
        reference SamplerVisits).  sampler="values": policy target rebuilt
        from per-cell action values, masked to visited cells (reference
        SamplerValues, Sampler.cpp:29-37)."""
        if not self.generations:
            raise ValueError("empty replay buffer")
        gens = sorted(self.generations)
        sizes = np.array([len(self.generations[g]["stm"]) for g in gens])
        probs = sizes / sizes.sum()
        pick_g = rng.choice(len(gens), size=batch_size, p=probs)
        out = {k: [] for k in FIELDS}
        for gi in range(len(gens)):
            take = (pick_g == gi).sum()
            if take == 0:
                continue
            g = self.generations[gens[gi]]
            idx = rng.integers(0, len(g["stm"]), size=take)
            for k in FIELDS:
                out[k].append(g[k][idx])
        batch = {k: np.concatenate(v) for k, v in out.items()}
        if sampler == "values":
            q = batch["q_value"]
            mask = batch["q_mask"]
            expect = (q[..., 0] + 0.5 * q[..., 1]) * mask
            denom = expect.sum((1, 2), keepdims=True)
            has = denom[..., 0, 0] > 1e-9
            policy = np.where(
                has[:, None, None], expect / np.maximum(denom, 1e-9), batch["policy"]
            )
            batch = dict(batch, policy=policy.astype(np.float32))
        batch["valid"] = np.ones(len(batch["stm"]), bool)
        return batch

    def iter_batches(
        self,
        batch_size: int,
        steps: int,
        rng: np.random.Generator,
        sampler: str = "visits",
        prefetch: int = 2,
    ) -> Iterator[dict]:
        """Double-buffered batch stream: batches are packed on a background
        thread while the learner consumes the previous one (reference:
        SupervisedLearning's prepare_training_data thread overlapping
        getNextBatch, SupervisedLearning.cpp:104-152).  prefetch=0 falls back
        to the synchronous loop."""
        if prefetch <= 0 or steps <= 1:
            for _ in range(steps):
                yield self.sample(batch_size, rng, sampler)
            return
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        err: list[BaseException] = []

        def produce():
            try:
                for _ in range(steps):
                    q.put(self.sample(batch_size, rng, sampler))
            except BaseException as exc:  # surfaced on the consumer side
                err.append(exc)
                q.put(None)

        # the buffer must not mutate while the producer reads it: sampling
        # only touches self.generations, which callers mutate between
        # iterations, not between batches of one iteration
        t = threading.Thread(target=produce, daemon=True)
        t.start()
        for _ in range(steps):
            item = q.get()
            if item is None:
                break
            yield item
        t.join()
        if err:
            raise err[0]

    # -- persistence (reference: train_buffer/buffer_N.bin, zlib) ----------

    def save_generation(self, gen: int, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        np.savez_compressed(tmp, **self.generations[gen])
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)

    def load_generation(self, gen: int, path: str) -> None:
        data = np.load(path)
        self.generations[gen] = {k: data[k] for k in FIELDS}
        self._trim()
