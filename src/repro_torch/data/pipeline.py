"""Deterministic synthetic LM data pipeline with restart/skip-ahead support.

The port's own copy of ``repro.data.pipeline``: batches are numpy int32
arrays drawn from ``np.random.default_rng`` seeded per (seed, step, shard),
so the two packages give the same bits for the same configuration, and
the trainer moves each batch to its device.

Production properties kept: per-(shard, step) deterministic batches (restart
reproduces the exact stream), host-sharded iteration for DP, background
prefetch, and state small enough to live in the checkpoint metadata.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 1       # data-parallel host shards
    shard_id: int = 0
    seed: int = 0


class TokenPipeline:
    """Synthetic corpus: Zipf-distributed tokens with short-range structure
    (next-token correlation) so cross-entropy actually decreases."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        assert cfg.global_batch % cfg.num_shards == 0
        self.cfg = cfg
        self.step = start_step

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: dict) -> "TokenPipeline":
        return cls(
            dataclasses.replace(cfg, seed=state["seed"]),
            start_step=state["step"],
        )

    def _batch_for(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        local = cfg.global_batch // cfg.num_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.shard_id
        )
        # Zipf marginal + markov-ish structure: token_t depends on t-1.
        base = rng.zipf(1.3, size=(local, cfg.seq_len + 1)).astype(np.int64)
        base = np.minimum(base - 1, cfg.vocab_size - 1)
        mixed = np.where(
            rng.uniform(size=base.shape) < 0.5,
            base,
            np.roll(base, 1, axis=1) * 7 % cfg.vocab_size,
        ).astype(np.int32)
        return {"tokens": mixed[:, :-1], "labels": mixed[:, 1:]}

    def next_batch(self) -> dict[str, np.ndarray]:
        batch = self._batch_for(self.step)
        self.step += 1
        return batch

    def skip_to(self, step: int):
        """Restart support: jump the stream to an arbitrary step."""
        self.step = step

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


class PrefetchingLoader:
    """Background-thread prefetch (depth-bounded) around any pipeline."""

    def __init__(self, pipeline: TokenPipeline, depth: int = 2):
        self.pipeline = pipeline
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            batch = self.pipeline.next_batch()
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next_batch(self) -> dict[str, np.ndarray]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
