"""Deterministic synthetic token pipeline.

Generates a reproducible Markov-ish token stream per (seed, step, shard) —
no filesystem dependency, identical across restarts, and cheap enough to
never bottleneck the step.  The stream has learnable structure (a planted
bigram table) so training loss decreases and the end-to-end example can show
real learning curves rather than noise.

The pipeline is *sharded at the source*: each data-parallel host generates
only its shard (``shard_id``/``num_shards``), the standard input-pipeline
pattern at pod scale; a multi-host run would assemble the global batch from
the shards.  A background thread
prefetches ``prefetch`` batches ahead.

The port's own copy of the JAX package's ``data/pipeline.py`` (numpy only,
so ``batch_at`` gives the same arrays bit for bit); its
``make_batch_specs`` (mesh partition specs) has no single-card use.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: int = 64     # planted bigram classes (signal to learn)
    prefetch: int = 2


class SyntheticLM:
    """Deterministic synthetic LM dataset with a planted bigram structure."""

    def __init__(self, cfg: DataConfig, shard_id: int = 0,
                 num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        rng = np.random.default_rng(cfg.seed)
        # planted structure: each token class prefers a successor class
        self.succ = rng.permutation(cfg.structure)
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (restart-safe)."""
        cfg = self.cfg
        ss = np.random.SeedSequence(  # seeded from cfg+step: restart-safe
            [cfg.seed, step, self.shard_id, self.num_shards])
        rng = np.random.default_rng(ss)
        B, S, V, C = self.local_batch, cfg.seq_len, cfg.vocab, cfg.structure
        cls = np.empty((B, S), np.int64)
        cls[:, 0] = rng.integers(0, C, B)
        noise = rng.random((B, S)) < 0.15
        rnd = rng.integers(0, C, (B, S))
        for t in range(1, S):
            nxt = self.succ[cls[:, t - 1]]
            cls[:, t] = np.where(noise[:, t], rnd[:, t], nxt)
        offs = rng.integers(0, max(1, V // C), (B, S))
        tokens = (cls * (V // C) + offs).clip(0, V - 1).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], -np.ones((B, 1), np.int32)],
                                axis=1)
        return {"tokens": tokens, "labels": labels}

    # ------------------------------------------------------ prefetch loop --
    def start(self, first_step: int = 0):
        def worker():
            step = first_step
            while not self._stop.is_set():
                b = self.batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def __iter__(self) -> Iterator:
        while True:
            yield self._q.get()
