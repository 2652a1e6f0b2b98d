"""The one traffic generator: a mix file's parameters and the run's seed
give every request's prompt and length, and the clients' arrivals.

A mix file (``traffic/<name>.json``) holds:

* ``loop``: ``"closed"`` (``clients`` each send their next request when
  the last one has finished) or ``"open"`` (``burst`` requests arrive
  together, ``rate_per_s`` bursts a second, at a fixed period);
* the engine's ``max_batch`` and ``max_len``;
* ``shared_prefix_tokens`` (the system prompt every request shares; 0
  for none), ``own_tokens`` and ``new_tokens``: whole numbers, the same
  for every request (the engine pads a batch's rows to the longest and
  keeps one cache length for all, so rows of other lengths would not be
  served their own prompt's logits);
* ``profile_waves``: whole waves the profiler records in a traced run;
  ``check_requests``: requests the reference compares after the window,
  drawn across the engine's slots (``sample``).

Token ids are uniform over the configuration's vocabulary.  Request
``key`` (a client and its request number, or an arrival number) draws
from its own stream of the seed, so the same seed gives the same
requests whatever the order the engine finishes them in.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

WARMUP = 1 << 20            # key space of the warm-up requests
STREAM_PREFIX, STREAM_REQUEST, STREAM_SAMPLE = 1, 2, 4


def _seed_words(seed: int) -> List[int]:
    s = int(seed) % (2 ** 64)
    return [s & 0xFFFFFFFF, s >> 32]


def rng(seed: int, stream: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(_seed_words(seed) + [stream, *key]))


class Traffic:
    """The requests and arrivals of one mix under one seed."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = seed
        if mix["loop"] not in ("closed", "open"):
            raise ValueError(f"traffic: unknown loop {mix['loop']!r}")
        self.prefix = rng(seed, STREAM_PREFIX).integers(
            0, vocab, mix["shared_prefix_tokens"], dtype=np.int32)

    @property
    def closed(self) -> bool:
        return self.mix["loop"] == "closed"

    def request(self, *key: int) -> Tuple[np.ndarray, int]:
        """(prompt, new tokens) of request ``key``."""
        own = rng(self.seed, STREAM_REQUEST, *key).integers(
            0, self.vocab, self.mix["own_tokens"], dtype=np.int32)
        return (np.concatenate([self.prefix, own]),
                int(self.mix["new_tokens"]))

    def warmup(self) -> List[np.ndarray]:
        """One wave of prompts at the mix's own shapes, for set-up."""
        return [self.request(WARMUP, i)[0]
                for i in range(self.mix["max_batch"])]

    def arrivals(self, seconds: float) -> List[float]:
        """Open loop: the arrival offsets (s) of every request due in the
        first ``seconds``, ``burst`` at each instant."""
        period = 1.0 / self.mix["rate_per_s"]
        n = int(np.ceil(seconds / period))
        return [i * period for i in range(n)
                for _ in range(self.mix["burst"])]

    def sample(self, done: Sequence, k: int) -> List:
        """``k`` of the finished requests ``done`` drawn from the seed
        across the engine's slots: the slots in an order drawn from the
        seed, a request of each in turn (each slot's own drawn at random)
        until ``k`` are taken, so that a fault in some rows of the batch
        is sampled.  Every request of a mix has one length, so the
        longest are all of them."""
        r = rng(self.seed, STREAM_SAMPLE)
        by_slot: Dict[int, list] = {}
        for req in done:
            by_slot.setdefault(int(req.slot), []).append(req)
        slots = sorted(by_slot)
        order = [slots[i] for i in r.permutation(len(slots))]
        queues = [[by_slot[s][i] for i in r.permutation(len(by_slot[s]))]
                  for s in order]
        out: List = []
        for turn in range(max((len(q) for q in queues), default=0)):
            out += [q[turn] for q in queues if turn < len(q)]
        return out[:k]
