"""Single seeded randomness root for a simulation run.

FUSEE's fleet-scale simulation promises **bit-identical replay from
``(seed, config)``** — every random decision a run makes (scheduler
interleavings, workload generation, fault storms, per-client protocol
jitter) must derive from one root seed through *named substreams* so that
adding a new consumer of randomness never perturbs the draws of an
existing one.

``SimRng`` wraps numpy's ``SeedSequence`` machinery: ``stream(name)``
returns a ``numpy.random.Generator`` keyed by ``(seed, crc32(name))``.
Streams are independent of both creation order and of each other, so

    SimRng(7).stream("workload")

draws the same sequence whether or not ``stream("faults")`` was ever
touched.  The conventional stream names used across the repo:

    scheduler   sim.Scheduler's schedule choices (run_random picks)
    faults      randomized FaultPlan generation (faults.FaultPlan.storm)
    workload    benchmark/test op-mix + key generation
    client.<i>  per-client protocol jitter (FuseeClient)
"""
from __future__ import annotations

import zlib
from typing import Dict, Union

import numpy as np

__all__ = ["SimRng"]


class SimRng:
    """Deterministic named-substream RNG root.  See module docstring."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._streams: Dict[str, np.random.Generator] = {}

    def _origin(self, name: str) -> np.random.SeedSequence:
        # 64-bit mask (not 32): seeds must not alias below the word size a
        # reproducing seed is reported at, or "different seeds differ"
        # silently breaks for seeds above 2**32
        return np.random.SeedSequence(
            [self.seed & 0xFFFF_FFFF_FFFF_FFFF,
             zlib.crc32(name.encode("utf-8"))])

    def stream(self, name: str) -> np.random.Generator:
        """The (memoized) generator for substream ``name``.  Repeated calls
        return the *same* generator object — draws advance it."""
        gen = self._streams.get(name)
        if gen is None:
            gen = self._streams[name] = np.random.default_rng(
                self._origin(name))
        return gen

    def fresh(self, name: str) -> np.random.Generator:
        """A *new* generator for ``name``, rewound to the stream's origin
        (unlike ``stream``, draws on the returned object do not advance the
        memoized one).  Used by replay harnesses."""
        return np.random.default_rng(self._origin(name))

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"SimRng(seed={self.seed})"


def as_simrng(rng: Union["SimRng", int, None], *, default_seed: int = 0) -> "SimRng":
    """Coerce an int seed / None / SimRng into a SimRng (API convenience)."""
    if isinstance(rng, SimRng):
        return rng
    return SimRng(default_seed if rng is None else int(rng))
