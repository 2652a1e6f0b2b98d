"""Metrics registry: counters and gauges under stable dotted names.

FUSEE has no metadata server where load and latency naturally accumulate —
every client owns its own slice of the protocol — so the registry is the
single place a cluster's telemetry converges.  Every metric derives from
simulation state (ticks, verb counts), never wall-clock, so same-seed runs
produce identical values.

Naming contract: dotted, ``<component>.<metric>`` — ``fleet.verbs``,
``api.batch_fast_hits``, ``migrate.cutovers``.

Counterpart of the counter/gauge part of the JAX package's
``obs/registry.py``; its histograms, series, heat sketches and snapshot
algebra belong to the obs hub, which is not ported yet (ROADMAP A11).
"""
from __future__ import annotations

from typing import Dict

__all__ = ["Counter", "Gauge", "Registry"]


class Counter:
    """Monotonic counter.  Hot loops may cache the handle and bump
    ``.value`` directly — the handle *is* the registry entry."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n


class Gauge:
    """Last-value (or running-max) gauge."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v):
        self.value = v

    def set_max(self, v):
        if v > self.value:
            self.value = v


class Registry:
    """Flat name -> metric map with get-or-create typed accessors.

    One registry per cluster (hosted on the ``Scheduler``) carries the
    core protocol metrics; per-client ``SimBackend``s carry their own
    small registries (``api.*``) because backends are transient."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def get(self, name: str):
        return self._metrics.get(name)
