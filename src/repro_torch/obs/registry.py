"""Typed metrics registry: counters, gauges, log-bucket histograms,
time-series rings, and heat sketches under stable dotted names.

FUSEE has no metadata server where load and latency naturally accumulate —
every client owns its own slice of the protocol — so the registry is the
single place a cluster's telemetry converges.  Design rules, in the spirit
of the rest of the repo:

* **Deterministic.**  Every metric derives from simulation state (ticks,
  RTTs, verb counts, bytes) — never wall-clock, never a device tensor —
  so same-seed runs produce bit-identical snapshots on every device, and
  a fused fleet tick agrees with the per-kind path on every metric.  The
  handful of metrics that
  legitimately depend on the execution *path* (``fleet.array_calls``,
  ``fleet.fused_ticks``, ...) are named in ``PATH_DEPENDENT`` and dropped
  by ``deterministic_view`` before any cross-path comparison.
* **Vectorized.**  Bulk-update entry points (``Histogram.observe_many``,
  ``Series.append_rows``, ``HeatSketch.update``) take whole numpy arrays
  so fleet paths record a tick's wave in one call — no per-client Python
  loops.
* **Cheap.**  A ``Counter`` is one attribute increment; everything heavier
  is either buffered (see obs/flight.py) or windowed.

Naming contract: dotted, ``<component>.<metric>[.<dim>.<value>]`` —
``fleet.verbs``, ``api.batch_fast_hits``, ``migrate.cutovers``,
``op.lat_ticks.kind.insert``, ``op.lat_rtts.mn.3``, ``mn.load``.
Units ride the name: ``*_ticks`` are scheduler ticks, ``*_rtts`` are
verb round-trips, ``bytes`` are modeled DM bytes.

The old ad-hoc ``counters`` dicts (api/fleet/migrate) survive one release
as read-only deprecation aliases: ``LegacyCounters`` is a ``Mapping`` view
over registry handles under the historical key names.

Counterpart of the JAX package's ``obs/registry.py``: plain numpy on the
host, so ``json.dumps(deterministic_view(snapshot))`` of a port cluster is
byte-identical to the JAX package's on the same seed, configuration and
submissions.
"""
from __future__ import annotations

import warnings
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Series", "HeatSketch",
           "Registry", "LegacyCounters", "PATH_DEPENDENT",
           "deterministic_view", "snapshot_diff", "snapshot_merge"]

# Metrics whose value depends on HOW a run executed (fused vs oracle
# sweeps, shadow-index rebuild cadence, numpy dispatch counts) rather than
# WHAT the protocol did.  Fused-vs-oracle differential gates and
# cross-substrate comparisons must drop these; everything else in a
# snapshot is required to be bit-identical for the same seeded run.
PATH_DEPENDENT = frozenset({
    "fleet.array_calls", "fleet.fused_ticks", "fleet.fallback_ticks",
    "fleet.shadow_rebuilds", "api.shadow_rebuilds",
})

DEFAULT_HIST_BUCKETS = 28   # log2 buckets: {0}, {1}, [2,3], ... [2^26, 2^27)


class Counter:
    """Monotonic counter.  ``inc`` is the sanctioned mutation path; hot
    loops may cache the handle and bump ``.value`` directly — the handle
    *is* the registry entry."""
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


class Histogram:
    """Fixed log2-bucket histogram of non-negative integers.

    Bucket 0 holds exactly {0}; bucket i >= 1 holds [2^(i-1), 2^i).  The
    last bucket absorbs overflow.  Buckets are a fixed-size int64 vector,
    so snapshot/diff/merge are elementwise and ``observe_many`` is one
    bincount — no per-sample Python."""
    __slots__ = ("name", "unit", "counts")

    def __init__(self, name: str, unit: str = "",
                 n_buckets: int = DEFAULT_HIST_BUCKETS):
        self.name = name
        self.unit = unit
        self.counts = np.zeros(n_buckets, np.int64)

    @staticmethod
    def bucket_of(vals: np.ndarray, n_buckets: int) -> np.ndarray:
        v = np.maximum(np.asarray(vals, np.int64), 0)
        with np.errstate(divide="ignore"):
            b = np.where(v > 0,
                         np.floor(np.log2(np.maximum(v, 1))).astype(np.int64)
                         + 1, 0)
        return np.minimum(b, n_buckets - 1)

    def observe(self, v: int):
        self.counts[int(self.bucket_of(np.asarray([v]), len(self.counts))[0])] += 1

    def observe_many(self, vals: np.ndarray):
        if len(vals) == 0:
            return
        b = self.bucket_of(vals, len(self.counts))
        self.counts += np.bincount(b, minlength=len(self.counts))

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def upper_edges(self) -> np.ndarray:
        """Inclusive upper edge per bucket: 0, 1, 3, 7, ... (2^i - 1)."""
        n = len(self.counts)
        e = (np.int64(1) << np.arange(n, dtype=np.int64)) - 1
        e[0] = 0
        return e

    def percentile(self, q: float) -> int:
        """Upper edge of the bucket containing the q-quantile rank (q in
        [0, 1]).  Conservative (rounds latency up to the bucket edge)."""
        total = self.total
        if total == 0:
            return 0
        rank = q * total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank, side="left"))
        return int(self.upper_edges()[min(i, len(self.counts) - 1)])


class Series:
    """Fixed-capacity ring of float64 rows with named columns — the
    per-MN load time-series substrate.  Rows append in bulk (one 2-D
    scatter per wave); ``rows()`` returns them oldest-first, wrap-aware."""
    __slots__ = ("name", "fields", "capacity", "buf", "n")

    def __init__(self, name: str, fields: Tuple[str, ...],
                 capacity: int = 4096):
        self.name = name
        self.fields = tuple(fields)
        self.capacity = capacity
        self.buf = np.zeros((capacity, len(self.fields)), np.float64)
        self.n = 0

    def append_rows(self, rows: np.ndarray):
        rows = np.asarray(rows, np.float64)
        if rows.ndim == 1:
            rows = rows[None, :]
        k = len(rows)
        if k == 0:
            return
        clipped = 0
        if k > self.capacity:                  # keep only the newest tail
            clipped = k - self.capacity
            rows = rows[-self.capacity:]
            k = self.capacity
        # advance past the clipped rows too, so ``dropped`` and the ring
        # phase match the would-have-written-everything ordering
        idx = (self.n + clipped + np.arange(k)) % self.capacity
        self.buf[idx] = rows
        self.n += clipped + k

    def rows(self) -> np.ndarray:
        if self.n <= self.capacity:
            return self.buf[:self.n].copy()
        c = self.n % self.capacity
        return np.concatenate([self.buf[c:], self.buf[:c]])

    @property
    def dropped(self) -> int:
        return max(0, self.n - self.capacity)


class HeatSketch:
    """Per-bucket access-heat counters — the FlexKV/rebalance input
    signal.  ``width`` counters indexed by a caller-supplied bucket hash
    (core/shadow.hash32_np over fold32 keys, i.e. the RACE first-choice
    bucket family), updated with one ``np.add.at`` per wave."""
    __slots__ = ("name", "width", "counts")

    def __init__(self, name: str, width: int = 1024):
        assert width & (width - 1) == 0, "heat width must be a power of 2"
        self.name = name
        self.width = width
        self.counts = np.zeros(width, np.int64)

    def update(self, bucket_idx: np.ndarray):
        if len(bucket_idx) == 0:
            return
        np.add.at(self.counts, np.asarray(bucket_idx, np.int64)
                  & (self.width - 1), 1)

    def touch(self, bucket: int):
        self.counts[bucket & (self.width - 1)] += 1

    def top(self, k: int = 8) -> List[Tuple[int, int]]:
        """Hottest buckets as (bucket, count), deterministic order."""
        idx = np.argsort(self.counts, kind="stable")[::-1][:k]
        return [(int(i), int(self.counts[i])) for i in idx
                if self.counts[i] > 0]


_TYPES = (Counter, Gauge, Histogram, Series, HeatSketch)


class Registry:
    """Flat name -> metric map with get-or-create typed accessors.

    One registry per cluster (hosted on the ``Scheduler``) carries the
    core protocol metrics; per-client ``SimBackend``s carry their own
    small registries (``api.*``) because backends are transient — merge
    snapshots with ``snapshot_merge`` when aggregating."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, unit: str = "",
                  n_buckets: int = DEFAULT_HIST_BUCKETS) -> Histogram:
        return self._get(name, Histogram, unit, n_buckets)

    def series(self, name: str, fields: Tuple[str, ...],
               capacity: int = 4096) -> Series:
        return self._get(name, Series, fields, capacity)

    def heat(self, name: str, width: int = 1024) -> HeatSketch:
        return self._get(name, HeatSketch, width)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict:
        """Pure-data snapshot (JSON-serializable; sorted names so equal
        registries produce byte-identical ``json.dumps``)."""
        out = {"counters": {}, "gauges": {}, "histograms": {},
               "series": {}, "heat": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = int(m.value)
            elif isinstance(m, Gauge):
                v = m.value
                out["gauges"][name] = float(v) if isinstance(v, float) \
                    else int(v)
            elif isinstance(m, Histogram):
                out["histograms"][name] = {
                    "unit": m.unit, "counts": m.counts.tolist()}
            elif isinstance(m, Series):
                out["series"][name] = {
                    "fields": list(m.fields), "dropped": m.dropped,
                    "rows": [[float(x) for x in r] for r in m.rows()]}
            elif isinstance(m, HeatSketch):
                out["heat"][name] = m.counts.tolist()
        return out


def deterministic_view(snap: Dict,
                       exclude: Iterable[str] = PATH_DEPENDENT) -> Dict:
    """Snapshot minus the path-dependent metrics — the form compared by
    the fused-vs-oracle differential gate and same-seed determinism
    tests."""
    ex = frozenset(exclude)
    return {sec: ({k: v for k, v in vals.items() if k not in ex}
                  if isinstance(vals, dict) else vals)
            for sec, vals in snap.items()}


def _zipped(a: Dict, b: Dict):
    for sec in ("counters", "gauges", "histograms", "series", "heat"):
        yield sec, a.get(sec, {}), b.get(sec, {})


def snapshot_diff(new: Dict, old: Dict) -> Dict:
    """``new - old`` for the additive sections (counters, histogram
    buckets, heat); gauges and series pass through from ``new``."""
    out: Dict = {}
    for sec, na, ob in _zipped(new, old):
        if sec == "counters":
            out[sec] = {k: v - ob.get(k, 0) for k, v in na.items()}
        elif sec == "histograms":
            out[sec] = {}
            for k, h in na.items():
                oc = ob.get(k, {}).get("counts")
                c = (np.asarray(h["counts"], np.int64)
                     - np.asarray(oc, np.int64)).tolist() \
                    if oc is not None else list(h["counts"])
                out[sec][k] = {"unit": h["unit"], "counts": c}
        elif sec == "heat":
            out[sec] = {k: (np.asarray(v, np.int64)
                            - np.asarray(ob[k], np.int64)).tolist()
                        if k in ob else list(v) for k, v in na.items()}
        else:
            out[sec] = {k: v for k, v in na.items()}
    return out


def snapshot_merge(a: Dict, b: Dict) -> Dict:
    """Aggregate two snapshots: counters/histograms/heat sum, gauges take
    the max, series concatenate rows (sorted by their first field, which
    is the sample tick by convention)."""
    out: Dict = {}
    for sec, sa, sb in _zipped(a, b):
        if sec == "counters":
            out[sec] = {k: sa.get(k, 0) + sb.get(k, 0)
                        for k in sorted(set(sa) | set(sb))}
        elif sec == "gauges":
            out[sec] = {k: max(sa.get(k, 0), sb.get(k, 0))
                        for k in sorted(set(sa) | set(sb))}
        elif sec == "histograms":
            out[sec] = {}
            for k in sorted(set(sa) | set(sb)):
                ha, hb = sa.get(k), sb.get(k)
                if ha is None or hb is None:
                    src = ha or hb
                    out[sec][k] = {"unit": src["unit"],
                                   "counts": list(src["counts"])}
                else:
                    out[sec][k] = {"unit": ha["unit"], "counts": (
                        np.asarray(ha["counts"], np.int64)
                        + np.asarray(hb["counts"], np.int64)).tolist()}
        elif sec == "heat":
            out[sec] = {}
            for k in sorted(set(sa) | set(sb)):
                va, vb = sa.get(k), sb.get(k)
                if va is None or vb is None:
                    out[sec][k] = list(va if va is not None else vb)
                else:
                    out[sec][k] = (np.asarray(va, np.int64)
                                   + np.asarray(vb, np.int64)).tolist()
        else:   # series
            out[sec] = {}
            for k in sorted(set(sa) | set(sb)):
                ra = sa.get(k, {}).get("rows", [])
                rb = sb.get(k, {}).get("rows", [])
                src = sa.get(k) or sb.get(k)
                out[sec][k] = {
                    "fields": list(src["fields"]),
                    "dropped": (sa.get(k, {}).get("dropped", 0)
                                + sb.get(k, {}).get("dropped", 0)),
                    "rows": sorted(ra + rb, key=lambda r: r[0])}
    return out


class LegacyCounters(Mapping):
    """Read-only dict-view over registry handles under the historical
    ``counters`` key names.  Deprecated — one release only; read the
    registry (``cluster.metrics()`` / ``kv.stats()``) instead.  Writes
    (``counters[k] += 1``) are not supported."""

    __slots__ = ("_handles",)

    def __init__(self, handles: Dict[str, object]):
        # old key -> Counter/Gauge handle (read .value at access time)
        self._handles = handles

    def __getitem__(self, key: str):
        return self._handles[key].value

    def __iter__(self):
        return iter(self._handles)

    def __len__(self):
        return len(self._handles)

    def __repr__(self):
        return f"LegacyCounters({dict(self)!r})"


def legacy_counters_view(owner: str, handles: Dict[str, object]
                         ) -> LegacyCounters:
    """Build the deprecation alias for one component's old dict, warning
    on access (Python's default filter dedupes per call site)."""
    warnings.warn(
        f"{owner}.counters is deprecated; read the metrics registry "
        f"(cluster.metrics() / stats()) instead — the dict view will be "
        f"removed next release", DeprecationWarning, stacklevel=3)
    return LegacyCounters(handles)
