"""Op-level flight recorder + the cluster observability hub.

``FlightRecorder`` is a fixed ring of op **begin / settle / fault /
recovery / migration** events — orders of magnitude lighter than a
recording ``VerbTracer`` (a handful of events per *op* instead of a row
per *verb*), so it stays on for the life of a cluster.  Events buffer as
plain tuples on the hot path and land in the int64 ring in one vectorized
scatter per flush; ``save``/``load`` round-trip the ring through ``.npz``
exactly like the tracer's format.

``ClusterObs`` owns the recorder plus the derived telemetry that feeds
the metrics registry (obs/registry.py):

* op-latency histograms (submit->settle, in ticks and RTTs) per kind /
  per index shard / per primary MN, bulk-updated at flush;
* the per-MN load time-series (``mn.load``: bytes moved, verbs, queue
  depth, MN-CPU ops, cap-model utilization per tick window);
* the per-bucket heat sketch (``cache.heat``) fed by the client cache /
  probe-wave paths — the FlexKV/rebalance input signal.

Cost contract: a detached hub (``scheduler.obs is None``) costs the fused
fleet tick exactly one attribute load + ``is None`` test per hook site; an
attached hub's per-op work is one tuple append, everything array-shaped
happens on the flush cadence, and it samples host state only (the pool's
numpy byte counters, the MNs' CPU-op counts, the scheduler's queues) —
never a device tensor, so it adds no host-device sync to a tick.
``chip_smoke.py`` prints the hub's and the tracer's cost per tick on the
card (its ``[obs] overhead`` line).

Auto-dump: when a fault fires, a heap audit fails, or a race finding
surfaces, the hub dumps the ring to ``dump_dir`` **once per reason
class** (``flight_<reason>_t<tick>.npz``).  Dumping is armed only when
``dump_dir`` is set (CI storms, drills, triage) so unit-test clusters
never litter the tree.

Counterpart of the JAX package's ``obs/flight.py`` (plain numpy); the heat
sketch hashes with ``core/shadow.py::hash32_np``, the numpy twin of the
RACE index's torch hash.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .registry import Registry

__all__ = ["FlightRecorder", "ClusterObs",
           "EV_BEGIN", "EV_SETTLE", "EV_FAULT", "EV_RECOVERY", "EV_MIG",
           "EV_REGIME", "EV_NAMES", "FIELDS"]

EV_BEGIN, EV_SETTLE, EV_FAULT, EV_RECOVERY, EV_MIG, EV_REGIME = range(6)
EV_NAMES = ("begin", "settle", "fault", "recovery", "migration", "regime")

# ring columns (int64):
#   tick    scheduler tick of the event
#   etype   EV_* above
#   cid     client id (-1 for cluster-level events)
#   op_id   op id (-1 for non-op events)
#   kind    interned label: op kind / fault action / recovery / mig phase
#   key     op key (-1 when not an int key / not an op)
#   arg     event argument (fault target, migrated region, ...; -1 unused)
#   lat     settle: submit->settle ticks; recovery: RTT cost
#   rtts    settle: op RTTs (foreground)
#   status  interned result status (-1 when unsettled / not an op)
FIELDS = ("tick", "etype", "cid", "op_id", "kind", "key", "arg",
          "lat", "rtts", "status")
_NF = len(FIELDS)


class FlightRecorder:
    """Fixed ring of event rows; wrap drops the oldest (counted)."""

    def __init__(self, capacity: int = 1 << 15):
        self.capacity = capacity
        self.ring = np.zeros((capacity, _NF), np.int64)
        self.n = 0

    @property
    def dropped(self) -> int:
        return max(0, self.n - self.capacity)

    def push_rows(self, rows: np.ndarray):
        k = len(rows)
        if k == 0:
            return
        clipped = 0
        if k > self.capacity:
            clipped = k - self.capacity
            rows = rows[-self.capacity:]
            k = self.capacity
        # advance past the clipped rows too, so ``dropped`` and the ring
        # phase match the would-have-written-everything ordering
        idx = (self.n + clipped + np.arange(k)) % self.capacity
        self.ring[idx] = rows
        self.n += clipped + k

    def events(self) -> Dict[str, np.ndarray]:
        """Columns oldest-first (wrap-aware) plus a global ``seq``."""
        if self.n <= self.capacity:
            rows = self.ring[:self.n]
        else:
            c = self.n % self.capacity
            rows = np.concatenate([self.ring[c:], self.ring[:c]])
        out = {f: rows[:, i].copy() for i, f in enumerate(FIELDS)}
        out["seq"] = np.arange(self.n - len(rows), self.n, dtype=np.int64)
        return out

    def save(self, path: str, labels: List[str]):
        ev = self.events()
        np.savez_compressed(
            path, **ev,
            _labels=np.asarray(labels, object),
            _fields=np.asarray(FIELDS, object),
            _dropped=np.asarray([self.dropped], np.int64))

    @staticmethod
    def load(path: str) -> Dict:
        """Load a dump: event columns + ``labels`` + ``dropped``."""
        with np.load(path, allow_pickle=True) as z:
            out = {k: z[k] for k in z.files if not k.startswith("_")}
            out["labels"] = [str(x) for x in z["_labels"]]
            out["dropped"] = int(z["_dropped"][0])
        return out


class ClusterObs:
    """The per-cluster observability hub (see module docstring).

    Wired by ``FuseeCluster``: ``scheduler.obs`` and ``pool._obs`` point
    here; ``cluster.detach_obs()`` sets both back to None, restoring the
    structurally-zero-cost hot path."""

    def __init__(self, sched, pool, *, kinds: Tuple[str, ...] = (),
                 window: int = 32, heat_width: int = 1024,
                 flight_capacity: int = 1 << 15, flush_every: int = 512,
                 link_bytes_per_tick: float = 14000.0,
                 dump_dir: Optional[str] = None):
        self.sched = sched
        self.pool = pool
        self.registry: Registry = sched.metrics
        self.flight = FlightRecorder(flight_capacity)
        self.window = window
        self.flush_every = flush_every
        self.link_bytes_per_tick = float(link_bytes_per_tick)
        self.dump_dir = dump_dir
        self.dumped: Dict[str, str] = {}      # reason class -> dump path
        # label interning (kinds first so ids are stable across runs)
        self._labels: List[str] = []
        self._label_ids: Dict[str, int] = {}
        for k in kinds:
            self._intern(k)
        # hot-path buffers: plain tuples, flushed vectorized
        self._pend: List[Tuple] = []
        self._heat_pend: List[int] = []   # fold32 keys from scalar paths
        # per-MN sampling state (first window measures from tick 0)
        self._last_sample = 0
        self._prev_bytes = np.zeros(0, np.float64)
        self._prev_cpu = np.zeros(0, np.float64)
        self._mn_series = self.registry.series(
            "mn.load", ("tick", "mid", "bytes", "verbs", "qdepth",
                        "cpu_ops", "util"))
        self.heat = self.registry.heat("cache.heat", heat_width)
        self._c_settled = self.registry.counter("op.settled")
        self._c_crashed = self.registry.counter("op.crashed")
        self._c_begun = self.registry.counter("op.begun")
        self._shard_cache: Dict[int, int] = {}
        self._hists: Dict[str, object] = {}
        # streaming hot-key/skew monitor (obs/hotspot.py): opt-in via
        # enable_hotspot() — the attached-hub overhead claim measures the
        # hub alone; the "profiled" bench mode measures hub + monitor
        self.hotspot = None
        self._hot_handles = None

    # ------------------------------------------------------- hot path ----
    def _intern(self, label: str) -> int:
        i = self._label_ids.get(label)
        if i is None:
            i = self._label_ids[label] = len(self._labels)
            self._labels.append(label)
        return i

    def op_begin(self, rec, tick: int):
        key = rec.key if type(rec.key) is int else -1
        if key >= 1 << 63:           # uint64 key -> int64 two's complement
            key -= 1 << 64
        self._pend.append((tick, EV_BEGIN, rec.cid, rec.op_id,
                           self._intern(rec.kind), key, -1, 0, 0, -1))
        if len(self._pend) >= self.flush_every:
            self.flush()

    def op_settled(self, rec, tick: int):
        key = rec.key if type(rec.key) is int else -1
        if key >= 1 << 63:           # uint64 key -> int64 two's complement
            key -= 1 << 64
        res = rec.result
        status = self._intern(res.status) if res is not None else -1
        self._pend.append((tick, EV_SETTLE, rec.cid, rec.op_id,
                           self._intern(rec.kind), key, -1,
                           tick - rec.inv_tick, rec.rtts, status))
        if len(self._pend) >= self.flush_every:
            self.flush()

    def fault(self, action: str, target: int, tick: int):
        self._pend.append((tick, EV_FAULT, -1, -1, self._intern(action),
                           -1, target, 0, 0, -1))
        if len(self._pend) >= self.flush_every:
            self.flush()

    def recovery(self, what: str, tick: int, *, cid: int = -1,
                 arg: int = -1, rtts: int = 0):
        self._pend.append((tick, EV_RECOVERY, cid, -1, self._intern(what),
                           -1, arg, int(rtts), 0, -1))
        if len(self._pend) >= self.flush_every:
            self.flush()

    def migration(self, phase: str, region: int, tick: int):
        self._pend.append((tick, EV_MIG, -1, -1, self._intern(phase),
                           -1, region, 0, 0, -1))
        if len(self._pend) >= self.flush_every:
            self.flush()

    def heat_keys(self, buckets: np.ndarray, keys32=None):
        """Vectorized heat update — ``buckets`` are RACE first-choice
        bucket hashes (shadow.hash32_np(keys32, 1)); one add.at per wave.
        ``keys32`` (the UNhashed fold32 keys the buckets were derived
        from) additionally feeds the hot-key monitor when one is
        enabled — same wave, one extra batched sketch update."""
        self.heat.update(buckets)
        if self.hotspot is not None and keys32 is not None:
            self.hotspot.observe_keys(keys32)

    def heat_touch(self, bucket: int):
        self.heat.touch(bucket)

    def heat_key64(self, key64: int):
        """Scalar cache-path heat touch (client.py): buffered as a fold32
        key and hashed into buckets vectorized at flush — one hash call
        per flush, not one per op."""
        self._heat_pend.append((key64 ^ (key64 >> 32)) & 0xFFFFFFFF)

    # ---------------------------------------------------- flush / hists --
    def _hist(self, name: str, unit: str):
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = self.registry.histogram(name, unit)
        return h

    def _shard_of(self, key: int) -> int:
        s = self._shard_cache.get(key)
        if s is None:
            s = self._shard_cache[key] = self.pool.shard_of(key)
        return s

    def flush(self):
        """Drain the tuple buffers: one scatter into the flight ring, one
        bulk histogram pass over the settles, one bucket-hash pass over
        the scalar heat touches."""
        hp = self._heat_pend
        if hp:
            self._heat_pend = []
            # local import: the obs package carries no module-level core
            # dependency; the bucket family must match the RACE index's
            from ..core.shadow import hash32_np
            hpa = np.asarray(hp, np.uint32)
            self.heat.update(hash32_np(hpa, 1))
            if self.hotspot is not None:
                self.hotspot.observe_keys(hpa)
        pend = self._pend
        if pend:
            self._pend = []
            rows = np.asarray(pend, np.int64)
            self.flight.push_rows(rows)
            et = rows[:, 1]
            self._c_begun.value += int((et == EV_BEGIN).sum())
            s = rows[et == EV_SETTLE]
            if len(s):
                self._observe_settles(s)
        if self.hotspot is not None and (hp or pend):
            self._hotspot_tick()

    def _observe_settles(self, s: np.ndarray):   # lint: allow-obs-loop (dim walk is bounded by live kinds/shards/MNs per flush, not ops)
        kinds, keys = s[:, 4], s[:, 5]
        lat, rtts = s[:, 7], s[:, 8]
        self._c_settled.value += len(s)
        crashed_id = self._label_ids.get("CRASHED")
        if crashed_id is not None:
            self._c_crashed.value += int((s[:, 9] == crashed_id).sum())
        pool = self.pool
        # shard / primary-MN attribution at flush time (placement changes
        # are protocol events, identically ordered in fused and oracle
        # runs, so attribution is deterministic per seed)
        if pool.num_shards == 1:
            shards = np.zeros(len(s), np.int64)
        else:
            # undo the int64 two's-complement reinterpretation of the key
            shards = np.fromiter(
                (self._shard_of(int(k) & 0xFFFFFFFFFFFFFFFF) for k in keys),
                np.int64, count=len(s))
        prim = np.asarray([pool.primary_mn(g) for g in pool.index_regions],
                          np.int64)
        mns = prim[shards]
        for dim, ids in (("kind", kinds), ("shard", shards), ("mn", mns)):
            for u in np.unique(ids):
                sel = ids == u
                name = self._labels[int(u)] if dim == "kind" else int(u)
                self._hist(f"op.lat_ticks.{dim}.{name}",
                           "ticks").observe_many(lat[sel])
                self._hist(f"op.lat_rtts.{dim}.{name}",
                           "rtts").observe_many(rtts[sel])
        if self.hotspot is not None:
            self.hotspot.observe_load(shards, mns)

    # ------------------------------------------------- per-MN sampling ---
    def on_fleet_tick(self, fleet, by_kind: Dict[str, list]):
        """Called once per fleet tick; samples the per-MN series every
        ``window`` ticks.  The by_kind walk (verb -> primary MN) runs only
        on sample ticks — amortized, not per-tick."""
        tick = self.sched.tick
        if tick - self._last_sample < self.window:
            return
        w = max(tick - self._last_sample, 1)
        self._last_sample = tick
        pool = self.pool
        n = len(pool.mns)
        table = pool.placement
        verbs = np.zeros(n, np.float64)
        for items in by_kind.values():
            for it in items:
                verb = it[-1]
                reps = table.get(getattr(verb, "region", -1))
                if reps is not None and verb.replica < len(reps):
                    verbs[reps[verb.replica]] += 1
        qd = np.zeros(n, np.float64)
        for pipe in self.sched.pipes.values():
            for mn, q in pipe.qp.items():
                if mn < n:
                    qd[mn] += len(q)
        byt = pool.mn_bytes.astype(np.float64)
        cpu = np.fromiter((mn.cpu_ops for mn in pool.mns), np.float64,
                          count=n)
        pb = np.zeros(n, np.float64)
        pb[:len(self._prev_bytes)] = self._prev_bytes[:n]
        pc = np.zeros(n, np.float64)
        pc[:len(self._prev_cpu)] = self._prev_cpu[:n]
        bytes_w = byt - pb
        util = bytes_w / (w * self.link_bytes_per_tick)
        self._prev_bytes, self._prev_cpu = byt, cpu
        rows = np.column_stack([
            np.full(n, float(tick)), np.arange(n, dtype=np.float64),
            bytes_w, verbs, qd, cpu - pc, util])
        self._mn_series.append_rows(rows)

    # ------------------------------------------------ hot-key monitor ----
    def enable_hotspot(self, **kw):
        """Attach the streaming hot-key/skew monitor (obs/hotspot.py).
        Idempotent; keyword args pass through to ``HotKeyMonitor``.
        Surfaces ``hot.*`` gauges in the registry (fixed-point milli ints
        — deterministic, same-seed snapshots stay byte-identical) and
        emits typed ``regime`` rows into the flight ring on threshold
        crossings."""
        if self.hotspot is not None:
            return self.hotspot
        from .hotspot import HotKeyMonitor   # local: opt-in estimator
        self.hotspot = HotKeyMonitor(**kw)
        reg = self.registry
        self._hot_handles = {
            "theta": reg.gauge("hot.theta_milli"),
            "imb": reg.gauge("hot.imbalance_milli"),
            "regime": reg.gauge("hot.regime"),
            "flips": reg.counter("hot.regime_flips"),
        }
        return self.hotspot

    def _hotspot_tick(self):
        """Refresh the monitor's derived gauges; record regime crossings
        as EV_REGIME flight rows (ring-direct — flush() already drained
        the tuple buffer when this runs)."""
        hs = self.hotspot
        ev = hs.evaluate()
        h = self._hot_handles
        h["theta"].set(int(round(hs.theta * 1000)))
        h["imb"].set(int(round(max(hs.shard_imbalance,
                                   hs.mn_imbalance) * 1000)))
        h["regime"].set(0 if hs.regime == "uniform" else 1)
        if ev is not None:
            h["flips"].value += 1
            self.flight.push_rows(np.asarray(
                [(self.sched.tick, EV_REGIME, -1, -1,
                  self._intern(ev["regime"]), -1, ev["theta_milli"],
                  ev["imbalance_milli"], 0, -1)], np.int64))

    # ----------------------------------------------------------- dumps ---
    def dump(self, reason: str, *, force: bool = False) -> Optional[str]:
        """Dump the flight ring once per ``reason`` class (armed only when
        ``dump_dir`` is set).  Returns the path, or None when disarmed or
        already dumped for this reason."""
        if self.dump_dir is None:
            return None
        if not force and reason in self.dumped:
            return None
        self.flush()
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(
            self.dump_dir, f"flight_{reason}_t{self.sched.tick}.npz")
        self.flight.save(path, self._labels)
        self.dumped[reason] = path
        return path

    def labels(self) -> List[str]:
        return list(self._labels)

    def flight_events(self) -> Dict[str, np.ndarray]:
        """The flight ring's retained events, **flushing first** — the
        safe accessor for profilers/exporters (reading ``.flight.events()``
        directly can miss the buffered tail between flush cadences)."""
        self.flush()
        return self.flight.events()

    def snapshot(self) -> Dict:
        self.flush()
        return self.registry.snapshot()
