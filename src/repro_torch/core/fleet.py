"""Fleet mode: vectorized thousand-client ticks for the FUSEE simulator.

The step scheduler (sim.py) executes **one verb per tick** — perfect for
schedule-exploring correctness tests, hopeless for the paper's headline
claim that client-centric metadata management *scales with the number of
clients* (Fig. 13 tops out at 4.5x over Clover at 128 clients, and the
ROADMAP north star wants orders of magnitude more).  ``FleetEngine``
reworks the hot path: one tick advances **every** client's in-flight
op-phases at once,

* popping the head verb of every ``(client, MN)`` QP lane (the RDMA
  queue-pair FIFO — verbs of one lane never reorder, verbs of different
  lanes are concurrent, exactly the §4.5 used-bit ordering argument);
* executing the tick's verbs as *batched array operations* — one fused
  READ/WRITE/CAS/FAA dispatch on the pool (heap.DMPool.exec_fused_tick),
  or, while a migration's dual-write window is open, the per-kind
  ``*_batch`` verbs that mirror — instead of one Python pool call per
  verb;
* serving **every client's cache-resident GET probe with one batched
  ``race_lookup`` invocation** (``probe_wave``): all clients' keys are
  salted per-cid, folded into one shared shadow index built on the pool's
  device, and probed in a single kernel launch — one invocation per tick,
  not one per client.

Determinism: a fleet tick makes no random choices — gathering walks
clients and lanes in sorted order, batched verbs serialize same-word
conflicts in that same order — so a fleet run is bit-identically
replayable from ``(seed, config)`` alone (the seed feeds workload
generation and fault plans through core/rng.SimRng; the engine itself is
schedule-free).  ``sim.Scheduler.trace()`` therefore records nothing for
fleet ticks; it captures only step-mode decisions.

Counterpart of the JAX package's ``core/fleet.py``.  Per fused tick the
pool receives one host-to-device copy of the tick's coordinates and values
and returns every result in one copy (``heap.DMPool.exec_fused_tick``);
every READ sweep, fused or not, is one ``fleet_read`` launch.  Not in this
slice: ``locate_wave`` and SCAN/RANGE waves (ROADMAP A6), the obs hub's
per-tick sampling (A11) and the tracer fallback (A12).
"""
from __future__ import annotations

import time
from functools import lru_cache
from itertools import chain
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import codec
from .api import KVFuture, Op, SimBackend, _fold32, probe_to_host
from .faults import SchedulerStalled
from .shadow import build_shadow, hash32
from .sim import Scheduler

__all__ = ["FleetEngine"]

_VERB_ORDER = ("read", "write", "cas", "faa", "alloc", "free")


@lru_cache(maxsize=None)
def _cid_salt(cid: int) -> int:
    """Per-client 32-bit salt so one shared shadow index can hold every
    client's (private) cache entries without cross-client key collisions
    becoming hits: probe keys are ``fold32(key) ^ salt(cid)``; a residual
    fp/fold collision is rejected by the exact (cid, key) guard."""
    return int(hash32(torch.tensor([cid]), 5)[0])


class FleetEngine:
    """Batched tick driver over a ``sim.Scheduler``.  See module docstring.

    One engine per scheduler; mixing ``tick()`` with per-verb ``step()``
    driving is legal (both are valid schedules of the same machine) —
    benchmarks use pure fleet ticks, correctness tests mix freely.
    """

    def __init__(self, scheduler: Scheduler):
        self.sched = scheduler
        # fleet counters live in the scheduler's metrics registry under
        # "fleet.<name>" dotted names
        reg = scheduler.metrics
        names = ("ticks", "verbs", "array_calls", "master_calls",
                 "index_probe_verbs", "probe_invocations", "probe_keys",
                 "probe_hits", "shadow_rebuilds", "fused_ticks",
                 "fallback_ticks")
        self._handles: Dict[str, Any] = {
            k: reg.counter("fleet." + k) for k in names}
        self._handles["max_lanes"] = reg.gauge("fleet.max_lanes")
        for _k in _VERB_ORDER:
            self._handles["verbs_" + _k] = reg.counter("fleet.verbs_" + _k)
        # hot-loop handle caches: bump .value directly, no dict lookups
        self._c_ticks = self._handles["ticks"]
        self._c_verbs = self._handles["verbs"]
        self._c_master = self._handles["master_calls"]
        self._g_max_lanes = self._handles["max_lanes"]
        self._c_array = self._handles["array_calls"]
        self._c_idx_probe = self._handles["index_probe_verbs"]
        self._c_fused = self._handles["fused_ticks"]
        self._c_fallback = self._handles["fallback_ticks"]
        self._c_verbs_kind = {k: self._handles["verbs_" + k]
                              for k in _VERB_ORDER}
        # memoized combined shadow: (per-backend fingerprints, entries, table)
        self._probe_memo = (None, None, None)
        # wall-clock per-tick phase accumulators (seconds): coord-build /
        # sweep / scatter / bookkeeping.  Host- and path-dependent by
        # nature, so they live on the engine, NOT in the metrics registry —
        # same-seed registry values stay identical.  Read by
        # tick_phase_profile().
        self._tp = [0.0, 0.0, 0.0, 0.0]
        self._tp_ticks = 0
        self._fused_tp = (0.0, 0.0)

    # ------------------------------------------------------------- ticking
    def tick(self) -> int:
        """One fleet tick: scheduler tick preamble (fault hooks, MN-failure
        detection), then the head verb of EVERY (client, MN) lane plus one
        queued master call per client, executed as batched array ops.
        Returns the number of verbs + master calls executed."""
        sched = self.sched
        sched.begin_tick()
        _pc = time.perf_counter
        t_coord0 = _pc()
        by_kind: Dict[str, List[Tuple[int, Any, int, Any]]] = {}
        master_runs: List[Tuple[int, Any]] = []
        lanes = 0
        for cid in sorted(sched.pipes):
            pipe = sched.pipes[cid]
            if pipe.master_q:
                master_runs.append((cid, pipe.master_q.popleft()))
            for mn in sorted(pipe.qp):
                q = pipe.qp[mn]
                run, idx, verb = q.popleft()
                if not q:
                    del pipe.qp[mn]
                by_kind.setdefault(verb.kind, []).append((cid, run, idx, verb))
                lanes += 1
        executed = lanes + len(master_runs)
        self._c_ticks.value += 1
        self._c_verbs.value += lanes
        self._c_master.value += len(master_runs)
        self._g_max_lanes.set_max(lanes)

        finished: List[Tuple[int, Any]] = []
        epoch = sched.pool.epoch
        # the fused sweep cannot mirror migration dual-writes: those ticks
        # run the per-kind *_batch verbs (which mirror; their READ still
        # launches fleet_read)
        use_fused = not sched.pool.migrations
        live_by_kind: Dict[str, list] = {}
        for kind, items in by_kind.items():
            self._c_verbs_kind[kind].value += len(items)
            # stale-epoch verbs FAIL without touching the pool (§5.2 —
            # mirrors sim._exec_verb's guard)
            live_by_kind[kind] = [it for it in items
                                  if not (0 <= it[3].epoch != epoch)]
        coord = _pc() - t_coord0
        sweep = scatter = 0.0
        fused_res: Dict[str, list] = {}
        if use_fused and any(live_by_kind.get(k)
                             for k in ("read", "write", "cas", "faa")):
            fused_res = self._exec_fused(live_by_kind)
            d_coord, d_sweep = self._fused_tp
            coord += d_coord
            sweep += d_sweep
            self._c_fused.value += 1
        elif lanes:
            self._c_fallback.value += 1
        for kind in _VERB_ORDER:
            items = by_kind.get(kind)
            if not items:
                continue
            live = live_by_kind[kind]
            if kind in fused_res:
                results = fused_res[kind]
            else:
                t0 = _pc()
                results = self._exec_kind(kind, live) if live else []
                sweep += _pc() - t0
            t0 = _pc()
            res_by_id = {id(it): r for it, r in zip(live, results)}
            for it in items:
                cid, run, idx, _verb = it
                run.results[idx] = res_by_id.get(id(it))
                run.pending -= 1
                if run.pending == 0:
                    finished.append((cid, run))
            scatter += _pc() - t0
        # resume generators only after every verb of the tick executed, in
        # deterministic (gather) order: master answers first (step() gives
        # master_q priority), then completed phases
        t0 = _pc()
        for cid, run in master_runs:
            call, run.master_call = run.master_call, None
            sched._advance(cid, run, sched._master_dispatch(call))
        for cid, run in finished:
            sched._advance(cid, run, run.results)
        obs = sched.obs
        if obs is not None:
            obs.on_fleet_tick(self, by_kind)
        tp = self._tp
        tp[0] += coord
        tp[1] += sweep
        tp[2] += scatter
        tp[3] += _pc() - t0
        self._tp_ticks += 1
        return executed

    def tick_phase_profile(self) -> Dict[str, float]:
        """Cumulative wall-clock breakdown of ``tick()``: coord-build
        (lane gather + stale-epoch filter + fused coordinate arrays),
        sweep (the pool array dispatch — ``exec_fused_tick`` or the
        per-kind ``*_batch`` verbs), scatter (result distribution back
        onto the runs), bookkeeping (generator resumes + obs sampling).
        Wall-clock and host-dependent — reported here, never through the
        metrics registry (same-seed snapshots stay byte-identical).  This
        is what makes ``roofline.py``'s ms/tick numbers explainable."""
        names = ("coord_build", "sweep", "scatter", "bookkeeping")
        total = sum(self._tp)
        out: Dict[str, float] = {n: self._tp[i]
                                 for i, n in enumerate(names)}
        for i, n in enumerate(names):
            out[n + "_frac"] = self._tp[i] / total if total > 0 else 0.0
        out["total_s"] = total
        out["ticks"] = float(self._tp_ticks)
        out["us_per_tick"] = (1e6 * total / self._tp_ticks
                              if self._tp_ticks else 0.0)
        return out

    def _exec_kind(self, kind: str, items) -> list:  # lint: allow-epoch (tick() drops stale-epoch verbs before dispatch)
        pool = self.sched.pool
        verbs = [v for (_c, _r, _i, v) in items]
        if kind == "read":
            self._c_array.value += 1
            shard_set = pool.index_region_set
            self._c_idx_probe.value += sum(
                v.region in shard_set for v in verbs)
            return pool.read_batch([v.region for v in verbs],
                                   [v.replica for v in verbs],
                                   [v.off for v in verbs],
                                   [v.n for v in verbs])
        if kind == "write":
            self._c_array.value += 1
            oks = pool.write_batch([v.region for v in verbs],
                                   [v.replica for v in verbs],
                                   [v.off for v in verbs],
                                   [v.words for v in verbs])
            return [True if ok else None for ok in oks]
        if kind == "cas":
            self._c_array.value += 1
            return pool.cas_batch([v.region for v in verbs],
                                  [v.replica for v in verbs],
                                  [v.off for v in verbs],
                                  [v.exp for v in verbs],
                                  [v.new for v in verbs])
        if kind == "faa":
            self._c_array.value += 1
            return pool.faa_batch([v.region for v in verbs],
                                  [v.replica for v in verbs],
                                  [v.off for v in verbs],
                                  [v.delta for v in verbs])
        if kind == "alloc":
            return [pool.alloc_block(v.mn, cid)
                    for (cid, _r, _i, v) in items]
        if kind == "free":
            return [pool.free_block(v.mn, v.region, v.off) for v in verbs]
        raise ValueError(kind)

    def _exec_fused(self, live_by_kind) -> Dict[str, list]:
        """ONE pool dispatch for the tick's four array-verb sweeps
        (``heap.DMPool.exec_fused_tick`` over the flat region slab).
        Returns ``{kind: results}`` aligned with ``live_by_kind[kind]`` —
        element-wise identical to four ``_exec_kind`` calls.  ALLOC/FREE
        are MN-CPU RPCs, not array verbs; they stay on the per-item path.
        """
        pool = self.sched.pool
        t_build0 = time.perf_counter()

        def _i64(vals, k):
            # verb coords go straight to int64 arrays (asarray in the pool
            # sweeps is then a no-op)
            return np.fromiter(vals, np.int64, count=k)

        def _u64(verbs_, attr, k):
            # word values as uint64 arrays; out-of-range values fall back
            # to the plain list (the pool sweeps mask them per element)
            try:
                return np.fromiter((getattr(v, attr) for v in verbs_),
                                   np.uint64, count=k)
            except (OverflowError, TypeError, ValueError):
                return [getattr(v, attr) for v in verbs_]

        reads = writes = cass = faas = None
        r_items = live_by_kind.get("read")
        if r_items:
            verbs = [v for (_c, _r, _i, v) in r_items]
            shard_set = pool.index_region_set
            self._c_idx_probe.value += sum(
                v.region in shard_set for v in verbs)
            k = len(verbs)
            reads = (_i64((v.region for v in verbs), k),
                     _i64((v.replica for v in verbs), k),
                     _i64((v.off for v in verbs), k),
                     _i64((v.n for v in verbs), k))
        w_items = live_by_kind.get("write")
        if w_items:
            verbs = [v for (_c, _r, _i, v) in w_items]
            k = len(verbs)
            words = [v.words for v in verbs]
            ns = _i64(map(len, words), k)
            try:
                # flatten all word values in one C pass while the verb
                # list is hot; the sweep scatters this directly and only
                # falls back to per-list flattening when absent
                vals = np.fromiter(chain.from_iterable(words), np.uint64,
                                   count=int(ns.sum()))
            except (OverflowError, TypeError, ValueError):
                vals = None        # out-of-range word: sweep masks per list
            writes = (_i64((v.region for v in verbs), k),
                      _i64((v.replica for v in verbs), k),
                      _i64((v.off for v in verbs), k),
                      words, ns, vals)
        c_items = live_by_kind.get("cas")
        if c_items:
            verbs = [v for (_c, _r, _i, v) in c_items]
            k = len(verbs)
            cass = (_i64((v.region for v in verbs), k),
                    _i64((v.replica for v in verbs), k),
                    _i64((v.off for v in verbs), k),
                    _u64(verbs, "exp", k), _u64(verbs, "new", k))
        f_items = live_by_kind.get("faa")
        if f_items:
            verbs = [v for (_c, _r, _i, v) in f_items]
            k = len(verbs)
            faas = (_i64((v.region for v in verbs), k),
                    _i64((v.replica for v in verbs), k),
                    _i64((v.off for v in verbs), k),
                    _u64(verbs, "delta", k))
        self._c_array.value += 1
        t_exec0 = time.perf_counter()
        r, w, c, f = pool.exec_fused_tick(reads, writes, cass, faas)
        out = {"read": r, "write": [True if ok else None for ok in w],
               "cas": c, "faa": f}
        t_end = time.perf_counter()
        self._fused_tp = (t_exec0 - t_build0, t_end - t_exec0)
        return out

    # ------------------------------------------------------------- driving
    def run(self, max_ticks: int = 1_000_000) -> int:
        """Drive every in-flight op of every client to completion with
        batched ticks; returns ticks spent."""
        sched = self.sched
        ticks = 0
        while sched.has_work():
            if ticks >= max_ticks or self.tick() == 0:
                raise SchedulerStalled(
                    f"fleet run did not converge after {ticks} ticks "
                    f"(possible livelock)")
            ticks += 1
        return ticks

    # ------------------------------------- cluster-wide batched GET probe
    def probe_wave(self, wants: Sequence[Tuple[SimBackend, Sequence[int]]]
                   ) -> List[list]:
        """ONE batched ``race_lookup`` invocation across every client
        probing the index this tick.

        ``wants`` is ``[(backend, [key64, ...]), ...]``.  Every backend's
        eligible cache entries are folded (salted per cid) into one shared
        shadow index; all keys are probed in a single kernel call.
        Returns, per backend, a CacheEntry-or-None list aligned with its
        keys — exactly what ``SimBackend.submit_many(probed=...)`` takes.
        """
        # (re)build the combined shadow only when some probing client's
        # cache moved since the last wave (same dirty signal as the
        # per-backend memo in SimBackend._kernel_probe)
        fprint = tuple(sorted((be.cid, be._cache_fingerprint())
                              for be, _k in wants))
        if self._probe_memo[0] == fprint:
            _, entries_all, shadow = self._probe_memo
        else:
            entries_all = []                   # (cid, key64, entry)
            keys32: List[int] = []
            cap = (1 << 24) - 2                # shadow ptr field is 24 bits
            for be, _keys in wants:
                salt = _cid_salt(be.cid)
                for k, ce in be._cache_entries():
                    if len(entries_all) >= cap:
                        break
                    entries_all.append((be.cid, k, ce))
                    keys32.append(_fold32(k) ^ salt)
            shadow = build_shadow(torch.tensor(
                keys32, dtype=torch.int64, device=self.sched.pool.device))
            self._probe_memo = (fprint, entries_all, shadow)
            self._handles["shadow_rebuilds"].value += 1
        q: List[int] = []
        spans: List[Tuple[int, int]] = []
        for be, keys64 in wants:
            salt = _cid_salt(be.cid)
            spans.append((len(q), len(keys64)))
            q.extend(_fold32(k) ^ salt for k in keys64)
        self._handles["probe_invocations"].value += 1
        self._handles["probe_keys"].value += len(q)
        if not entries_all or not q:
            return [[None] * n for (_s, n) in spans]
        ptr, found = probe_to_host(
            torch.tensor(q, dtype=torch.int64,
                         device=self.sched.pool.device), shadow)
        c_hits = self._handles["probe_hits"]
        out: List[list] = []
        for (be, keys64), (start, n) in zip(wants, spans):
            hits = []
            for j, key64 in enumerate(keys64):
                ce = None
                p = int(ptr[start + j])
                if found[start + j] and p > 0:
                    ecid, ekey, entry = entries_all[p - 1]
                    # exact guard: the shadow hit must be THIS client's key
                    if ecid == be.cid and ekey == key64:
                        ce = entry
                hits.append(ce)
                if ce is not None:
                    c_hits.value += 1
            out.append(hits)
        return out

    def submit_wave(self, wave: Sequence[Tuple[SimBackend, Sequence[Op]]]
                    ) -> List[List[KVFuture]]:
        """Submit one op batch per backend with all cache-resident GET
        probes served by a single cluster-wide kernel invocation (instead
        of one probe per client, which is what per-backend
        ``submit_batch`` would do).  Backends should be constructed with
        ``max_inflight=0`` (unlimited) — fleet mode paces admission by
        waves, not by per-client backpressure pumps."""
        if any(op.kind in ("scan", "range") for _be, ops in wave
               for op in ops):
            raise NotImplementedError(
                "SCAN/RANGE waves need the ordered index, which is not "
                "ported to repro_torch yet (ROADMAP A6)")
        wants = []
        rows = []                      # per wave row: index into wants or -1
        for be, ops in wave:
            keys64 = [codec.encode_key(op.key) for op in ops
                      if op.kind == "search"]
            if (len(keys64) >= be.batch_search_min and be.client.enable_cache
                    and not be.client.crashed):
                rows.append(len(wants))
                wants.append((be, keys64))
            else:
                rows.append(-1)
        probes = self.probe_wave(wants) if wants else []
        return [be.submit_many(list(ops),
                               probed=probes[row] if row >= 0 else None)
                for (be, ops), row in zip(wave, rows)]

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        c = {k: h.value for k, h in self._handles.items()}
        c["verbs_per_tick"] = c["verbs"] / max(c["ticks"], 1)
        c["array_calls_per_tick"] = c["array_calls"] / max(c["ticks"], 1)
        return c
