"""The public FUSEE store API: pipelined batch ops over futures.

FUSEE's whole point is that *clients* drive metadata concurrently — each
client keeps many doorbell-batched ops in flight against the replicated
RACE index (§4.3, Fig. 9).  This module is the client-facing surface over
that machinery:

* ``Op`` — an immutable request (get/insert/update/delete/reclaim) over
  **bytes/str keys and variable-length byte values** (core/codec.py maps
  them onto the 64-bit-key, word-value protocol substrate);
* ``KVFuture`` — a handle to an in-flight op; ``result()`` drives the
  event scheduler until the op responds;
* ``KVStore`` — ``submit`` / ``submit_batch`` plus blocking
  ``get``/``put``/``delete``/``scan``/``range``/``stats`` conveniences,
  over a pluggable backend:

  - ``SimBackend``: the paper-faithful event-level simulation
    (core/client.py + core/sim.py), with any number of ops in flight per
    client ((cid, op_id) pipelines, per-(client, MN) FIFO preserved).

Batched SEARCH fast path: when a ``submit_batch`` carries several GETs
whose keys are resident in the client's adaptive index cache (§4.6), the
API matches the batch against a shadow copy of the cache — built on the
pool's device — through the ``race_lookup`` kernel and fuses all hits into
**one** doorbell batch (client.op_search_batch) — the whole batch costs 1
RTT instead of 1-2 RTTs per key.  Keys that miss (or fail validation) fall
back to individual SEARCH ops, resubmitted at the batch's response tick.

Counterpart of the JAX package's ``core/api.py``; SCAN/RANGE run over the
ordered keydir (core/ordered.py), a batch's scans located by one
``leaf_probe`` call.  A batch's probe keys feed the obs hub's heat sketch,
hashed on the host (``shadow.hash32_np``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

import torch

from . import codec
from . import ordered
from .events import CRASHED, OK, OpResult
from .faults import ClientCrashed, OrderedIndexDisabled, SchedulerStalled
from .shadow import build_shadow, hash32_np
from .staging import Staging
from ..kernels.race_lookup.ops import MASK24, check_table, race_lookup_probe
from ..obs.registry import LegacyCounters, Registry, legacy_counters_view

__all__ = ["Op", "KVFuture", "KVStore", "SimBackend"]


# ----------------------------------------------------------------- requests
KINDS = ("search", "insert", "update", "delete", "reclaim", "scan", "range")


@dataclass(frozen=True)
class Op:
    """One store request.  Keys are bytes/str/int; values bytes/str or a
    raw word list (legacy protocol callers).

    Ordering: ops submitted together (or while others are still in
    flight) are **concurrent** — like verbs in one RDMA doorbell batch,
    they may take effect in any linearizable order.  For read-your-write
    ordering, ``result()`` the earlier future before submitting the next
    op."""
    kind: str                      # one of KINDS
    key: Any = None
    value: Any = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown op kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    @staticmethod
    def get(key) -> "Op":
        return Op("search", key)

    @staticmethod
    def put(key, value) -> "Op":
        """Upsert (the paper's INSERT upserts on duplicate keys)."""
        return Op("insert", key, value)

    @staticmethod
    def insert(key, value) -> "Op":
        return Op("insert", key, value)

    @staticmethod
    def update(key, value) -> "Op":
        return Op("update", key, value)

    @staticmethod
    def delete(key) -> "Op":
        return Op("delete", key)

    @staticmethod
    def reclaim() -> "Op":
        return Op("reclaim")

    @staticmethod
    def scan(start_key, count: int) -> "Op":
        """SCAN: the next ``count`` live keys >= start_key in key order,
        with their values (ordered keydir; needs ordered_index=True).
        Byte/str start keys address the hashed 64-bit key space — integer
        keys scan in true numeric order."""
        return Op("scan", start_key, int(count))

    @staticmethod
    def range(start_key, end_key) -> "Op":
        """RANGE: every live key in ``[start_key, end_key)`` with its
        value, in key order (ordered keydir; needs ordered_index=True)."""
        return Op("range", start_key, end_key)


# ------------------------------------------------------------------ futures
class KVFuture:
    """Handle to an in-flight op.  ``result()`` drives the backend until
    the op responds, then returns the decoded ``OpResult``."""

    __slots__ = ("_backend", "record", "_resolved")

    def __init__(self, backend, record=None):
        self._backend = backend
        self.record = record        # sim OpRecord (rebindable on fallback)
        self._resolved: Optional[OpResult] = None

    def _resolve(self, result: OpResult, record=None):
        self._resolved = result
        if record is not None:
            self.record = record

    def done(self) -> bool:
        if self._resolved is not None:
            return True
        return self.record is not None and self.record.result is not None

    def result(self) -> OpResult:
        if not self.done():
            self._backend.drive(self)
        if self._resolved is not None:
            res = self._resolved
        else:
            rec = self.record
            res = dataclasses.replace(rec.result, rtts=rec.rtts,
                                      bg_rtts=rec.bg_rtts)
        kind = self.record.kind if self.record is not None else None
        v = res.value
        if isinstance(v, list) and (kind in ("scan", "range")
                                    or (v and isinstance(v[0], tuple))):
            # scan results are [(key, value_words), ...]: decode each
            # (device futures carry no record, so pair lists self-identify)
            return dataclasses.replace(res, value=[
                (k, codec.decode_value(w)) for (k, w) in v])
        return dataclasses.replace(res, value=codec.decode_value(v))


# -------------------------------------------------------------- sim backend
def _fold32(key64: int) -> int:
    return (key64 ^ (key64 >> 32)) & 0xFFFFFFFF


def fold32(keys64: np.ndarray) -> np.ndarray:
    """``_fold32`` of a uint64 array of keys."""
    return (keys64 ^ (keys64 >> 32)) & 0xFFFFFFFF


class _ProbeStage:
    """The buffers of a device's probes: the keys are written into a pinned
    mirror and go up with one copy, the kernel writes the packed answers
    into pinned host memory in place, and the launch ends in a sync of its
    stream (``race_lookup_probe``, one ctypes call), so the next probe may
    reuse them.  On a CPU device the same buffers are plain host
    tensors."""

    def __init__(self, device: torch.device):
        self.keys = Staging(device, torch.int64)
        self.out = Staging(device, torch.int32)

    def probe(self, q: np.ndarray, table: torch.Tensor) -> np.ndarray:
        n = q.size
        h_keys, h_np = self.keys.host(n)
        out, out_np = self.out.host(n)
        h_np[:] = q
        race_lookup_probe(h_keys, self.keys.buffer(n), table, n, out)
        return out_np.copy()


_stages: Dict[torch.device, _ProbeStage] = {}


def probe_to_host(q: np.ndarray, shadow: torch.Tensor) -> np.ndarray:
    """One batched RACE probe of the uint32 keys ``q`` (any integer numpy
    array) against ``shadow`` (a table that passed ``check_table``), on
    the table's device: a fresh int32 numpy array of packed answers,
    ``found << 24 | ptr`` a key (``probe_hit`` reads one)."""
    stage = _stages.get(shadow.device)
    if stage is None:
        stage = _stages[shadow.device] = _ProbeStage(shadow.device)
    return stage.probe(q, shadow)


def probe_hit(word: int) -> int:
    """The 1-based shadow entry of a packed answer, 0 unless it was found
    with a nonzero pointer."""
    return word & MASK24 if word >> 24 else 0


class SimBackend:
    """Pipelined backend over the event-level protocol simulation.

    Binds one ``FuseeClient`` + the cluster ``Scheduler``; ops are
    submitted as (cid, op_id) pipeline entries, so a client has up to
    ``max_inflight`` concurrent doorbell-batched ops — the scheduler
    preserves per-(client, MN) FIFO verb order across all of them.
    """

    SHADOW_SPB = 8          # slots per bucket of the shadow cache index

    def __init__(self, scheduler, client, *, max_inflight: int = 16,
                 batch_search_min: int = 2):
        self.sched = scheduler
        self.client = client
        self.cid = client.cid
        self.max_inflight = max_inflight
        self.batch_search_min = batch_search_min
        # per-backend metrics registry ("api.*" names): backends are
        # transient (one per ``cluster.store()`` call), so each carries
        # its own small registry rather than sharing the scheduler's —
        # aggregate across backends with obs.registry.snapshot_merge.
        # The old ``counters`` dict survives as a read-only deprecation
        # alias (see obs/registry.py).
        self.metrics = Registry()
        self._handles = {
            k: self.metrics.counter("api." + k)
            for k in ("ops", "batch_lookups", "batch_fast_hits",
                      "batch_fallbacks", "shadow_rebuilds", "scans",
                      "scan_locate_batches")}
        # memoized shadow index: (cache fingerprint, entries, shadow table)
        self._shadow = (None, None, None)
        self._pump_rr = 0     # rotating QP-lane pick (starvation freedom)

    @property
    def counters(self) -> LegacyCounters:
        """Deprecated read-only view of the backend metrics under their
        historical key names; read ``stats()`` or ``self.metrics``."""
        return legacy_counters_view("SimBackend", self._handles)

    # ------------------------------------------------------------- submit
    def submit_many(self, ops: Sequence[Op], *,
                    probed: Optional[list] = None,
                    located: Optional[list] = None) -> List[KVFuture]:
        """Submit a batch.  ``probed`` optionally carries precomputed cache
        probe results for the batch's GET keys (CacheEntry-or-None aligned
        with the GETs, in op order) — the fleet engine passes these so ONE
        cluster-wide ``race_lookup`` invocation serves every client's batch
        in a tick instead of one probe per client.  ``located`` is the
        scan twin: covering-leaf-id hints for the batch's SCAN/RANGE start
        keys (aligned with them in op order, -1 = no hint), from the fleet
        engine's single ``leaf_probe`` invocation per tick."""
        if self.client.crashed:
            raise ClientCrashed(self.cid)
        if self.sched.clients.get(self.cid) is not self.client:
            # stale handle: the client left (or its cid was reused by a
            # later add_client) — reject rather than run on the wrong client
            raise ClientCrashed(self.cid,
                                "removed" if self.cid in self.sched.removed
                                else "replaced")
        futs = [KVFuture(self) for _ in ops]
        self._handles["ops"].value += len(ops)
        scans = [i for i, op in enumerate(ops)
                 if op.kind in ("scan", "range")]
        if scans and not self.client.pool.ordered_regions:
            # reject BEFORE submitting anything: raising mid-batch would
            # strand the already-accepted ops' futures
            raise OrderedIndexDisabled()
        hints: Dict[int, int] = {}
        if scans:
            if located is not None:
                hints = dict(zip(scans, located))
            elif self.client.ord_fences and len(scans) >= 2:
                # one leaf_probe call locates every scan of the batch (the
                # scan twin of the fused GET fast path)
                starts = [codec.encode_key(ops[i].key) for i in scans]
                hints = dict(zip(scans,
                                 ordered.locate_leaves(self.client, starts)))
                self._handles["scan_locate_batches"].value += 1
        batched: Dict[int, Any] = {}
        gets = [i for i, op in enumerate(ops) if op.kind == "search"]
        if (len(gets) >= self.batch_search_min and self.client.enable_cache
                and not self.client.crashed):
            batched = self._try_batch_search(ops, gets, futs, probed=probed)
        for i, op in enumerate(ops):
            if i in batched:
                continue
            try:
                self._submit_one(op, futs[i], hint=hints.get(i, -1))
            except ClientCrashed:
                if not (i or batched):
                    raise      # nothing accepted yet: reject the whole batch
                # the client died mid-batch (fault injection during the
                # backpressure pump): the batch was accepted, so its
                # remaining ops settle CRASHED like any in-flight work.
                for fut in futs[i:]:
                    if not fut.done():
                        fut._resolve(OpResult(CRASHED))
                break
        return futs

    def _submit_one(self, op: Op, fut: KVFuture, *, hint: int = -1):
        while self.max_inflight and self.sched.inflight(self.cid) >= self.max_inflight:
            self._pump()
        key = codec.encode_key(op.key) if op.key is not None else 0
        if op.kind in ("scan", "range"):      # submit_many checked the keydir
            self._handles["scans"].value += 1
            if op.kind == "scan":
                value = int(op.value)
                gen = self.client.op_scan(key, value, hint=hint)
            else:
                value = codec.encode_key(op.value)
                gen = self.client.op_range(key, value, hint=hint)
            fut.record = self.sched.submit(self.cid, op.kind, key, value,
                                           gen=gen)
            return
        value = codec.encode_value(op.value) if op.kind in ("insert", "update") \
            else None
        fut.record = self.sched.submit(self.cid, op.kind, key, value)

    # --------------------------------------------- batched SEARCH fast path
    def _try_batch_search(self, ops, gets, futs, *,
                          probed: Optional[list] = None) -> Dict[int, Any]:
        """Probe the batch's GET keys against a shadow of the client's index
        cache via the race_lookup kernel; fuse all confirmed-resident keys
        into one 1-RTT multi-key SEARCH.  Returns {op_index: key64} for the
        ops consumed by the fused path."""
        keys64 = [codec.encode_key(ops[i].key) for i in gets]
        hit_entries = probed if probed is not None \
            else self._kernel_probe(keys64)
        batch = [(i, k, ce) for i, k, ce in
                 zip(gets, keys64, hit_entries) if ce is not None]
        if len(batch) < self.batch_search_min:
            return {}
        self._handles["batch_lookups"].value += 1
        items = [(k, ce.slot_off, ce.slot_val) for (_, k, ce) in batch]
        rec = self.sched.submit(
            self.cid, "search_batch", None, None,
            gen=self.client.op_search_batch(items))

        def finish(record, batch=batch, futs=futs):
            if record.result.status != OK:
                # client crashed mid-flight: the fused op resolves CRASHED,
                # and so does every per-key future riding on it — no
                # resubmits (the client is dead), no leaked futures.
                res = OpResult(record.result.status)
                for (i, _key64, _ce) in batch:
                    futs[i]._resolve(res, record=record)
                return
            per_key = record.result.value
            for (i, key64, _ce), (stat, val) in zip(batch, per_key):
                if stat == OK:
                    res = OpResult(OK, value=val, rtts=1)
                    # per-key history record for the linearizability checker;
                    # rtts=0 — the single network RTT is tallied on the
                    # parent search_batch record, not once per key
                    sub = type(record)(
                        cid=record.cid, op_id=self.sched.next_op_id(),
                        kind="search", key=key64, value=None,
                        inv_tick=record.inv_tick, resp_tick=record.resp_tick,
                        result=res, rtts=0)
                    self.sched.history.append(sub)
                    futs[i]._resolve(res, record=sub)
                    self._handles["batch_fast_hits"].value += 1
                else:
                    # cache entry went stale mid-flight: full SEARCH,
                    # invoked at the batch's response tick
                    futs[i].record = self.sched.submit(self.cid, "search",
                                                       key64)
                    self._handles["batch_fallbacks"].value += 1

        rec.on_done = finish
        return {i: k for (i, k, _ce) in batch}

    def _cache_entries(self):
        """Cache entries eligible for the fused 1-RTT fast path: healthy
        invalid-ratio AND a current shard version — entries whose index
        shard migrated since fill are left to the full SEARCH path for
        revalidation (the keyed-by-shard-epoch cache contract)."""
        thr = self.client.cache_threshold
        directory = self.client.pool.directory
        return [(k, ce) for k, ce in self.client.cache.items()
                if ce.invalid_ratio <= thr
                and ce.shard_ver == directory.version(ce.region)
                ][:(1 << 24) - 2]

    def _cache_fingerprint(self):
        """Cheap dirty signal for the shadow memo: every cache mutation in
        client.py either changes the entry count or bumps an access /
        invalid counter, and every placement change (migration cutover,
        Alg-3 re-homing) bumps the directory generation.  A (rare) stale
        hit is safe — op_search_batch re-validates every entry against
        the heap and falls back."""
        cache = self.client.cache
        acc = inv = 0
        for ce in cache.values():
            acc += ce.access
            inv += ce.invalid
        return (len(cache), acc, inv, self.client.pool.directory.gen)

    def _shadow_index(self, entries):
        """Build the 32-bit shadow RACE index over the cache on the pool's
        device (vectorized; core/shadow.py).  Overflow entries are
        unreachable via the fast path — a miss, never a wrong hit."""
        keys32 = torch.tensor([_fold32(k) for k, _ in entries],
                              dtype=torch.int64,
                              device=self.sched.pool.device)
        shadow = build_shadow(keys32, spb=self.SHADOW_SPB)
        check_table(shadow)
        return shadow

    def _kernel_probe(self, keys64):
        """Match ``keys64`` against the client's index cache with one
        batched RACE probe (the race_lookup kernel on a memoized
        32-bit shadow index).  Returns a per-key list of
        CacheEntry-or-None."""
        fpr = self._cache_fingerprint()
        if self._shadow[0] == fpr:
            _, entries, shadow = self._shadow
        else:
            entries = self._cache_entries()
            shadow = self._shadow_index(entries)
            self._shadow = (fpr, entries, shadow)
            self._handles["shadow_rebuilds"].value += 1
        q = fold32(np.fromiter(keys64, np.uint64, len(keys64)))
        obs = self.sched.obs
        if obs is not None and len(q):
            # heat sketch over the RACE first-choice bucket family (the
            # fleet probe_wave records its own wave; the two paths are
            # mutually exclusive per batch, so no double-count)
            obs.heat_keys(hash32_np(q.astype(np.uint32), 1))
        if not entries or not keys64:
            return [None] * len(keys64)
        words = probe_to_host(q, shadow).tolist()
        out = []
        for w, k in zip(words, keys64):
            p = probe_hit(w)
            if p:
                ekey, ce = entries[p - 1]
                # guard fp/fold collisions: the table entry must be OUR key
                if ekey == k:
                    out.append(ce)
                    continue
            out.append(None)
        return out

    # -------------------------------------------------------------- driving
    def _pump(self):
        """One round-robin pass over every client with pending work.  The
        lane pick rotates so no (client, MN) QP queue starves behind a
        retry loop flooding another lane (see run_round_robin)."""
        cids = self.sched.eligible_cids()
        if not cids:
            raise SchedulerStalled(
                f"client {self.cid}: scheduler has no runnable work but "
                f"{self.sched.inflight(self.cid)} op(s) are unresolved — "
                "a future detached from its record (wiring bug)")
        for c in cids:
            self._pump_rr += 1
            self.sched.step(c, pick=self._pump_rr)

    def drive(self, fut: KVFuture):
        while not fut.done():
            self._pump()

    def drain(self):
        while self.sched.inflight(self.cid) > 0:
            self._pump()

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        recs = [r for r in self.sched.history
                if r.cid == self.cid and r.result is not None]
        rtts: Dict[str, list] = {}
        for r in recs:
            rtts.setdefault(r.kind, []).append(r.rtts)
        return {
            "backend": "sim",
            "cid": self.cid,
            "crashed": self.client.crashed,
            "epoch": self.client.epoch,
            "mns_alive": sum(m.alive for m in self.sched.pool.mns),
            "inflight": self.sched.inflight(self.cid),
            "completed_ops": len(recs),
            "crashed_ops": sum(r.result.status == CRASHED for r in recs),
            "avg_rtts_by_kind": {k: float(np.mean(v)) for k, v in rtts.items()},
            "cache_entries": len(self.client.cache),
            # inserts whose ordered-keydir entry hit FULL (scan-invisible
            # until the region is resized; size it for the keyspace)
            "ord_full_drops": self.client.ord_full_drops,
            **{k: h.value for k, h in self._handles.items()},
            **self._hot_stats(),
        }

    def _hot_stats(self) -> Dict[str, Any]:
        """Hot-key monitor summary (cluster-wide, not per-cid) when the
        obs hub carries one — empty otherwise so baseline stats dicts are
        unchanged."""
        obs = self.sched.obs
        if obs is None or obs.hotspot is None:
            return {}
        hs = obs.hotspot
        return {
            "hot_keys": [k for k, _c, _e in hs.sketch.top(8)],
            "hot_theta_milli": int(round(hs.theta * 1000)),
            "hot_regime": hs.regime,
        }


# -------------------------------------------------------------------- store
class KVStore:
    """The unified client-facing store: pipelined batch ops over futures.

    One surface for both substrates — construct over ``SimBackend`` (the
    event-level protocol simulation; ``FuseeCluster.store()`` does this)
    or ``serving.DeviceBackend`` (the device-resident pool).
    """

    def __init__(self, backend):
        self.backend = backend

    # ------------------------------------------------------------ pipelined
    def submit(self, op: Op) -> KVFuture:
        return self.backend.submit_many([op])[0]

    def submit_batch(self, ops: Sequence[Op]) -> List[KVFuture]:
        return self.backend.submit_many(list(ops))

    def drain(self):
        """Block until every op this store submitted has responded."""
        self.backend.drain()

    # ------------------------------------------------------------- blocking
    def get(self, key):
        """Value of ``key`` (decoded bytes / word list) or None."""
        r = self.submit(Op.get(key)).result()
        return r.value if r.status == OK else None

    def put(self, key, value) -> OpResult:
        return self.submit(Op.put(key, value)).result()

    def insert(self, key, value) -> OpResult:
        return self.submit(Op.insert(key, value)).result()

    def update(self, key, value) -> OpResult:
        return self.submit(Op.update(key, value)).result()

    def delete(self, key) -> OpResult:
        return self.submit(Op.delete(key)).result()

    def reclaim(self) -> OpResult:
        return self.submit(Op.reclaim()).result()

    def scan(self, start_key, count: int) -> List[tuple]:
        """The next ``count`` live keys >= start_key in key order, as
        ``[(key64, value), ...]`` (needs ``DMConfig.ordered_index=True``;
        integer keys scan in numeric order, byte/str keys in hashed-key
        order)."""
        r = self.submit(Op.scan(start_key, count)).result()
        return r.value if r.status == OK else []

    def range(self, start_key, end_key) -> List[tuple]:
        """Every live key in ``[start_key, end_key)`` with its value, in
        key order (needs ``DMConfig.ordered_index=True``)."""
        r = self.submit(Op.range(start_key, end_key)).result()
        return r.value if r.status == OK else []

    def stats(self) -> Dict[str, Any]:
        """Backend counters: RTT tallies, cache and pipeline state."""
        return self.backend.stats()
