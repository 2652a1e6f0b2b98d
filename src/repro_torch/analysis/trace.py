"""Verb-trace recorder: one row per executed one-sided verb.

``VerbTracer.attach(pool)`` wraps the eight ``DMPool`` verb entry points
(``read/write/cas/faa`` and their ``*_batch`` twins) with thin recording
closures installed as *instance* attributes.  A pool that never attaches a
tracer executes the original class methods untouched — the disabled mode
is structurally zero-cost.  ``pause()`` keeps the wrappers installed but
skips recording (the residual wrapper-dispatch cost, the honest "hooks
compiled in but disabled" number); ``chip_smoke.py``'s ``[obs] overhead``
line measures both on the card.  While a tracer records, the fleet engine
runs the per-kind ``*_batch`` verbs instead of the fused tick, which
bypasses the entry points.

Each recorded event is one row across parallel int64 ring-buffer columns:

    seq          global execution order (monotone; survives ring wrap)
    tick         scheduler tick at execution
    cid          issuing client (-1 = master / recovery / migration traffic)
    op_id        scheduler op id (-1 when not attributable to an op)
    phase        op phase ordinal at issue time (rtts + bg_rtts)
    label        interned phase label (see ``labels``)
    verb         0=read 1=write 2=cas 3=faa
    region / replica / off / n
    epoch_issue  lease epoch stamped when the doorbell batch was posted
    epoch_exec   pool epoch when the verb actually executed
    ok           verb completed at the MN (False = crash-stop FAIL)
    arg          cas: expected value; faa: delta; write: first word
    val          cas: new value; write: crc32 of the full payload
    old          cas/faa: value found at the word (bit pattern)
    cause        interned retry/stall cause of the issuing phase (see
                 core/events.py CAUSES; -1 = no cause).  Verbs executed
                 inside a live-migration dual-write window that carry no
                 issue-side cause are stamped ``mig_dual_write`` at
                 execution time (deterministic: migration state is a
                 protocol event).
    bg           1 when the issuing phase is background (off the op's
                 latency critical path); the span profiler separates
                 foreground RTT attribution on this bit, not on label
                 string conventions

Execution context (tick / cid / op / phase / issue epoch) is not visible
at the pool layer, so the scheduler (sim.py) and the fleet engine
(fleet.py) push it just before dispatching each verb — scalar context via
``set_ctx``, one-tick batch context via ``set_batch_ctx``.  Pool traffic
issued outside any client op (master recovery, Alg-3, migration bulk
copies) runs under the master context set at ``begin_tick``.

Counterpart of the JAX package's ``analysis/trace.py``.  The port's verbs
return host numpy words (``np.uint64`` scalars and arrays), so every column
holds the same int64 bit patterns as the reference's on the same run; the
ring itself is host numpy, written with no device sync.
"""
from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np

__all__ = ["VerbTracer", "READ", "WRITE", "CAS", "FAA", "VERB_NAMES"]

READ, WRITE, CAS, FAA = 0, 1, 2, 3
VERB_NAMES = ("read", "write", "cas", "faa")
MASTER_CID = -1

_MASK = 0xFFFF_FFFF_FFFF_FFFF

FIELDS = (
    "seq", "tick", "cid", "op_id", "phase", "label", "verb", "region",
    "replica", "off", "n", "epoch_issue", "epoch_exec", "ok", "arg",
    "val", "old", "cause", "bg",
)

_WRAPPED = ("read", "write", "cas", "faa",
            "read_batch", "write_batch", "cas_batch", "faa_batch")


def _i64(v) -> int:
    """The int64 bit pattern of a (possibly >= 2**63) unsigned word."""
    v = int(v) & _MASK
    return v - (1 << 64) if v >= (1 << 63) else v


def _u64_view(values) -> np.ndarray:
    return np.asarray([int(v) & _MASK for v in values],
                      dtype=np.uint64).view(np.int64)


class VerbTracer:
    """Ring-buffer recorder; see module docstring."""

    def __init__(self, capacity: int = 1 << 20):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self.buf: Dict[str, np.ndarray] = {
            f: np.zeros(self.capacity, np.int64) for f in FIELDS}
        self.n = 0                      # events emitted ever (ring may wrap)
        self.paused = False
        self.pool = None
        self._labels: List[str] = ["master"]
        self._label_ids: Dict[str, int] = {"master": 0}
        # scalar execution context (master defaults)
        self._tick = 0
        self._cid = MASTER_CID
        self._op = -1
        self._phase = -1
        self._label = 0
        self._epoch = -1
        self._cause = -1
        self._bg = 0
        self._mig_cause = self.intern("mig_dual_write")
        self._bc = None                 # one-shot batch context

    # ------------------------------------------------------------- context
    def intern(self, label: str) -> int:
        lid = self._label_ids.get(label)
        if lid is None:
            lid = self._label_ids[label] = len(self._labels)
            self._labels.append(label)
        return lid

    @property
    def labels(self) -> List[str]:
        return list(self._labels)

    def set_ctx(self, tick, cid, op_id, phase, label_id, epoch,
                cause_id=-1, bg=0):
        self._tick = tick
        self._cid = cid
        self._op = op_id
        self._phase = phase
        self._label = label_id
        self._epoch = epoch
        self._cause = cause_id
        self._bg = bg

    def set_master_ctx(self, tick):
        self.set_ctx(tick, MASTER_CID, -1, -1, 0, -1)

    def set_batch_ctx(self, tick, cids, op_ids, phases, label_ids, epochs,
                      causes=None, bgs=None):
        """Per-verb context for the next ``*_batch`` pool call (fleet tick).
        Consumed by exactly one batch; cleared afterwards."""
        self._tick = tick
        n = len(np.asarray(cids, np.int64))
        self._bc = (np.asarray(cids, np.int64),
                    np.asarray(op_ids, np.int64),
                    np.asarray(phases, np.int64),
                    np.asarray(label_ids, np.int64),
                    np.asarray(epochs, np.int64),
                    np.full(n, -1, np.int64) if causes is None
                    else np.asarray(causes, np.int64),
                    np.zeros(n, np.int64) if bgs is None
                    else np.asarray(bgs, np.int64))

    def pause(self):
        self.paused = True

    def resume(self):
        self.paused = False

    # ------------------------------------------------------------ attaching
    def attach(self, pool) -> "VerbTracer":
        if self.pool is not None:
            raise RuntimeError("tracer already attached")
        if getattr(pool, "_tracer", None) is not None:
            raise RuntimeError("pool already has a tracer attached")
        self.pool = pool
        for name in _WRAPPED:
            setattr(pool, name, self._wrapper(pool, name))
        pool._tracer = self
        return self

    def detach(self):
        pool, self.pool = self.pool, None
        if pool is None:
            return
        for name in _WRAPPED:
            # drop the instance attribute -> calls fall back to the class
            # method, restoring the structurally zero-cost path
            pool.__dict__.pop(name, None)
        pool._tracer = None

    def _wrapper(self, pool, name):
        inner = getattr(type(pool), name).__get__(pool)
        tr = self
        if name == "read":
            def read(region, replica, off, n):
                out = inner(region, replica, off, n)
                if not tr.paused:
                    tr._emit(READ, region, replica, off, n,
                             out is not None, 0, 0, 0)
                return out
            return read
        if name == "write":
            def write(region, replica, off, words):
                ok = inner(region, replica, off, words)
                if not tr.paused:
                    w = [int(x) & _MASK for x in words]
                    tr._emit(WRITE, region, replica, off, len(w), bool(ok),
                             w[0] if w else 0, _payload_sig(w), 0)
                return ok
            return write
        if name == "cas":
            def cas(region, replica, off, exp, new):
                old = inner(region, replica, off, exp, new)
                if not tr.paused:
                    tr._emit(CAS, region, replica, off, 1, old is not None,
                             exp, new, 0 if old is None else old)
                return old
            return cas
        if name == "faa":
            def faa(region, replica, off, delta):
                old = inner(region, replica, off, delta)
                if not tr.paused:
                    tr._emit(FAA, region, replica, off, 1, old is not None,
                             delta, 0, 0 if old is None else old)
                return old
            return faa
        if name == "read_batch":
            def read_batch(regions, replicas, offs, ns):
                out = inner(regions, replicas, offs, ns)
                if not tr.paused:
                    oks = np.asarray([r is not None for r in out], np.int64)
                    tr._emit_vec(READ, regions, replicas, offs,
                                 np.asarray(ns, np.int64), oks,
                                 None, None, None)
                else:
                    tr._bc = None
                return out
            return read_batch
        if name == "write_batch":
            def write_batch(regions, replicas, offs, words_list):
                out = inner(regions, replicas, offs, words_list)
                if not tr.paused:
                    clean = [[int(x) & _MASK for x in w] for w in words_list]
                    tr._emit_vec(
                        WRITE, regions, replicas, offs,
                        np.asarray([len(w) for w in clean], np.int64),
                        np.asarray(out, np.int64),
                        _u64_view([w[0] if w else 0 for w in clean]),
                        np.asarray([_payload_sig(w) for w in clean],
                                   np.int64),
                        None)
                else:
                    tr._bc = None
                return out
            return write_batch
        if name == "cas_batch":
            def cas_batch(regions, replicas, offs, exps, news):
                out = inner(regions, replicas, offs, exps, news)
                if not tr.paused:
                    tr._emit_vec(
                        CAS, regions, replicas, offs,
                        np.ones(len(out), np.int64),
                        np.asarray([v is not None for v in out], np.int64),
                        _u64_view(exps), _u64_view(news),
                        _u64_view([0 if v is None else v for v in out]))
                else:
                    tr._bc = None
                return out
            return cas_batch
        if name == "faa_batch":
            def faa_batch(regions, replicas, offs, deltas):
                out = inner(regions, replicas, offs, deltas)
                if not tr.paused:
                    tr._emit_vec(
                        FAA, regions, replicas, offs,
                        np.ones(len(out), np.int64),
                        np.asarray([v is not None for v in out], np.int64),
                        _u64_view(deltas), None,
                        _u64_view([0 if v is None else v for v in out]))
                else:
                    tr._bc = None
                return out
            return faa_batch
        raise ValueError(name)

    # ------------------------------------------------------------ recording
    def _emit(self, verb, region, replica, off, n, ok, arg, val, old):
        b = self.buf
        i = self.n % self.capacity
        b["seq"][i] = self.n
        b["tick"][i] = self._tick
        b["cid"][i] = self._cid
        b["op_id"][i] = self._op
        b["phase"][i] = self._phase
        b["label"][i] = self._label
        b["verb"][i] = verb
        b["region"][i] = region
        b["replica"][i] = replica
        b["off"][i] = off
        b["n"][i] = n
        b["epoch_issue"][i] = self._epoch
        b["epoch_exec"][i] = self.pool.epoch
        b["ok"][i] = 1 if ok else 0
        b["arg"][i] = _i64(arg)
        b["val"][i] = _i64(val)
        b["old"][i] = _i64(old)
        c = self._cause
        if c < 0 and self.pool.migrations:
            c = self._mig_cause
        b["cause"][i] = c
        b["bg"][i] = self._bg
        self.n += 1

    def _emit_vec(self, verb, regions, replicas, offs, ns, oks,
                  arg, val, old):
        m = len(ns)
        bc, self._bc = self._bc, None
        if m == 0:
            return
        b = self.buf
        idx = (self.n + np.arange(m)) % self.capacity
        b["seq"][idx] = self.n + np.arange(m)
        b["tick"][idx] = self._tick
        if bc is not None and len(bc[0]) == m:
            cids, op_ids, phases, label_ids, epochs, causes, bgs = bc
        else:   # un-attributed batch traffic (e.g. migration bulk copy)
            cids = op_ids = phases = -1
            label_ids, epochs = 0, -1
            causes, bgs = -1, 0
        if self.pool.migrations:
            # dual-write window: stamp verbs that carry no issue-side cause
            causes = np.where(np.asarray(causes, np.int64) < 0,
                              self._mig_cause, causes)
        b["cid"][idx] = cids
        b["op_id"][idx] = op_ids
        b["phase"][idx] = phases
        b["label"][idx] = label_ids
        b["cause"][idx] = causes
        b["bg"][idx] = bgs
        b["verb"][idx] = verb
        b["region"][idx] = np.asarray(regions, np.int64)
        b["replica"][idx] = np.asarray(replicas, np.int64)
        b["off"][idx] = np.asarray(offs, np.int64)
        b["n"][idx] = ns
        b["epoch_issue"][idx] = epochs
        b["epoch_exec"][idx] = self.pool.epoch
        b["ok"][idx] = oks
        b["arg"][idx] = 0 if arg is None else arg
        b["val"][idx] = 0 if val is None else val
        b["old"][idx] = 0 if old is None else old
        self.n += m

    # ------------------------------------------------------------- reading
    @property
    def dropped(self) -> int:
        """Events that fell off the ring (oldest-first)."""
        return max(0, self.n - self.capacity)

    def events(self) -> Dict[str, np.ndarray]:
        """The retained trace window as seq-ascending column arrays."""
        if self.n <= self.capacity:
            return {f: a[:self.n].copy() for f, a in self.buf.items()}
        c = self.n % self.capacity
        return {f: np.concatenate([a[c:], a[:c]])
                for f, a in self.buf.items()}

    def save(self, path):
        """Persist the trace window (+ label table) as an ``.npz`` — the
        artifact format the CI analysis job uploads for flagged runs."""
        np.savez_compressed(
            path, **self.events(),
            _labels=np.asarray(self._labels, dtype=object),
            _dropped=np.asarray([self.dropped], np.int64))

    @staticmethod
    def load(path):
        """Load a saved trace -> (events dict, labels list)."""
        with np.load(path, allow_pickle=True) as z:
            n = len(z["seq"])
            # traces saved before the cause/bg columns load with defaults
            ev = {f: z[f] if f in z.files
                  else np.full(n, -1 if f == "cause" else 0, np.int64)
                  for f in FIELDS}
            labels = [str(x) for x in z["_labels"]]
        return ev, labels


def _payload_sig(words) -> int:
    """Order-sensitive signature of a write payload (value comparison for
    the write/write race rule without retaining full payloads)."""
    return zlib.crc32(np.asarray(words, np.uint64).tobytes())
