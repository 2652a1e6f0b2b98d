"""Event-level concurrency scheduler for the FUSEE protocol simulation.

Clients are generators yielding ``Phase``s (doorbell-batched verb groups) and
``MasterCall``s.  The scheduler executes *one verb per tick*, chosen by a
schedule (hypothesis-controlled in tests, RNG-driven in benchmarks), while
preserving per-(client, MN) FIFO ordering — the RDMA QP ordering guarantee
the paper's embedded-log used-bit argument depends on (§4.5).

A client may have **many ops in flight** (the pipelined batch API of
core/api.py): each op is keyed by ``(cid, op_id)`` and owns its own
generator, but all of a client's outstanding verbs share one FIFO queue per
target MN — the queue-pair model.  A verb enters its QP queue when the
owning op's phase is issued, so verbs of different ops interleave across
MNs but never reorder on one (client, MN) pair.

Crash injection: ``crash_client`` freezes a client at an arbitrary verb
boundary (partially executed phase = partially written doorbell batch,
for *every* op in its pipeline); its in-flight ops resolve to the typed
retriable ``CRASHED`` outcome (their ``on_done`` hooks fire, so API-level
futures never leak), and further submits raise ``faults.ClientCrashed``.
``crash_mn`` makes every verb touching that MN return FAIL (crash-stop
§5.1); the scheduler detects the dead MN itself ``mn_detect_delay`` ticks
later and runs the master's Alg-3 recovery — no manual
``master.maybe_recover_mns()`` calls.  Tick hooks (``add_tick_hook``)
let a ``faults.FaultInjector`` drive declarative fault schedules.

The scheduler also keeps the raw *history* (invocation/response ticks per op)
consumed by the linearizability checker in tests, and the RTT / byte traffic
tallies consumed by the network performance model (netmodel.py).

Counterpart of the JAX package's ``core/sim.py``: plain host Python.  Each
verb runs against the device-resident pool (core/heap.py), so a step-mode
verb is one device round trip.
"""
from __future__ import annotations

import hashlib
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from .client import FuseeClient
from .events import CRASHED, MasterCall, OpResult, Phase, Verb
from .faults import ClientCrashed, ProtocolViolation, SchedulerStalled
from .heap import DMPool
from .master import Master
from .rng import SimRng, as_simrng
from ..obs.registry import Registry

def _canon_bytes(v, out: list):
    """Flatten a delivered value (phase results / master answers) into a
    canonical byte stream: type-tagged so e.g. 0 and [0] never collide."""
    if v is None:
        out.append(b"N")
    elif isinstance(v, bool):
        out.append(b"B1" if v else b"B0")
    elif isinstance(v, (int, np.integer)):
        out.append(b"I" + int(v).to_bytes(17, "little", signed=True))
    elif isinstance(v, np.ndarray):
        out.append(b"A" + np.ascontiguousarray(v).tobytes())
    elif isinstance(v, (list, tuple)):
        out.append(b"L%d(" % len(v))
        for x in v:
            _canon_bytes(x, out)
        out.append(b")")
    elif isinstance(v, dict):
        out.append(b"D%d(" % len(v))
        for k in sorted(v, key=repr):
            out.append(repr(k).encode())
            _canon_bytes(v[k], out)
        out.append(b")")
    elif isinstance(v, str):
        out.append(b"S" + v.encode())
    else:  # rare: dataclass answers etc. — repr is deterministic here
        out.append(b"R" + repr(v).encode())


def _digest_mix(h: int, op_id: int, send_value) -> int:
    parts = [h.to_bytes(16, "little"), op_id.to_bytes(8, "little")]
    _canon_bytes(send_value, parts)
    return int.from_bytes(
        hashlib.blake2b(b"".join(parts), digest_size=16).digest(), "little")


@dataclass(frozen=True, order=True)
class Choice:
    """One enabled scheduler transition — the enumerable choice-point unit
    the model checker (repro.analysis.explore) explores.

    kind 'lane'    fire the head verb of client ``cid``'s QP lane to ``mn``
    kind 'master'  dispatch client ``cid``'s pending master call
    kind 'event'   fire the armed boundary event ``name`` (crash point,
                   MN-failure detection, migration chunk/cutover commit, ...)

    Every nondeterministic decision of a step-mode run flows through this
    type: ``Scheduler.choices()`` enumerates the enabled set in a
    deterministic order and ``Scheduler.fire()`` executes exactly one.
    ``step(cid, pick)`` remains the schedule-replay surface; it and
    ``fire`` share the same underlying transition helpers, so a run driven
    by either is bit-identical given the same transition sequence."""
    kind: str
    cid: int = -1
    mn: int = -1
    name: str = ""

    def __str__(self) -> str:
        if self.kind == "lane":
            return f"lane(cid={self.cid}, mn={self.mn})"
        if self.kind == "master":
            return f"master(cid={self.cid})"
        return f"event({self.name})"


@dataclass
class _ArmedEvent:
    """An armed boundary event: enumerable as a ``Choice`` while enabled."""
    fire: Callable[["Scheduler"], Any]
    enabled: Optional[Callable[["Scheduler"], bool]] = None
    once: bool = True


@dataclass(frozen=True)
class SimTrace:
    """A replayable schedule: the exact ``(cid, pick)`` sequence a run fed
    through ``Scheduler.step``.  Together with ``(seed, config)`` and the
    same submission sequence, ``Scheduler.run_trace`` reproduces the run
    bit-identically (fleet-mode ticks are schedule-free — deterministic
    from the seed alone — so they contribute no decisions)."""
    seed: int
    decisions: Tuple[Tuple[int, int], ...]
    ticks: int

    def __len__(self) -> int:
        return len(self.decisions)


@dataclass
class OpRecord:
    cid: int
    op_id: int
    kind: str                  # 'search' | 'insert' | 'update' | 'delete' | ...
    key: Any
    value: Optional[list]
    inv_tick: int
    resp_tick: int = -1
    result: Optional[OpResult] = None
    rtts: int = 0
    bg_rtts: int = 0
    # invoked at completion (same tick as resp_tick); used by the batch API
    # to expand multi-key ops into per-key history records and to resubmit
    # fallback ops at the exact response boundary.
    on_done: Optional[Callable[["OpRecord"], None]] = field(
        default=None, repr=False, compare=False)


@dataclass
class _Running:
    gen: Any
    record: OpRecord
    results: List[Any] = field(default_factory=list)
    pending: int = 0                       # unexecuted verbs of current phase
    master_call: Optional[MasterCall] = None
    done: bool = False
    # issue-time context of the current phase, consumed by the verb tracer
    # (repro.analysis.trace) when one is attached to the pool
    phase_no: int = 0
    phase_label: str = ""
    phase_cause: str = ""                  # typed retry/stall cause (CAUSES)
    phase_bg: bool = False


class _ClientPipe:
    """Per-client pipeline state: in-flight ops + per-MN QP FIFO queues."""

    __slots__ = ("runs", "qp", "master_q")

    def __init__(self):
        self.runs: Dict[int, _Running] = {}          # op_id -> run
        self.qp: Dict[int, Deque[Tuple[_Running, int, Verb]]] = {}
        self.master_q: Deque[_Running] = deque()

    def has_work(self) -> bool:
        return bool(self.master_q) or any(self.qp.values())


class Scheduler:
    def __init__(self, pool: DMPool, master: Master, *, seed: int = 0,
                 rng: Optional[SimRng] = None,
                 mn_detect_delay: int = 0, auto_mn_recovery: bool = True):
        self.pool = pool
        self.master = master
        # every random choice derives from one SimRng root (named
        # substreams), so a run is bit-identically replayable from
        # (seed, config); see core/rng.py
        self.simrng = as_simrng(rng, default_seed=seed)
        self.rng = self.simrng.stream("scheduler")
        self.decisions: List[Tuple[int, int]] = []   # every step(cid, pick)
        self.tick = 0
        self.pipes: Dict[int, _ClientPipe] = {}      # cid -> pipeline
        self.history: List[OpRecord] = []
        self._op_counter = itertools.count()
        self.clients: Dict[int, FuseeClient] = {}
        self.removed: set = set()                    # cids removed gracefully
        self.completed_ops = 0                       # ops that responded OK-ish
        self.crashed_ops = 0                         # ops resolved CRASHED
        self.mn_recoveries = 0
        # the cluster metrics registry (repro.obs): protocol components
        # (fleet, migrate, obs hub) register their counters here under
        # stable dotted names; always present, a Counter bump is the only
        # per-event cost.  ``obs`` is the ClusterObs hub (op latency
        # histograms, flight recorder, per-MN series) — None unless a
        # FuseeCluster attached one; every hook site is a single
        # ``is None`` test, so a detached scheduler pays nothing.
        self.metrics = Registry()
        self.obs = None
        # automatic MN failure detection: crash_mn() arms a deadline; the
        # master's Alg-3 recovery runs inside step() once it passes.
        self.auto_mn_recovery = auto_mn_recovery
        self.mn_detect_delay = mn_detect_delay
        self._mn_detect_at: Optional[int] = None
        self._tick_hooks: List[Callable[["Scheduler"], None]] = []
        # choice-point API state (model-checker mode): armed boundary
        # events, the fired-choice log, and manual_boundaries — when True
        # the armed MN-failure detection does NOT auto-fire in begin_tick
        # but surfaces as an enumerable 'mn_detect' event choice instead.
        self._events: Dict[str, _ArmedEvent] = {}
        self.choice_log: List[Choice] = []
        self.manual_boundaries = False
        # model-checker support: when True, every value delivered into an op
        # generator is folded into a per-client rolling digest.  Client-side
        # state (allocator cursors, caches, generator frames) is a pure
        # function of its delivery history, so equal digests + equal pool
        # bytes + equal queue contents imply equal continuations.
        self.track_digests = False
        self.client_digest: Dict[int, int] = {}

    # ------------------------------------------------------------- spawning
    def add_client(self, client: FuseeClient):
        self.clients[client.cid] = client
        self.removed.discard(client.cid)
        self.pipes.setdefault(client.cid, _ClientPipe())
        self.master.register(client)

    def remove_client(self, cid: int):
        """Deregister a drained client.  The cluster surface drains first;
        at this level a non-empty pipeline is a caller bug."""
        if cid not in self.clients:
            raise ClientCrashed(cid, "removed" if cid in self.removed
                                else "unknown")
        pipe = self.pipes.get(cid)
        if pipe is not None and pipe.runs:
            raise ClientCrashed(cid, f"busy ({len(pipe.runs)} ops in flight; "
                                     "drain before remove)")
        self.clients.pop(cid)
        self.pipes.pop(cid, None)
        self.removed.add(cid)
        self.master.deregister(cid)

    def add_tick_hook(self, hook: Callable[["Scheduler"], None]):
        """Invoke ``hook(self)`` at every tick (FaultInjector.poll etc.)."""
        self._tick_hooks.append(hook)

    def remove_tick_hook(self, hook: Callable[["Scheduler"], None]):
        try:
            self._tick_hooks.remove(hook)
        except ValueError:
            pass

    def next_op_id(self) -> int:
        return next(self._op_counter)

    def submit(self, cid: int, kind: str, key, value=None, *,
               gen=None) -> OpRecord:
        """Enqueue one op on client ``cid``'s pipeline.  Any number of ops
        may be in flight per client; per-(client, MN) verb order is FIFO
        across all of them.  ``gen`` overrides the client op generator
        (used by the batch API for multi-key fused ops).

        Raises the typed ``ClientCrashed`` on a crashed, removed, or
        unknown ``cid`` — the op never enters the pipeline."""
        client = self.clients.get(cid)
        if client is None:
            raise ClientCrashed(cid, "removed" if cid in self.removed
                                else "unknown")
        if client.crashed:
            raise ClientCrashed(cid)
        if gen is None:
            gen = {
                "search": lambda: client.op_search(key),
                "insert": lambda: client.op_insert(key, value),
                "update": lambda: client.op_update(key, value),
                "delete": lambda: client.op_delete(key),
                "reclaim": lambda: client.op_reclaim(),
                # ordered keydir (core/ordered.py): value = count / end key
                "scan": lambda: client.op_scan(key, value),
                "range": lambda: client.op_range(key, value),
            }[kind]()
        rec = OpRecord(cid=cid, op_id=self.next_op_id(), kind=kind,
                       key=key, value=value, inv_tick=self.tick)
        self.history.append(rec)
        run = _Running(gen=gen, record=rec)
        self.pipes.setdefault(cid, _ClientPipe()).runs[rec.op_id] = run
        obs = self.obs
        if obs is not None:
            obs.op_begin(rec, self.tick)
        self._advance(cid, run, None)  # prime to the first phase
        return rec

    # ------------------------------------------------------------ execution
    def _advance(self, cid: int, run: _Running, send_value):
        """Resume the generator until it yields the next phase or finishes."""
        pipe = self.pipes[cid]
        if self.track_digests:
            self.client_digest[cid] = _digest_mix(
                self.client_digest.get(cid, 0), run.record.op_id, send_value)
        while True:
            try:
                item = run.gen.send(send_value)
            except StopIteration as stop:
                res: OpResult = stop.value
                run.record.result = res
                run.record.resp_tick = self.tick
                run.done = True
                self.completed_ops += 1
                pipe.runs.pop(run.record.op_id, None)
                obs = self.obs
                if obs is not None:   # buffered; bulk-flushed (obs/flight)
                    obs.op_settled(run.record, self.tick)
                if run.record.on_done is not None:
                    cb, run.record.on_done = run.record.on_done, None
                    cb(run.record)   # cleared first: history retains the
                    return           # record forever, the closure must not
                return               # pin futures/backends with it
            if isinstance(item, MasterCall):
                run.master_call = item
                pipe.master_q.append(run)
                return
            if not isinstance(item, Phase):
                raise ProtocolViolation(
                    f"client {cid} op {run.record.op_id} "
                    f"({run.record.kind}) yielded {type(item).__name__!r}; "
                    "ops must yield Phase or MasterCall")
            run.results = [None] * len(item.verbs)
            run.pending = len(item.verbs)
            if item.background:
                run.record.bg_rtts += 1
            else:
                run.record.rtts += 1
            run.phase_no = run.record.rtts + run.record.bg_rtts
            run.phase_label = item.label
            run.phase_cause = item.cause
            run.phase_bg = item.background
            if not item.verbs:   # empty phase = pure wait (1 RTT beat)
                send_value = []
                continue
            for idx, verb in enumerate(item.verbs):
                verb.epoch = self.pool.epoch   # stale-epoch verbs FAIL (§5.2)
                mn = verb.target_mn(self.pool)
                pipe.qp.setdefault(mn, deque()).append((run, idx, verb))
            return

    def inflight(self, cid: int) -> int:
        pipe = self.pipes.get(cid)
        return len(pipe.runs) if pipe is not None else 0

    def eligible(self, cid: int) -> bool:
        pipe = self.pipes.get(cid)
        return pipe is not None and pipe.has_work()

    def has_work(self) -> bool:
        return any(p.has_work() for p in self.pipes.values())

    def eligible_cids(self) -> List[int]:
        return sorted(c for c, p in self.pipes.items() if p.has_work())

    def begin_tick(self):
        """Advance the clock one tick: run tick hooks (fault injection) and
        the automatic MN-failure detection.  Shared by the per-verb ``step``
        path and the fleet engine's batched tick (core/fleet.py)."""
        self.tick += 1
        tr = self.pool._tracer
        if tr is not None:
            # all pool traffic in a tick is master/recovery context unless a
            # client verb claims it below (step) or in the fleet batch path
            tr.set_master_ctx(self.tick)
        if self._tick_hooks:
            for hook in tuple(self._tick_hooks):  # hooks may self-remove
                hook(self)
        if self._mn_detect_at is not None and self.tick >= self._mn_detect_at \
                and not self.manual_boundaries:
            self._mn_detect_at = None
            if self.master.maybe_recover_mns():
                self.mn_recoveries += 1
                obs = self.obs
                if obs is not None:
                    obs.recovery("mn_recovery", self.tick)

    def step(self, cid: int, pick: int = 0) -> bool:
        """Execute one verb (or master call) of client ``cid``.

        ``pick`` chooses among the client's per-MN FIFO queues, enabling the
        schedule to explore cross-MN orderings within and across the
        doorbell batches of the client's in-flight ops.
        Returns False if the client has nothing to do.
        """
        self.decisions.append((cid, pick))
        self.begin_tick()
        pipe = self.pipes.get(cid)
        if pipe is None:
            return False
        if pipe.master_q:
            return self._fire_master(pipe, cid)
        keys = sorted(mn for mn, q in pipe.qp.items() if q)
        if not keys:
            return False
        return self._fire_lane(pipe, cid, keys[pick % len(keys)])

    # ----------------------------------------------- shared transition core
    def _fire_master(self, pipe: "_ClientPipe", cid: int) -> bool:
        run = pipe.master_q.popleft()
        call, run.master_call = run.master_call, None
        ans = self._master_dispatch(call)
        self._advance(cid, run, ans)
        return True

    def _fire_lane(self, pipe: "_ClientPipe", cid: int, mn: int) -> bool:
        run, idx, verb = pipe.qp[mn].popleft()
        if not pipe.qp[mn]:
            del pipe.qp[mn]
        tr = self.pool._tracer
        if tr is not None:
            tr.set_ctx(self.tick, cid, run.record.op_id, run.phase_no,
                       tr.intern(run.phase_label), verb.epoch,
                       tr.intern(run.phase_cause) if run.phase_cause else -1,
                       1 if run.phase_bg else 0)
        run.results[idx] = self._exec_verb(verb, cid)
        run.pending -= 1
        if run.pending == 0:
            self._advance(cid, run, run.results)
        return True

    # -------------------------------------------------- choice-point API
    def arm_event(self, name: str, fire: Callable[["Scheduler"], Any], *,
                  enabled: Optional[Callable[["Scheduler"], bool]] = None,
                  once: bool = True):
        """Arm a named boundary event (crash point, migration tick,
        recovery trigger, ...).  While armed and enabled it enumerates as
        ``Choice('event', name=...)``; firing runs ``fire(self)`` and —
        with ``once=True`` — disarms it."""
        self._events[name] = _ArmedEvent(fire=fire, enabled=enabled,
                                         once=once)

    def disarm_event(self, name: str):
        self._events.pop(name, None)

    def choices(self) -> List[Choice]:
        """The enabled transition set at the current state, deterministic
        order: per client (sorted cid) either its pending master call or
        one choice per non-empty QP lane (sorted mn); then armed events
        (sorted by name); then — under ``manual_boundaries`` — the armed
        MN-failure detection.  A client whose master call is pending
        exposes only that choice (``step`` gives master calls priority, so
        lane firings under a pending call are unreachable by schedules)."""
        out: List[Choice] = []
        for cid in sorted(self.pipes):
            pipe = self.pipes[cid]
            if pipe.master_q:
                out.append(Choice("master", cid=cid))
            else:
                out += [Choice("lane", cid=cid, mn=mn)
                        for mn in sorted(m for m, q in pipe.qp.items() if q)]
        for name in sorted(self._events):
            ev = self._events[name]
            if ev.enabled is None or ev.enabled(self):
                out.append(Choice("event", name=name))
        if self.manual_boundaries and self._mn_detect_at is not None:
            out.append(Choice("event", name="mn_detect"))
        return out

    def fire(self, ch: Choice) -> bool:
        """Execute one enabled transition (see ``choices``).  Lane and
        master firings also append a ``(cid, pick)`` decision, so a run
        that fired no events replays through ``run_trace`` unchanged.
        Returns False when the choice is not currently enabled."""
        if ch.kind == "event":
            if ch.name == "mn_detect":
                if not (self.manual_boundaries
                        and self._mn_detect_at is not None):
                    return False
                self.choice_log.append(ch)
                self.begin_tick()
                self._mn_detect_at = None
                if self.master.maybe_recover_mns():
                    self.mn_recoveries += 1
                    obs = self.obs
                    if obs is not None:
                        obs.recovery("mn_recovery", self.tick)
                return True
            ev = self._events.get(ch.name)
            if ev is None or (ev.enabled is not None
                              and not ev.enabled(self)):
                return False
            self.choice_log.append(ch)
            self.begin_tick()
            if ev.once:
                self._events.pop(ch.name, None)
            ev.fire(self)
            return True
        pipe = self.pipes.get(ch.cid)
        if pipe is None:
            return False
        if ch.kind == "master":
            if not pipe.master_q:
                return False
            self.choice_log.append(ch)
            self.decisions.append((ch.cid, 0))
            self.begin_tick()
            return self._fire_master(pipe, ch.cid)
        if ch.kind == "lane":
            if pipe.master_q:
                return False       # master call has priority (see choices)
            keys = sorted(mn for mn, q in pipe.qp.items() if q)
            if ch.mn not in keys:
                return False
            self.choice_log.append(ch)
            self.decisions.append((ch.cid, keys.index(ch.mn)))
            self.begin_tick()
            return self._fire_lane(pipe, ch.cid, ch.mn)
        raise ValueError(ch.kind)

    def _exec_verb(self, v: Verb, cid: int):
        p = self.pool
        if 0 <= v.epoch != p.epoch:
            return None   # posted under an expired lease epoch: MR invalid
        if v.kind == "read":
            return p.read(v.region, v.replica, v.off, v.n)
        if v.kind == "write":
            ok = p.write(v.region, v.replica, v.off, v.words)
            return True if ok else None
        if v.kind == "cas":
            return p.cas(v.region, v.replica, v.off, v.exp, v.new)
        if v.kind == "faa":
            return p.faa(v.region, v.replica, v.off, v.delta)
        if v.kind == "alloc":
            return p.alloc_block(v.mn, cid)
        if v.kind == "free":
            return p.free_block(v.mn, v.region, v.off)
        raise ValueError(v.kind)

    def _master_dispatch(self, call: MasterCall):
        if call.kind == "fail_query":
            return self.master.fail_query(**{k: v for k, v in call.payload.items()
                                             if k in ("slot_off", "region")})
        if call.kind == "bucket_query":
            return self.master.bucket_query(
                call.payload["off"],
                region=call.payload.get("region", 0))
        if call.kind == "fail_report":
            self.master.maybe_recover_mns()
            return None
        raise ValueError(call.kind)

    # ------------------------------------------------------------- failure
    def crash_client(self, cid: int):
        """Crash-stop at the current verb boundary: every in-flight doorbell
        batch of the client's pipeline stays partially executed (exactly the
        paper's failure model).  Each in-flight op resolves to the typed
        retriable ``CRASHED`` outcome — its ``on_done`` hook fires so the
        API layer can settle futures (including fused-batch expansion)
        instead of leaking them."""
        client = self.clients.get(cid)
        if client is None:
            raise ClientCrashed(cid, "removed" if cid in self.removed
                                else "unknown")
        pipe = self.pipes.get(cid)
        client.crashed = True
        if pipe is None:
            return
        runs = list(pipe.runs.values())
        self.pipes[cid] = _ClientPipe()
        obs = self.obs
        for run in runs:
            rec = run.record
            rec.result = OpResult(CRASHED, rtts=rec.rtts,
                                  bg_rtts=rec.bg_rtts)
            rec.resp_tick = self.tick
            run.done = True
            self.crashed_ops += 1
            if obs is not None:
                obs.op_settled(rec, self.tick)
            if rec.on_done is not None:
                cb, rec.on_done = rec.on_done, None
                cb(rec)

    def crash_mn(self, mid: int):
        """Crash-stop an MN.  Detection + Alg-3 recovery run automatically
        inside the scheduler loop ``mn_detect_delay`` ticks later (the
        lease window); clients that touch the dead MN before then see FAIL
        verbs and take the Alg-4 degraded path."""
        self.pool.crash_mn(mid)
        if self.auto_mn_recovery:
            deadline = self.tick + self.mn_detect_delay
            if self._mn_detect_at is None:
                self._mn_detect_at = deadline
            else:
                self._mn_detect_at = min(self._mn_detect_at, deadline)

    # ------------------------------------------------------------- driving
    def run_round_robin(self, max_ticks: int = 1_000_000):
        """Drive all in-flight ops to completion, round-robin.

        ``pick`` rotates deterministically so every (client, MN) QP lane
        makes progress: a fixed pick=0 would starve higher lanes whenever
        some op keeps refilling a lower one (e.g. the ordered keydir's
        bounded retry loops waiting on a racing splitter's clears)."""
        ticks = 0
        while ticks < max_ticks:
            progressed = False
            for cid in self.eligible_cids():
                if self.step(cid, pick=ticks):
                    ticks += 1
                    progressed = True
            if not progressed:
                break
        if self.has_work():
            raise SchedulerStalled(
                f"ops did not converge after {ticks} round-robin ticks "
                f"(tick {self.tick}, eligible cids "
                f"{self.eligible_cids()}): possible livelock")

    def run_random(self, rng=None, max_ticks: int = 2_000_000):
        rng = rng or self.rng
        ticks = 0
        while ticks < max_ticks:
            cids = self.eligible_cids()
            if not cids:
                break
            cid = cids[int(rng.integers(len(cids)))]
            self.step(cid, pick=int(rng.integers(4)))
            ticks += 1
        if self.has_work():
            raise SchedulerStalled(
                f"ops did not converge after {ticks} random ticks "
                f"(tick {self.tick}, eligible cids "
                f"{self.eligible_cids()}): possible livelock")

    def run_schedule(self, schedule, max_extra: int = 500_000):
        """Drive with an explicit (cid, pick) schedule; fall back to
        round-robin once the schedule is exhausted (ensures completion)."""
        for (cid, pick) in schedule:
            cids = self.eligible_cids()
            if not cids:
                return
            self.step(cids[cid % len(cids)], pick=pick)
        self.run_round_robin(max_ticks=max_extra)

    # ------------------------------------------------------------- replay
    def trace(self) -> SimTrace:
        """Snapshot of every scheduling decision taken so far (the
        schedule-replay hook of the deterministic-simulation contract)."""
        return SimTrace(seed=self.simrng.seed,
                        decisions=tuple(self.decisions), ticks=self.tick)

    def run_trace(self, trace: SimTrace, *, start: int = 0):
        """Re-execute a recorded schedule verbatim: ``step(cid, pick)`` for
        every recorded decision from index ``start`` on.  Replaying against
        the same ``(seed, config)`` and submission sequence reproduces the
        original run bit-identically."""
        for (cid, pick) in trace.decisions[start:]:
            self.step(cid, pick=pick)


def run_ops_concurrently(pool: DMPool, master: Master, ops, *, seed=0,
                         schedule=None) -> List[OpRecord]:
    """Convenience: submit ``ops`` = [(client, kind, key, value)], run all."""
    sched = Scheduler(pool, master, seed=seed)
    for c in {c for (c, *_ ) in ops}:
        sched.add_client(c)
    recs = []
    for (client, kind, key, value) in ops:
        recs.append(sched.submit(client.cid, kind, key, value))
    if schedule is not None:
        sched.run_schedule(schedule)
    else:
        sched.run_random()
    return recs
