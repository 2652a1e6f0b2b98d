"""Systematic schedule exploration: a DPOR model checker over the sim.

Random storms (races.py `_storm_run`) *sample* interleavings; this module
*enumerates* them for small scopes — 2–3 clients, 1–2 MNs, a few colliding
keys — and asserts the full FUSEE correctness contract on every maximal
schedule: per-key linearizability, race-detector-clean, heap-audit-clean,
and no acked-write-loss.  The churn-cutover acked-write-loss bug (storm
seed 7) is the first paying customer: the minimized counterexample from
the `cutover` scope is the root-cause artifact.

Choice-point contract (core/sim.py): every nondeterministic decision of a
step-mode run is one `Choice` — which (client, MN) QP lane fires its head
verb, when a pending master call dispatches, and when an armed boundary
event (client/MN crash, MN-failure detection, migration chunk / cutover
commit) triggers.  `Scheduler.choices()` enumerates the enabled set in a
deterministic order; `Scheduler.fire(ch)` executes exactly one.  A state
is therefore reproducible as the `Choice` sequence that reached it.

Exploration = stateless depth-first search by re-execution: a branch is
(prefix choices) + (one backtracked choice) + leftmost deterministic
continuation to a *maximal* (drained) state.  Two reductions prune the
tree:

  * dynamic partial-order reduction — per fired transition the attached
    `VerbTracer` yields its word-level footprint; only transitions whose
    footprints conflict (same region words, at least one writer, from
    different processes) schedule a backtrack point.  Boundary events get
    a conservative global footprint (they reorder against everything).
  * state-hash dedup — a blake2b digest over (pool region bytes, placement
    + epoch, QP/master queue contents, per-client delivery digests, armed
    events, completed-op results).  Client-internal state (allocator
    cursors, caches, generator frames) is a pure function of the client's
    delivery history, which `Scheduler.client_digest` folds per delivery,
    so equal digests imply equal continuations.  Reaching a visited state
    cuts the branch: its (deterministic leftmost) continuation — and the
    invariant verdict at its maximal state — was already covered.

On violation the full schedule is delta-debugged (ddmin) down to a minimal
choice prefix whose leftmost continuation still violates, and saved as a
pickle-free `.npz` counterexample:

    python -m repro_torch.analysis.explore --scope cutover \
        --unsafe client.UNSAFE_FREE_OWN_ON_RETRY --out ce/
    python -m repro_torch.analysis.explore --repro ce/cutover.npz

Counterpart of the JAX package's ``analysis/explore.py``: the same scopes,
dependence relation, DFS, ddmin and ``.npz`` format, so both packages reach
the same states, visit digest and minimized schedules, and a counterexample
saved by one replays in the other.  The one addition is the cluster's
device: ``Explorer``, ``explore()``, ``Scope.build`` and ``replay`` take a
``device`` that means the card when omitted (and raises where there is
none); ``--device cpu`` runs on the CPU.  The explorer itself is host
Python and numpy; ``state_hash`` reads the pool with one host copy of the
region slab per state.
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core import client as client_mod
from ..core import master as master_mod
from ..core import race as race_mod
from ..core import sim as sim_mod
from ..core.heap import DMConfig, resolve_device, to_u64
from ..core.layout import fingerprint
from ..core.linearize import HOp, check_linearizable, records_to_hops
from ..core.sim import Choice
from ..core.store import FuseeCluster
from . import heapcheck, races
from .trace import CAS, FAA, READ, WRITE

__all__ = ["Explorer", "ExploreResult", "Violation", "Scope", "SCOPES",
           "check_invariants", "explore", "save_counterexample",
           "load_counterexample", "replay", "main"]

# crash probes never ack, so a landed-or-not crashed write is modeled as a
# maybe-op during linearization; cap the subset blow-up (events per scope
# arm at most one or two crashes)
_MAX_CRASHED_SUBSET = 6
_FAR_FUTURE = 1 << 60


# --------------------------------------------------------------------- flags
# the test-only protocol-hole switches a scope may re-enable, addressed as
# "module.ATTRIBUTE" (the same names the regression tests flip)
_FLAG_MODULES = {"client": client_mod, "master": master_mod,
                 "sim": sim_mod}


def _flag_items(flags: Optional[Dict[str, bool]]) -> List[Tuple[str, bool]]:
    return sorted((flags or {}).items())


class _FlagGuard:
    """Apply test-only UNSAFE_* module flags for the guard's lifetime."""

    def __init__(self, flags: Optional[Dict[str, bool]]):
        self.flags = _flag_items(flags)
        self._saved: List[Tuple[object, str, bool]] = []

    def __enter__(self):
        for spec, val in self.flags:
            modname, attr = spec.split(".", 1)
            mod = _FLAG_MODULES[modname]
            if not attr.startswith("UNSAFE_") or not hasattr(mod, attr):
                raise ValueError(f"unknown test-only flag {spec!r}")
            self._saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, val)
        return self

    def __exit__(self, *exc):
        while self._saved:
            mod, attr, old = self._saved.pop()
            setattr(mod, attr, old)
        return False


# -------------------------------------------------------------------- scopes
@dataclass
class ScopeSetup:
    """One fresh, fully-submitted exploration instance."""
    cluster: FuseeCluster
    keys: Tuple[int, ...]              # keys under linearizability check
    tracer: object                     # attached VerbTracer


@dataclass(frozen=True)
class Scope:
    name: str
    doc: str
    build: Callable[..., ScopeSetup]   # build(device=None): the card if None


def _small_cfg(*, num_mns=1, replication=1, regions_per_mn=4,
               index_buckets=4) -> DMConfig:
    return DMConfig(num_mns=num_mns, replication=replication,
                    region_words=1 << 9, block_words=1 << 7,
                    regions_per_mn=regions_per_mn,
                    index_buckets=index_buckets, slots_per_bucket=7,
                    size_classes=4, index_shards=1)


def _mk_cluster(cfg: DMConfig, num_clients: int, device) -> FuseeCluster:
    cl = FuseeCluster(cfg, num_clients=num_clients, seed=0,
                      enable_cache=False, device=device)
    cl.scheduler.manual_boundaries = True
    cl.scheduler.track_digests = True
    return cl


def _setup(cl: FuseeCluster, keys) -> ScopeSetup:
    tr = cl.attach_tracer(capacity=1 << 16)
    return ScopeSetup(cluster=cl, keys=tuple(keys), tracer=tr)


def colliding_keys(n_buckets: int, count: int = 2,
                   start: int = 1) -> List[int]:
    """``count`` distinct keys sharing one RACE bucket pair (so their
    inserts race on the same empty slot word) with pairwise distinct
    fingerprints (so a lost insert is *detectable* as a foreign value)."""
    base = race_mod.bucket_pair(start, n_buckets)
    keys, fps, k = [start], {fingerprint(start)}, start + 1
    while len(keys) < count:
        if race_mod.bucket_pair(k, n_buckets) == base \
                and fingerprint(k) not in fps:
            keys.append(k)
            fps.add(fingerprint(k))
        k += 1
    return keys


def _scope_insert_race(device=None) -> ScopeSetup:
    cl = _mk_cluster(_small_cfg(), num_clients=2, device=device)
    for cid in (0, 1):
        cl.scheduler.submit(cid, "insert", 1, [cid + 1, 7])
        cl.scheduler.submit(cid, "update", 1, [cid + 1, 8])
    return _setup(cl, [1])


def _scope_no_fault(device=None) -> ScopeSetup:
    cl = _mk_cluster(_small_cfg(), num_clients=2, device=device)
    k1, k2 = colliding_keys(cl.cfg.index_buckets, 2)
    cl.scheduler.submit(0, "insert", k1, [10, 1])
    cl.scheduler.submit(0, "update", k1, [11, 1])
    cl.scheduler.submit(1, "insert", k2, [20, 1])
    return _setup(cl, [k1, k2])


def _scope_lost_ack(device=None) -> ScopeSetup:
    cl = _mk_cluster(_small_cfg(), num_clients=2, device=device)
    k1, k2 = colliding_keys(cl.cfg.index_buckets, 2)
    cl.scheduler.submit(0, "insert", k1, [10, 1])
    cl.scheduler.submit(1, "insert", k2, [20, 1])
    return _setup(cl, [k1, k2])


def _scope_crash(device=None) -> ScopeSetup:
    cl = _mk_cluster(_small_cfg(), num_clients=2, device=device)
    cl.scheduler.submit(0, "insert", 1, [10, 1])
    cl.scheduler.submit(1, "insert", 1, [20, 1])
    # unconditionally enabled: the event reaches the *initial* execution
    # (at its tail), and event-vs-verb conflicts then walk it backwards to
    # every verb boundary — systematic crash-point enumeration
    cl.scheduler.arm_event("crash_client:1", lambda sc: sc.crash_client(1),
                           once=True)
    return _setup(cl, [1])


def _scope_stale_epoch(device=None) -> ScopeSetup:
    cl = _mk_cluster(_small_cfg(num_mns=2, replication=2, regions_per_mn=2),
                     num_clients=1, device=device)
    cl.scheduler.submit(0, "insert", 1, [10, 1])
    cl.scheduler.submit(0, "update", 1, [11, 1])
    cl.scheduler.arm_event("crash_mn:1", lambda sc: sc.crash_mn(1),
                           once=True)
    return _setup(cl, [1])


def _scope_cutover(device=None) -> ScopeSetup:
    # r=3 so the round's backup-CAS evidence can SPLIT: one backup CAS
    # lands, the membership bump bounces the other -> fail_query sees
    # backups [v_new, 0], its majority tie-break decides "not applied,
    # retry" while the evidence sits on backup 1 — which the cutover's
    # Alg-3 repair then adopts into every replica.  The retry re-reads
    # its own half-installed value as v_old: the seed-7 shape.
    cl = _mk_cluster(_small_cfg(num_mns=3, replication=3, regions_per_mn=2),
                     num_clients=1, device=device)
    cl.scheduler.submit(0, "insert", 1, [10, 1])
    cl.migrator.chunk_words = cl.cfg.region_words // 2   # 2-fire copy window
    # TWO separately-placed boundaries: the add_mn membership bump
    # (bounces a mid-round verb -> master arbitration can answer RETRY
    # off the unrepaired primary) and the later cutover commit (whose
    # repair spreads the backup-CAS evidence) — so scale-out itself is
    # an enumerated event, and the migration rides the migrate event
    cl.arm_migration_event()         # cutover boundary = enumerated choice
    cl.scheduler.arm_event("add_mn", lambda sc: cl.add_mn(wait=False),
                           once=True)
    return _setup(cl, [1])


def _owned_primary_mn(sc, cid: int):
    """The MN holding replica 0 of the first data region whose BAT records
    a block owned by ``cid`` (None until the client has allocated).  Each
    BAT is read with one host copy."""
    pool = sc.pool
    for g in pool.data_regions:
        mem = pool.mns[pool.primary_mn(g)].regions.get(g)
        if mem is None:
            continue
        if (to_u64(mem[:pool.cfg.blocks_per_region]) == cid + 1).any():
            return pool.primary_mn(g)
    return None


def _scope_loser_reset(device=None) -> ScopeSetup:
    # the storm seeds-8/15 shape, minimized: client 1 dies mid-insert
    # with its KV object landed on the primary replica only (the crash
    # drops the backup-write lane), §5.3 recovery REDOES the logged op —
    # installing the index slot and committing the log off the one good
    # copy — and then the MN holding that copy dies too.  Alg-3 re-homes
    # the region onto the surviving (all-zero at the object) replica:
    # the slot now references garbage, which the heap audit reports as a
    # slot surviving a loser reset.  master.UNSAFE_REDO_NO_CONVERGE
    # re-opens the hole; the fix converges the object replicas before
    # the redo makes the object reachable.
    cl = _mk_cluster(_small_cfg(num_mns=2, replication=2, regions_per_mn=2),
                     num_clients=2, device=device)
    k1, k2 = colliding_keys(cl.cfg.index_buckets, 2)
    cl.scheduler.submit(0, "insert", k1, [10, 1])
    cl.scheduler.submit(1, "insert", k2, [20, 1])
    cl.scheduler.arm_event("crash_client:1", lambda sc: sc.crash_client(1),
                           once=True)
    cl.scheduler.arm_event(
        "recover_client:1", lambda sc: cl.recover_client(1),
        enabled=lambda sc: cl.clients[1].crashed, once=True)
    # crash the MN holding the primary copy of the crashed client's data
    # (resolved per-state: placement is deterministic but allocation-time)
    cl.scheduler.arm_event(
        "crash_mn_primary", lambda sc: sc.crash_mn(_owned_primary_mn(sc, 1)),
        enabled=lambda sc: (cl.clients[1].crashed
                            and _owned_primary_mn(sc, 1) is not None),
        once=True)
    return _setup(cl, [k1, k2])


SCOPES: Dict[str, Scope] = {s.name: s for s in (
    Scope("insert_race", "2 clients insert the same key (1 MN, r=1) — the "
          "DPOR reduction benchmark scope", _scope_insert_race),
    Scope("no_fault", "2 clients, 3 ops over 2 bucket-colliding keys; no "
          "events armed", _scope_no_fault),
    Scope("lost_ack", "2 clients insert bucket-colliding keys; the "
          "empty-slot-CAS lost-ack scope (client.UNSAFE_ACK_LOST_EMPTY_CAS)",
          _scope_lost_ack),
    Scope("crash", "insert race plus a client-crash boundary event at every "
          "verb boundary", _scope_crash),
    Scope("stale_epoch", "1 client, 2 MNs r=2, MN-crash + detection events; "
          "the stale-epoch scope (sim.UNSAFE_EXEC_STALE_EPOCH)",
          _scope_stale_epoch),
    Scope("cutover", "1 client upserting across a live add_mn index "
          "migration; the churn-cutover acked-write-loss scope "
          "(client.UNSAFE_FREE_OWN_ON_RETRY)", _scope_cutover),
    Scope("loser_reset", "2 clients over colliding keys; client 1 crashes "
          "mid-insert, is recovered (§5.3 redo), then the MN holding its "
          "object's primary copy crashes — the storm seeds-8/15 torn-redo "
          "scope (master.UNSAFE_REDO_NO_CONVERGE)", _scope_loser_reset),
)}


# --------------------------------------------------------------- state hash
def _hash_bytes(parts: List[bytes]) -> int:
    return int.from_bytes(
        hashlib.blake2b(b"\x00".join(parts), digest_size=16).digest(),
        "little")


def state_hash(cl: FuseeCluster) -> int:
    """Digest of everything the continuation of a run can depend on:
    pool bytes (index words, BAT, bitmaps, objects, embedded logs — log
    heads live in pool words), placement + epoch, migration progress,
    scheduler queue contents, per-client delivery digests, armed events,
    and completed-op results.  Tick counters are deliberately excluded:
    two schedules reaching the same state at different ticks are the
    same state.

    The same bytes as the JAX package's digest on the same state: region
    words are hashed as unsigned little-endian words, sliced on the host
    from one copy of the slab (each ``regions[g]`` is a view of one slab
    cell)."""
    pool, sched = cl.pool, cl.scheduler
    slab = to_u64(pool.slab.buf)
    rw = pool.slab.region_words
    parts: List[bytes] = [int(pool.epoch).to_bytes(8, "little")]
    for mn in pool.mns:
        parts.append(b"M%d:%d:%d" % (mn.mid, mn.alive, mn.retired))
        for g in sorted(mn.regions):
            cell = pool.slab.cells[(mn.mid, g)]
            parts.append(b"g%d" % g)
            parts.append(slab[cell * rw:(cell + 1) * rw].tobytes())
        parts.append(repr(sorted(mn.alloc_cursor.items())).encode())
    parts.append(repr(sorted((g, tuple(r))
                             for g, r in pool.placement.items())).encode())
    parts.append(repr(sorted(pool.migrations)).encode())
    parts.append(repr(cl.migrator.status()).encode())
    for cid in sorted(sched.pipes):
        pipe = sched.pipes[cid]
        parts.append(b"c%d" % cid)
        parts.append(
            sched.client_digest.get(cid, 0).to_bytes(16, "little"))
        for op_id in sorted(pipe.runs):
            run = pipe.runs[op_id]
            parts.append(b"r%d:%d:%s:%d" % (op_id, run.phase_no,
                                            run.phase_label.encode(),
                                            run.pending))
        for mn_id in sorted(pipe.qp):
            for run, idx, v in pipe.qp[mn_id]:
                parts.append(b"q%d:%d:%d:%s:%d:%d:%d:%d" % (
                    mn_id, run.record.op_id, idx, v.kind.encode(),
                    v.region, v.replica, int(v.off), v.epoch))
        for run in pipe.master_q:
            call = run.master_call
            parts.append(b"mc%d:%s" % (run.record.op_id,
                                       repr((call.kind if call else None,
                                             call.payload if call else None))
                                       .encode()))
    for c in cl.clients.values():
        parts.append(b"ce%d:%d:%d" % (c.cid, c.epoch, c.crashed))
    parts.append(repr(sorted(sched._events)).encode())
    parts.append(b"det%d" % (sched._mn_detect_at is not None))
    for rec in sched.history:
        if rec.result is not None:
            parts.append(b"h%d:%s:%s" % (
                rec.op_id, str(rec.result.status).encode(),
                repr(rec.result.value).encode()))
    return _hash_bytes(parts)


# --------------------------------------------------------------- footprints
# a footprint is a list of (region, lo, hi, is_write) word intervals; None
# means "conflicts with everything" (boundary events, alloc/free verbs)
Footprint = Optional[List[Tuple[int, int, int, bool]]]


def _footprint_from(tracer, n0: int, n1: int) -> List:
    fp = []
    buf = tracer.buf
    cap = tracer.capacity
    for i in range(n0, n1):
        j = i % cap
        off, n = int(buf["off"][j]), max(1, int(buf["n"][j]))
        fp.append((int(buf["region"][j]), off, off + n,
                   int(buf["verb"][j]) != READ))
    return fp


def _conflict(a: Footprint, b: Footprint) -> bool:
    if a is None or b is None:
        return True
    for ra, lo_a, hi_a, wa in a:
        for rb, lo_b, hi_b, wb in b:
            if ra == rb and (wa or wb) and lo_a < hi_b and lo_b < hi_a:
                return True
    return False


def _dependent(ca: Choice, fa: Footprint, cb: Choice, fb: Footprint) -> bool:
    """Dependence relation shared by the race scan and the sleep sets —
    the two MUST agree or sleep pruning can starve a scheduled backtrack.
    Same-cid master-vs-lane pairs are order-forced (master-call priority)
    and therefore dependent regardless of footprints."""
    forced = (ca.kind != "event" and cb.kind != "event"
              and ca.cid == cb.cid and "master" in (ca.kind, cb.kind))
    return forced or _conflict(fa, fb)


def _proc_of(ch: Choice) -> str:
    """DPOR process id: a unit whose transitions are totally ordered.

    A client's QP lanes are INDEPENDENT FIFO streams (a doorbell batch
    fans out per MN), so each (cid, mn) lane is its own process — only
    same-lane verbs are program-ordered, and a membership bump CAN land
    between two lanes of one phase (the seed-7 shape needs exactly that
    reorder).  Master-call dispatch is one sequenced stream per client;
    each armed event is a singleton process."""
    if ch.kind == "event":
        return f"e:{ch.name}"
    if ch.kind == "master":
        return f"m:{ch.cid}"
    return f"c:{ch.cid}:{ch.mn}"


# --------------------------------------------------------------- invariants
@dataclass
class Violation:
    kind: str                          # linearizability | acked_write_lost |
    detail: str                        # race:<rule> | heap_audit | exception
    schedule: Tuple[Choice, ...]       # full schedule that reached it
    minimized: Optional[Tuple[Choice, ...]] = None

    def __str__(self) -> str:
        sched = self.minimized if self.minimized is not None \
            else self.schedule
        return (f"{self.kind}: {self.detail}\n  schedule "
                f"({len(sched)} choice points):\n" +
                "\n".join(f"    {i:3d}. {c}" for i, c in enumerate(sched)))


def _lin_with_crashes(hops: List[HOp], crashed: List[HOp]) -> bool:
    """A crashed write may or may not have taken effect; linearizable iff
    some landed-subset makes the definite history linearizable."""
    crashed = crashed[:_MAX_CRASHED_SUBSET]
    for mask in range(1 << len(crashed)):
        trial = list(hops)
        for i, h in enumerate(crashed):
            if mask >> i & 1:
                trial.append(h)
        if check_linearizable(trial):
            return True
    return False


def check_invariants(setup: ScopeSetup) -> List[Violation]:
    """Run the full contract on a drained (maximal) state.  Returns bare
    violations; the caller attaches schedules."""
    cl, keys, tracer = setup.cluster, setup.keys, setup.tracer
    out: List[Violation] = []
    sched = cl.scheduler
    if tracer.dropped:
        out.append(Violation("exception",
                             f"tracer ring wrapped ({tracer.dropped} "
                             "dropped) — raise capacity", ()))

    # final-read probes: one search per key from a live client makes acked
    # losses visible to the linearizability check below
    probe_cids = [c.cid for c in cl.clients.values() if not c.crashed]
    finals: Dict[int, Optional[tuple]] = {}
    if probe_cids:
        pc = min(probe_cids)
        for k in keys:
            rec = sched.submit(pc, "search", k)
            while sched.eligible(pc):
                fired = False
                for ch in sched.choices():
                    if ch.kind != "event":
                        sched.fire(ch)
                        fired = True
                        break
                if not fired:
                    break
            res = rec.result
            finals[k] = (tuple(res.value)
                         if res is not None and res.value is not None
                         else None)

    for k in keys:
        hops = records_to_hops(sched.history, k)
        crashed = [HOp(op_id=r.op_id, kind=r.kind, inv=r.inv_tick,
                       resp=_FAR_FUTURE, wrote=tuple(r.value),
                       read=None, status="OK")
                   for r in sched.history
                   if r.key == k and r.result is not None
                   and r.result.status not in ("OK", "NOT_FOUND")
                   and r.kind in ("insert", "update") and r.value is not None]
        if not _lin_with_crashes(hops, crashed):
            out.append(Violation(
                "linearizability",
                f"key {k}: history of {len(hops)} ops "
                f"(+{len(crashed)} crashed writes) not linearizable; "
                f"final read = {finals.get(k)}", ()))
            continue
        # direct acked-write-loss statement (subsumed by linearizability
        # with the probe appended, but reported with a sharper kind)
        acked = [tuple(r.value) for r in sched.history
                 if r.key == k and r.kind in ("insert", "update")
                 and r.result is not None and r.result.status == "OK"]
        maybe = acked + [tuple(h.wrote) for h in crashed]
        deletes = any(r.key == k and r.kind == "delete"
                      and r.result is not None
                      and r.result.status not in ("NOT_FOUND",)
                      for r in sched.history)
        fin = finals.get(k)
        if fin is not None and list(fin) not in [list(v) for v in maybe]:
            out.append(Violation(
                "acked_write_lost",
                f"key {k}: final value {fin} was never written "
                f"(acked {acked})", ()))
        elif fin is None and acked and not deletes and not crashed:
            out.append(Violation(
                "acked_write_lost",
                f"key {k}: {len(acked)} acked writes but the key reads "
                "ABSENT with no delete in history", ()))

    for f in races.detect(tracer, scheduler=sched):
        out.append(Violation(f"race:{f.rule}", f.detail, ()))
    rep = heapcheck.audit(cl)
    if not rep.ok:
        out.append(Violation("heap_audit", "; ".join(rep.errors[:4]), ()))
    return out


# ----------------------------------------------------------------- explorer
@dataclass
class _Node:
    """One state on the current DFS path + the transition taken from it."""
    enabled: Tuple[Choice, ...]
    chosen: Choice
    proc: str
    footprint: Footprint
    hash_after: int
    done: Set[Choice] = field(default_factory=set)
    backtrack: Set[Choice] = field(default_factory=set)
    # happens-before bookkeeping (filled by _update_backtracks): this
    # transition's index within its proc (1-based) and its vector clock —
    # proc -> highest pidx of that proc that happens-before this node
    pidx: int = 0
    vc: Dict[str, int] = field(default_factory=dict)
    # sleep-set bookkeeping: `sleep` is the set in force ON ARRIVAL at
    # this state (choice -> the footprint it had when put to sleep —
    # still valid because only dependent transitions wake it, and a
    # lane's head verb cannot change while the lane is asleep);
    # `slept` records each fully-explored branch choice with its
    # footprint, so later branches from this node put it to sleep
    sleep: Dict[Choice, Footprint] = field(default_factory=dict)
    slept: Dict[Choice, Footprint] = field(default_factory=dict)


@dataclass
class ExploreResult:
    scope: str
    naive: bool
    states: int = 0                    # distinct states visited
    executions: int = 0                # maximal (or cut) executions run
    transitions: int = 0               # newly recorded transitions
    replay_fires: int = 0              # prefix re-execution transitions
    dedup_cuts: int = 0
    sleep_blocks: int = 0              # executions pruned by sleep sets
    complete: bool = True              # budget not exhausted
    violations: List[Violation] = field(default_factory=list)
    visit_digest: str = ""             # order-sensitive digest of new states
    wall_s: float = 0.0

    def summary(self) -> str:
        v = (f"{len(self.violations)} VIOLATION(S): "
             + ", ".join(sorted({x.kind for x in self.violations}))
             if self.violations else "no violations")
        return (f"[{self.scope}{' naive' if self.naive else ''}] "
                f"{self.states} states, {self.executions} executions, "
                f"{self.transitions} transitions "
                f"({self.dedup_cuts} dedup cuts, {self.sleep_blocks} sleep "
                f"blocks, {self.replay_fires} replay fires) "
                f"in {self.wall_s:.2f}s — "
                f"{'complete' if self.complete else 'budget-capped'}; {v}")


class Explorer:
    """DFS + DPOR + state-hash dedup over one scope (see module doc)."""

    def __init__(self, scope, *, flags: Optional[Dict[str, bool]] = None,
                 naive: bool = False, max_states: int = 200_000,
                 max_depth: int = 3000, stop_on_violation: bool = True,
                 device=None):
        self.scope = SCOPES[scope] if isinstance(scope, str) else scope
        self.device = resolve_device(device)   # every execution's cluster
        self.flags = dict(flags or {})
        self.naive = naive
        self.max_states = max_states
        self.max_depth = max_depth
        self.stop_on_violation = stop_on_violation
        self.visited: Set[int] = set()
        self._visit_hash = hashlib.blake2b(digest_size=16)
        self.result = ExploreResult(scope=self.scope.name, naive=naive)

    # ------------------------------------------------------------ execution
    def _execute(self, prefix: Sequence[Choice], record_from: int,
                 sleep0: Optional[Dict[Choice, Footprint]] = None):
        """Fire ``prefix`` then extend leftmost to a maximal state.
        Steps >= ``record_from`` are recorded as fresh `_Node`s; the
        prefix below it replays without hashing (its nodes persist on the
        caller's stack).  ``sleep0`` is the sleep set in force at the
        branch state: a sleeping choice leads to a subtree already fully
        explored from an earlier sibling, so it is never fired until a
        dependent transition wakes it; an execution whose every enabled
        choice sleeps is a redundant interleaving and stops early.
        Returns (new_nodes, setup, cut, exc)."""
        setup = self.scope.build(device=self.device)
        cl = setup.cluster
        tracer = setup.tracer
        nodes: List[_Node] = []
        sleep: Dict[Choice, Footprint] = dict(sleep0 or {})
        cut = False
        depth = 0

        def fire_one(ch: Choice, enabled: Tuple[Choice, ...]) -> bool:
            nonlocal cut, sleep
            n0 = tracer.n
            glob = False
            if ch.kind == "event":
                glob = True                      # crash/cutover: reorder
            elif ch.kind == "lane":              # against everything
                q = cl.scheduler.pipes[ch.cid].qp.get(ch.mn)
                if q and q[0][2].kind in ("alloc", "free"):
                    glob = True                  # untraced BAT traffic
            at_state_sleep = dict(sleep)
            if not cl.fire(ch):
                raise RuntimeError(f"schedule replay diverged: {ch} "
                                   f"not enabled at depth {depth}")
            fp = None if glob else _footprint_from(tracer, n0, tracer.n)
            sleep = {c: f for c, f in sleep.items()
                     if not _dependent(c, f, ch, fp)}   # wake dependents
            h = state_hash(cl)
            fresh = h not in self.visited
            if fresh:
                self.visited.add(h)
                self.result.states += 1
                self._visit_hash.update(h.to_bytes(16, "little"))
            nodes.append(_Node(enabled=enabled, chosen=ch,
                               proc=_proc_of(ch), footprint=fp,
                               hash_after=h, done={ch},
                               sleep=at_state_sleep))
            self.result.transitions += 1
            if not fresh and self.naive:
                # naive explores every choice from a state's first visit,
                # so revisits are fully covered and the branch can stop.
                # Under DPOR a cut here would discard the continuation
                # whose race analysis schedules the missing backtracks
                # (the classic DPOR x state-caching unsoundness), so DPOR
                # runs every execution to a maximal state and uses the
                # visited set for metrics only.
                self.result.dedup_cuts += 1
                cut = True
            return not cut

        exc: Optional[str] = None
        try:
            for i, ch in enumerate(prefix):
                if i < record_from:
                    if not cl.fire(ch):
                        raise RuntimeError(f"schedule replay diverged: {ch} "
                                           f"not enabled at depth {i}")
                    self.result.replay_fires += 1
                    depth += 1
                    continue
                fire_one(ch, tuple(cl.choices()))
                depth += 1
            while not cut and depth < self.max_depth:
                cs = tuple(cl.choices())
                if not cs:
                    break
                awake = [c for c in cs if c not in sleep]
                if not awake:
                    # every enabled choice sleeps: any continuation from
                    # here permutes independent transitions of a subtree
                    # an earlier sibling already covered — prune (the
                    # prefix still feeds the race scan; invariants were
                    # checked on the equivalent execution)
                    self.result.sleep_blocks += 1
                    cut = True
                    break
                fire_one(awake[0], cs)
                depth += 1
            if depth >= self.max_depth:
                raise RuntimeError(
                    f"max_depth {self.max_depth} exceeded — livelock or "
                    "scope too large")
        except RuntimeError:
            raise                    # checker errors, not protocol findings
        except Exception as e:       # a schedule CRASHING the sim is itself
            exc = f"{type(e).__name__}: {e}"      # a reportable violation
        self.result.executions += 1
        return nodes, setup, cut, exc

    # ---------------------------------------------------------------- DPOR
    def _update_backtracks(self, stack: List[_Node], new_from: int):
        if self.naive:
            for node in stack[new_from:]:
                node.backtrack |= set(node.enabled)
            return
        # Vector-clock happens-before over lane-granular procs.  HB is
        # generated by program order (same proc) plus every conflicting
        # pair, transitively: firing j merges the clock of each earlier
        # conflicting transition.  A pair (i, j) is a *race* — a reorder
        # the DFS must try — iff it conflicts and i is NOT already
        # ordered before j through j's program predecessor (nj's
        # inherited clock).  Without this, a global-footprint event
        # would re-race with every later transition on every execution
        # and the backtrack sets never converge.  Prefix nodes keep the
        # clocks computed on earlier calls (the prefix is unchanged);
        # only nodes from new_from on are stamped here.
        counters: Dict[str, int] = {}
        last_vc: Dict[str, Dict[str, int]] = {}
        for n in stack[:new_from]:
            counters[n.proc] = n.pidx
            last_vc[n.proc] = n.vc
        for j in range(new_from, len(stack)):
            nj = stack[j]
            vc = dict(last_vc.get(nj.proc, {}))   # program-order inheritance
            raced = False
            for i in range(j - 1, -1, -1):
                ni = stack[i]
                if ni.proc == nj.proc:
                    continue
                if ni.pidx <= vc.get(ni.proc, 0):
                    continue   # already happens-before j (transitively —
                    # the descending scan merges nearer clocks first)
                ci, cj = ni.chosen, nj.chosen
                forced = (ci.kind != "event" and cj.kind != "event"
                          and ci.cid == cj.cid
                          and "master" in (ci.kind, cj.kind))
                # ^ a client's master dispatch is never co-enabled with its
                #   own lanes (master-call priority): order forced, not a race
                if not forced and not _conflict(ni.footprint, nj.footprint):
                    continue
                if not forced and not raced:
                    # the LATEST conflicting, not-yet-ordered transition is
                    # j's race partner (Flanagan-Godefroid): reverse there;
                    # earlier races surface recursively on the reversed
                    # execution.  Racing every proc instead multiplies
                    # executions without widening coverage.
                    raced = True
                    if nj.chosen in ni.enabled:
                        ni.backtrack.add(nj.chosen)
                    elif nj.chosen.kind != "event":
                        # a lane/master choice absent from i's enabled set
                        # was either created after i or hidden by master-
                        # call priority — over-approximate with i's full
                        # enabled set (sound; events are always enabled
                        # while armed, so they never take this path)
                        ni.backtrack |= set(ni.enabled)
                # conflicting or forced-ordered: i happens-before j —
                # merge its clock so earlier coverage checks see it
                for p, c in ni.vc.items():
                    if c > vc.get(p, 0):
                        vc[p] = c
                vc[ni.proc] = ni.pidx
            counters[nj.proc] = counters.get(nj.proc, 0) + 1
            nj.pidx = counters[nj.proc]
            vc[nj.proc] = nj.pidx
            nj.vc = vc
            last_vc[nj.proc] = vc

    # ----------------------------------------------------------------- run
    def run(self) -> ExploreResult:
        t0 = time.perf_counter()
        with _FlagGuard(self.flags):
            self._run_locked()
        self.result.visit_digest = self._visit_hash.hexdigest()
        self.result.wall_s = time.perf_counter() - t0
        return self.result

    def _run_locked(self):
        stack, setup, cut, exc = self._execute([], 0)
        new_from = 0
        while True:
            self._update_backtracks(stack, new_from)
            if exc is not None:
                v = Violation("exception", exc,
                              tuple(n.chosen for n in stack))
                self.result.violations.append(v)
            elif not cut:
                for v in check_invariants(setup):
                    v.schedule = tuple(n.chosen for n in stack)
                    self.result.violations.append(v)
            if self.result.violations and self.stop_on_violation:
                return
            if self.result.states >= self.max_states:
                self.result.complete = False
                return

            def _avail(n: _Node) -> Set[Choice]:
                # a backtrack choice that sleeps at this state is covered
                # by an earlier sibling's subtree — skipping it is the
                # whole point of the sleep set (naive keeps none)
                return n.backtrack - n.done - set(n.sleep)

            while stack and not _avail(stack[-1]):
                stack.pop()
            if not stack:
                return
            node = stack[-1]
            ch = min(_avail(node))
            node.done.add(ch)
            # the branch just abandoned goes to sleep for later siblings
            node.slept[node.chosen] = node.footprint
            sleep0 = dict(node.sleep)
            sleep0.update(node.slept)
            sleep0.pop(ch, None)
            prefix = [n.chosen for n in stack[:-1]] + [ch]
            new_from = len(stack) - 1
            new_nodes, setup, cut, exc = self._execute(
                prefix, new_from, sleep0 if not self.naive else None)
            if new_nodes:
                # the branch state re-recorded as new_nodes[0]: it keeps
                # the accumulated bookkeeping of the node it replaces
                new_nodes[0].done = node.done
                new_nodes[0].backtrack = node.backtrack
                new_nodes[0].sleep = node.sleep
                new_nodes[0].slept = node.slept
            stack = stack[:-1] + new_nodes

    # --------------------------------------------------------- minimization
    def _violates_like(self, schedule: Sequence[Choice],
                       kind: str) -> bool:
        setup = self.scope.build(device=self.device)
        cl = setup.cluster
        try:
            depth = 0
            for ch in schedule:
                if cl.fire(ch):
                    depth += 1
            while depth < self.max_depth:
                cs = cl.choices()
                if not cs:
                    break
                cl.fire(cs[0])
                depth += 1
            if depth >= self.max_depth:
                return False
            found = check_invariants(setup)
        except Exception:
            return kind == "exception"
        return any(v.kind == kind for v in found)

    def minimize(self, violation: Violation) -> Violation:
        """ddmin the schedule to a minimal choice prefix whose leftmost
        continuation still produces a violation of the same kind.  Skipped
        (disabled) choices drop out for free during replay."""
        kind = violation.kind
        with _FlagGuard(self.flags):
            sched = list(violation.schedule)
            # the deterministic tail is free: binary-search the shortest
            # violating prefix first, then ddmin the remainder
            lo, hi = 0, len(sched)
            while lo < hi:
                mid = (lo + hi) // 2
                if self._violates_like(sched[:mid], kind):
                    hi = mid
                else:
                    lo = mid + 1
            sched = sched[:hi]
            n = 2
            while len(sched) >= 2 and n <= len(sched):
                chunk = len(sched) // n
                reduced = False
                for i in range(n):
                    trial = sched[:i * chunk] + sched[(i + 1) * chunk:] \
                        if i < n - 1 else sched[:i * chunk]
                    if trial != sched and self._violates_like(trial, kind):
                        sched, n, reduced = trial, max(n - 1, 2), True
                        break
                if not reduced:
                    if n >= len(sched):
                        break
                    n = min(n * 2, len(sched))
            # final pass: drop single choices
            i = 0
            while i < len(sched):
                trial = sched[:i] + sched[i + 1:]
                if self._violates_like(trial, kind):
                    sched = trial
                else:
                    i += 1
        violation.minimized = tuple(sched)
        return violation


# ------------------------------------------------------------ npz round-trip
_KIND_CODE = {"lane": 0, "master": 1, "event": 2}
_CODE_KIND = {v: k for k, v in _KIND_CODE.items()}


def save_counterexample(path: str, scope_name: str, violation: Violation,
                        flags: Optional[Dict[str, bool]] = None):
    """Pickle-free replayable counterexample: the minimized (or full)
    schedule + the scope + the UNSAFE flags it ran under."""
    sched = violation.minimized if violation.minimized is not None \
        else violation.schedule
    np.savez(path,
             schema=np.int64(1),
             scope=np.array(scope_name, dtype="U64"),
             kind=np.array(violation.kind, dtype="U64"),
             detail=np.array(violation.detail[:512], dtype="U512"),
             ckind=np.array([_KIND_CODE[c.kind] for c in sched], np.int8),
             cid=np.array([c.cid for c in sched], np.int32),
             mn=np.array([c.mn for c in sched], np.int32),
             name=np.array([c.name for c in sched], dtype="U64"),
             flags=np.array([f"{k}={int(v)}"
                             for k, v in _flag_items(flags)], dtype="U96"))


def load_counterexample(path: str):
    z = np.load(path, allow_pickle=False)
    sched = tuple(Choice(kind=_CODE_KIND[int(k)], cid=int(c), mn=int(m),
                         name=str(n))
                  for k, c, m, n in zip(z["ckind"], z["cid"], z["mn"],
                                        z["name"]))
    flags = {}
    for item in z["flags"]:
        k, _, v = str(item).partition("=")
        flags[k] = bool(int(v))
    return (str(z["scope"]), str(z["kind"]), str(z["detail"]), sched, flags)


def replay(path: str, *, out=print, device=None) -> bool:
    """Re-execute a saved counterexample on ``device`` (the card if None);
    True iff the violation (any violation, in fact) reproduces."""
    scope_name, kind, detail, sched, flags = load_counterexample(path)
    out(f"replaying {path}: scope={scope_name} expected={kind}")
    out(f"  recorded detail: {detail}")
    if flags:
        out(f"  flags: {flags}")
    with _FlagGuard(flags):
        setup = SCOPES[scope_name].build(device=resolve_device(device))
        cl = setup.cluster
        for i, ch in enumerate(sched):
            fired = cl.fire(ch)
            out(f"  {i:3d}. {ch}{'' if fired else '  (skipped: disabled)'}")
        steps = 0
        while steps < 10_000:
            cs = cl.choices()
            if not cs:
                break
            cl.fire(cs[0])
            steps += 1
        out(f"  leftmost continuation: {steps} transitions to drain")
        found = check_invariants(setup)
    for v in found:
        out(f"  VIOLATION {v.kind}: {v.detail}")
    if not found:
        out("  no violation reproduced")
    return bool(found)


# -------------------------------------------------------------------- CLI
def explore(scope: str, *, flags=None, naive=False, max_states=200_000,
            max_depth=3000, minimize=True, stop_on_violation=True,
            device=None) -> ExploreResult:
    ex = Explorer(scope, flags=flags, naive=naive, max_states=max_states,
                  max_depth=max_depth, stop_on_violation=stop_on_violation,
                  device=device)
    res = ex.run()
    if minimize:
        for v in res.violations:
            ex.minimize(v)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.explore",
        description="systematic schedule exploration (DPOR model checker)")
    ap.add_argument("--scope", choices=sorted(SCOPES), help="scope to explore")
    ap.add_argument("--list", action="store_true", help="list scopes")
    ap.add_argument("--max-states", type=int, default=200_000)
    ap.add_argument("--max-depth", type=int, default=3000)
    ap.add_argument("--naive", action="store_true",
                    help="disable DPOR (full enumeration modulo dedup)")
    ap.add_argument("--unsafe", action="append", default=[],
                    metavar="MODULE.FLAG",
                    help="enable a test-only UNSAFE_* protocol-hole flag "
                         "(e.g. client.UNSAFE_FREE_OWN_ON_RETRY)")
    ap.add_argument("--out", default=None,
                    help="directory for counterexample .npz artifacts")
    ap.add_argument("--repro", default=None, metavar="FILE.npz",
                    help="replay a saved counterexample instead of exploring")
    ap.add_argument("--device", default=None,
                    help="torch device of the scope's cluster (default: "
                    "cuda; 'cpu' runs without a card)")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(SCOPES):
            print(f"{name:12s} {SCOPES[name].doc}")
        return 0
    if args.repro:
        return 1 if replay(args.repro, device=args.device) else 0
    if not args.scope:
        ap.error("--scope, --repro or --list required")

    flags = {spec: True for spec in args.unsafe}
    res = explore(args.scope, flags=flags, naive=args.naive,
                  max_states=args.max_states, max_depth=args.max_depth,
                  device=args.device)
    print(f"{res.summary()} [device {resolve_device(args.device)}]")
    print(f"  visit digest: {res.visit_digest}")
    for i, v in enumerate(res.violations):
        print(str(v))
        if args.out:
            import os
            os.makedirs(args.out, exist_ok=True)
            suffix = f"-{i}" if len(res.violations) > 1 else ""
            path = os.path.join(args.out, f"{args.scope}{suffix}.npz")
            save_counterexample(path, args.scope, v, flags)
            print(f"  saved counterexample: {path} "
                  "(replay: python -m repro_torch.analysis.explore "
                  f"--repro {path})")
    return 1 if res.violations else 0


if __name__ == "__main__":
    sys.exit(main())
