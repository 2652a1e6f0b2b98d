"""Live migration engine: online MN scale-out/in with shard re-homing.

``FuseeCluster.add_mn`` / ``remove_mn`` / ``rebalance`` land here.  The
engine re-homes regions (index shards, the meta region, and data regions)
shard-at-a-time through a three-stage state machine, DINOMO-style online
reconfiguration grafted onto FUSEE's lease-epoch membership model (§5.2):

1. **window open** — the region enters ``pool.migrations``: a fresh target
   array per destination MN, and from this instant every mutation applied
   to the *primary* replica is mirrored into the targets (the dual-write
   window; heap._mirror).  Placement, routing, and the data path are
   untouched — clients keep operating on the pinned old replica set.
2. **bulk copy** — each scheduler tick copies one chunk of the region from
   the primary into the targets via the pool's batched sweeps (a single
   ``read_batch`` serves every in-flight migration per tick), so a
   thousand-client fleet tick and a migration tick cost the same O(1)
   array calls.  Writes racing the copy are never lost: a chunk already
   copied receives them through the mirror, a chunk not yet copied picks
   them up from the (authoritative) primary when its turn comes.
3. **cutover** — when the copy completes, the *master* commits the move
   atomically at a tick boundary: target arrays are installed, the
   directory re-homes the region (version bump), MNs leaving the replica
   set drop their copy, and the lease epoch is CAS-bumped cluster-wide.
   In-flight verbs stamped with the old epoch FAIL and their ops retry —
   exactly the stale-epoch guard that MN recovery already uses.

Fresh destinations cut over with a staged copy of the primary; replicas
retained across the cutover keep their own arrays.  For index shards the
master runs the Alg-3 slot repair immediately before installing — a
SNAPSHOT round that straddles the cutover has its backup-CAS evidence
only in the old backup arrays, and converging that evidence into every
replica (committing the round's log) before roles change preserves the
"backups are never older than the primary" invariant that both repair
and ``fail_query`` arbitration rely on.  Discarding it instead would let
a *later* repair revert an acknowledged primary CAS.

Crash-during-migration: if any participant (source primary, a target, a
retained survivor) dies before cutover, the migration **aborts** — the
window closes, targets are dropped, nothing was ever installed — and
Alg-3 recovery re-homes the region as usual; the engine re-plans from
the post-recovery ring (``on_membership_change``).  The state machine
therefore never has a half-cut-over region: a region is either entirely
on its old replica set or entirely on its new one.

Determinism: the engine makes no random choices — regions are planned
and copied in sorted order with a fixed chunk size — so migration runs
are bit-identically replayable from ``(seed, config)`` plus the same
membership-call sequence (FaultPlan add_mn/remove_mn events included).

Counterpart of the JAX package's ``core/migrate.py``: staged target copies
are int64 tensors on the pool's device, filled from the batched READ sweep.
The master's Alg-3 recovery re-plans index placement through this engine,
so it is on the MN-recovery path as well as behind add_mn/remove_mn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set

import numpy as np
import torch

from . import layout as L
from .faults import InsufficientReplicas, SchedulerStalled
from .heap import DMPool
from .ring import ring_replicas

__all__ = ["MigrationEngine", "RegionMigration"]

# words bulk-copied per migrating region per scheduler tick; small enough
# that a migration spans many ticks (a real dual-write window under load),
# large enough that a 2^15-word region moves in a handful of sweeps
CHUNK_WORDS = 4096


@dataclass
class RegionMigration:
    """One region mid-flight: state 'copy' until ``copied`` reaches the
    region size, then the master cuts it over."""
    region: int
    source: int                      # primary MN the copy reads from
    new_reps: List[int]
    targets: Dict[int, torch.Tensor]  # destination mid -> staged copy
    dir_version: int                 # directory version at window open
    copied: int = 0

    @property
    def state(self) -> str:
        return "copy"


class MigrationEngine:
    """Plans and drives region migrations over a cluster's scheduler.
    One engine per cluster; installed as a scheduler tick hook while any
    migration or pending MN removal is in flight."""

    def __init__(self, pool: DMPool, master, scheduler, *,
                 chunk_words: int = CHUNK_WORDS):
        self.pool = pool
        self.master = master
        self.sched = scheduler
        self.chunk_words = chunk_words
        self.active: Dict[int, RegionMigration] = {}
        self.removing: Set[int] = set()        # mids draining toward retire
        self._hooked = False
        # manual mode (model checking): migration advances ONLY through an
        # armed scheduler event (store.arm_migration_event), never through
        # the auto tick hook — begin_tick runs inside every fired choice,
        # so the hook would move the cutover boundary outside the
        # checker's enumerated schedule.
        self.manual = False
        # migration counters live in the scheduler's metrics registry
        # under "migrate.<name>"
        self._handles = {
            k: scheduler.metrics.counter("migrate." + k)
            for k in ("migrations", "cutovers", "aborts", "copied_words",
                      "adds", "removes", "retires")}

    # ----------------------------------------------------------- public API
    def add_mn(self) -> int:
        """Join a fresh MN: commit it to the membership ring, grant it
        fresh (empty) data regions, and start re-homing index shards onto
        the grown ring.  Returns the new mid immediately — the shard
        migrations ride subsequent scheduler ticks."""
        pool = self.pool
        mid = pool.add_node()
        pool.add_data_regions(mid)
        self._handles["adds"].value += 1
        obs = self.sched.obs
        if obs is not None:
            obs.fault("add_mn", mid, self.sched.tick)
        # membership commit: new MR visible, stale verbs FAIL and retry
        self.master.commit_membership()
        self._plan_index_rebalance()
        self._ensure_hook()
        return mid

    def remove_mn(self, mid: int):
        """Gracefully drain an MN: every region it hosts is migrated to
        the shrunk ring; once the last one cuts over the node retires.
        Raises the typed ``InsufficientReplicas`` if removal would leave
        fewer members than the replication factor."""
        pool = self.pool
        if mid >= len(pool.mns) or pool.mns[mid].retired \
                or mid not in pool.directory.members:
            raise ValueError(f"MN {mid} is not a removable member")
        if not pool.mns[mid].alive:
            raise ValueError(f"MN {mid} is crashed; Alg-3 recovery (not "
                             "remove_mn) re-homes its regions")
        members_after = [m for m in pool.directory.members if m != mid]
        if len(members_after) < pool.cfg.replication:
            raise InsufficientReplicas(
                f"removing MN {mid} leaves {len(members_after)} members < "
                f"replication factor {pool.cfg.replication}")
        pool.directory.remove_member(mid)
        self.removing.add(mid)
        self._handles["removes"].value += 1
        obs = self.sched.obs
        if obs is not None:
            obs.fault("remove_mn", mid, self.sched.tick)
        # in-flight migrations may still be HEADED for the draining MN
        # (e.g. shard moves planned by a recent add_mn): abort them before
        # re-planning, or their cutovers would install regions onto the
        # node we are emptying and nothing would ever move them off again
        for g in sorted(self.active):
            if mid in self.active[g].new_reps:
                self._abort(g)
        self._plan_index_rebalance()
        self._plan_drain(mid)
        self._ensure_hook()

    def rebalance(self) -> int:
        """Re-place index shards on the current membership ring; returns
        the number of shard migrations started."""
        n = self._plan_index_rebalance()
        self._ensure_hook()
        return n

    def drive(self, max_ticks: int = 1_000_000) -> int:
        """Tick the scheduler until every migration completed and every
        draining MN retired (for callers with no concurrent workload —
        under live traffic the migrations ride the workload's own ticks).
        Returns ticks spent."""
        t = 0
        while self.active or self.removing:
            if t >= max_ticks:
                raise SchedulerStalled(
                    f"migration did not converge after {t} ticks: "
                    f"{sorted(self.active)} active, "
                    f"{sorted(self.removing)} draining")
            self.sched.begin_tick()
            t += 1
        return t

    @property
    def busy(self) -> bool:
        return bool(self.active or self.removing)

    def status(self) -> List[Dict]:
        """Per-migration progress snapshot (health/observability)."""
        total = self.pool.cfg.region_words
        return [{"region": g, "state": m.state, "source": m.source,
                 "new_reps": list(m.new_reps),
                 "copied": m.copied, "total": total}
                for g, m in sorted(self.active.items())]

    # ------------------------------------------------------------- planning
    def _plan_index_rebalance(self) -> int:
        desired = self.pool.desired_index_placement()
        return sum(self._start(g, desired[g])
                   for g in sorted(desired))

    def _plan_drain(self, mid: int):
        """Plan migrations for every non-index region still replicated on
        ``mid`` (data + meta; index shards and the ordered keydir region
        go through the rebalance)."""
        pool = self.pool
        members = pool.directory.members
        for g in sorted(pool.placement):
            reps = pool.placement[g]
            if mid not in reps or g in pool.index_region_set \
                    or g in pool.ordered_region_set:
                continue
            survivors = [m for m in reps if m != mid]
            # full ring order from the region's hash start (one source of
            # truth for the ring math: ring.ring_replicas)
            ring_order = ring_replicas(g, members, len(members))
            fill = [m for m in ring_order if m not in survivors]
            want = min(len(reps), len(members))
            new_reps = (survivors + fill)[:want]
            self._start(g, new_reps)

    def _start(self, region: int, new_reps: List[int]) -> bool:
        pool = self.pool
        cur = pool.placement[region]
        if list(cur) == list(new_reps) or region in self.active:
            return False
        source = cur[0]
        # only destinations not already hosting the region get a staged
        # copy; retained replicas keep their arrays — their backup-CAS
        # evidence for rounds straddling the cutover is converged by the
        # master's pre-cutover Alg-3 slot repair (master.commit_cutover)
        targets = {m: torch.zeros(pool.cfg.region_words, dtype=torch.int64,
                               device=pool.device)
                   for m in new_reps
                   if region not in pool.mns[m].regions}
        mig = RegionMigration(region=region, source=source,
                              new_reps=list(new_reps), targets=targets,
                              dir_version=pool.directory.version(region))
        pool.migrations[region] = mig
        self.active[region] = mig
        self._handles["migrations"].value += 1
        obs = self.sched.obs
        if obs is not None:
            obs.migration("start", region, self.sched.tick)
        return True

    # ------------------------------------------------------------- ticking
    def _ensure_hook(self):
        if not self._hooked and not self.manual:
            self.sched.add_tick_hook(self._tick_hook)
            self._hooked = True

    def _tick_hook(self, sched):
        self.tick()
        if not self.active and not self.removing:
            sched.remove_tick_hook(self._tick_hook)
            self._hooked = False

    def tick(self):
        """One migration tick: a chunk of every in-flight region copied
        with a single batched sweep, cutovers committed for completed
        copies, retires finalized for drained MNs."""
        pool = self.pool
        pending = []
        for g in sorted(self.active):
            mig = self.active[g]
            if pool.placement[g][0] != mig.source \
                    or pool.directory.version(g) != mig.dir_version:
                # the region was re-homed under us (Alg-3 recovery): our
                # copied prefix came from a replaced primary — abort and
                # let on_membership_change re-plan from the new ring
                self._abort(g)
                continue
            if any(not pool.mns[m].alive for m in mig.new_reps) \
                    or not pool.mns[mig.source].alive:
                self._abort(g)
                continue
            if mig.copied < pool.cfg.region_words:
                pending.append(mig)
        if pending:
            n = self.chunk_words
            rows = pool.read_batch([m.region for m in pending],
                                   [0] * len(pending),
                                   [m.copied for m in pending],
                                   [min(n, pool.cfg.region_words - m.copied)
                                    for m in pending])
            for mig, words in zip(pending, rows):
                if words is None:      # source died between checks
                    self._abort(mig.region)
                    continue
                chunk = torch.from_numpy(words.view(np.int64)).to(pool.device)
                for mid, arr in mig.targets.items():
                    arr[mig.copied:mig.copied + len(words)] = chunk
                    pool.mn_bytes[mid] += len(words) * L.WORD
                mig.copied += len(words)
                self._handles["copied_words"].value += len(words)
        for g in sorted(self.active):
            mig = self.active[g]
            if mig.copied >= pool.cfg.region_words:
                self.active.pop(g)
                self.master.commit_cutover(mig)
                self._handles["cutovers"].value += 1
                obs = self.sched.obs
                if obs is not None:
                    obs.migration("cutover", g, self.sched.tick)
        self._finalize_retires()

    def _finalize_retires(self):
        pool = self.pool
        for mid in sorted(self.removing):
            if not pool.mns[mid].alive:     # crashed while draining: the
                self.removing.discard(mid)  # drain became an Alg-3 recovery
                continue
            if pool.mns[mid].regions:
                continue
            pool.retire_node(mid)
            self.removing.discard(mid)
            self._handles["retires"].value += 1
            self.master.commit_membership()

    def _abort(self, region: int):
        self.pool.migrations.pop(region, None)
        self.active.pop(region, None)
        self._handles["aborts"].value += 1
        obs = self.sched.obs
        if obs is not None:
            obs.migration("abort", region, self.sched.tick)

    # ------------------------------------------------------------ recovery
    def abort_for_dead(self, dead: List[int]):
        """Called by the master *before* Alg-3 recovery: any migration
        whose source, targets, or retained survivors include a dead MN is
        abandoned (the window closes; nothing was installed)."""
        dead_set = set(dead)
        for g in sorted(self.active):
            mig = self.active[g]
            involved = {mig.source, *mig.targets, *mig.new_reps,
                        *self.pool.placement[g]}
            if involved & dead_set:
                self._abort(g)

    def on_membership_change(self):
        """Called by the master *after* Alg-3 recovery committed: re-plan
        aborted shard moves and still-draining removals against the
        post-recovery ring."""
        self._plan_index_rebalance()
        for mid in sorted(self.removing):
            if self.pool.mns[mid].alive:
                self._plan_drain(mid)
        if self.active or self.removing:
            self._ensure_hook()
