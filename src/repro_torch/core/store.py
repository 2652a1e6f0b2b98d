"""Cluster surface for the FUSEE store: membership, faults, health.

``FuseeCluster`` wires up the pool + master + scheduler and owns the
cluster lifecycle as a first-class API (the failure counterpart of the
``KVStore`` data path):

* ``cluster.store(cid)`` — the public pipelined ``KVStore`` (core/api.py)
  bound to one client;
* **dynamic membership** — ``add_client()`` / ``remove_client()`` at
  runtime, with lease-epoch propagation (the membership commit of §5.2)
  so every live client observes the new epoch; removed cids surrender
  their meta words and blocks to the master and are reused by later joins;
* **declarative faults** — ``inject(FaultPlan)`` installs a
  ``FaultInjector`` on the scheduler: crash_client / crash_mn /
  recover_client fire at tick- or completed-op boundaries while the
  workload runs.  In-flight futures of a crashed client resolve to the
  typed retriable ``CRASHED`` outcome; MN crashes are detected and
  repaired (Alg. 3) inside the scheduler loop;
* **observability** — ``health()`` returns a ``ClusterHealth`` snapshot:
  per-MN liveness, lease epoch, per-client pipeline depth and cache
  state, and cumulative ``RecoveryStats`` across every recovery the
  cluster performed.

Concurrency/crash tests that need verb-level schedules still drive
``sim.Scheduler`` directly.

Counterpart of the JAX package's ``core/store.py``.  ``FuseeCluster(...,
device=None)`` keeps the whole region slab on ``"cuda"`` and raises where
no GPU is present; pass ``device="cpu"`` to run on the CPU.  Not in this
slice (each raises ``NotImplementedError`` naming its ROADMAP item): the obs
hub's ``metrics`` / ``profile`` / hot-key monitor (A11), and the verb
tracer, race detector and heap auditor (A12).
"""
from __future__ import annotations

from typing import Dict, Optional

from .api import KVStore, SimBackend
from .client import FuseeClient
from .events import CRASHED
from .faults import (ClientCrashed, ClientHealth, ClusterHealth, FaultInjector,
                     FaultPlan, MNHealth, RecoveryStats, SchedulerStalled,
                     accumulate_recovery)
from .heap import META_WORDS_PER_CLIENT, DMConfig, DMPool
from .master import Master
from .migrate import MigrationEngine
from .rng import SimRng
from .sim import Choice, Scheduler, SimTrace


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


class FuseeCluster:
    def __init__(self, cfg: Optional[DMConfig] = None, *, num_clients: int = 4,
                 seed: int = 0, enable_cache: bool = True,
                 cache_threshold: float = 0.5,
                 replication_mode: str = "snapshot",
                 mn_detect_delay: int = 0,
                 device=None):
        self.cfg = cfg or DMConfig()
        self.seed = seed
        # single randomness root: every random decision of the run
        # (scheduler, fault storms, workload generation) derives from
        # named substreams of this SimRng, making the run bit-identically
        # replayable from (seed, config) — see core/rng.py
        self.rng = SimRng(seed)
        self._client_kw = dict(enable_cache=enable_cache,
                               cache_threshold=cache_threshold,
                               replication_mode=replication_mode)
        self.pool = DMPool(self.cfg, num_clients=num_clients, seed=seed,
                           device=device)
        self.device = self.pool.device
        self.master = Master(self.pool)
        self.scheduler = Scheduler(self.pool, self.master, seed=seed,
                                   rng=self.rng,
                                   mn_detect_delay=mn_detect_delay)
        # elastic shard subsystem: the migration engine drives MN
        # scale-out/in; the master arbitrates its cutovers (core/migrate.py)
        self.migrator = MigrationEngine(self.pool, self.master,
                                        self.scheduler)
        self.master.migrator = self.migrator
        self._fleet = None
        self.clients: Dict[int, FuseeClient] = {}
        self._next_cid = 0
        self._free_cids: list = []          # cids of removed clients, reusable
        self.recovery_totals = RecoveryStats()
        self.client_recoveries = 0
        for _ in range(num_clients):
            self._spawn_client()

    # --------------------------------------------------------------- stores
    def store(self, cid: int = 0, *, max_inflight: int = 16) -> KVStore:
        """The unified pipelined store API over client ``cid``."""
        client = self.clients.get(cid)
        if client is None:
            raise ClientCrashed(cid, "removed" if cid in self.scheduler.removed
                                else "unknown")
        return KVStore(SimBackend(self.scheduler, client,
                                  max_inflight=max_inflight))

    # ----------------------------------------------------------- membership
    def _spawn_client(self, **overrides) -> int:
        # reuse cids surrendered by remove_client (their meta words were
        # scrubbed and their blocks disowned), so add/remove churn never
        # exhausts the meta region
        if self._free_cids:
            cid = self._free_cids.pop(0)
        else:
            cid = self._next_cid
            self._next_cid += 1
        if (cid + 1) * META_WORDS_PER_CLIENT > self.cfg.region_words:
            raise ValueError(
                f"meta region full: cid {cid} needs "
                f"{(cid + 1) * META_WORDS_PER_CLIENT} words, region has "
                f"{self.cfg.region_words} (raise DMConfig.region_words)")
        c = FuseeClient(cid, self.pool, seed=self.seed,
                        **{**self._client_kw, **overrides})
        self.clients[cid] = c
        self.pool.num_clients = max(self.pool.num_clients, cid + 1)
        self.scheduler.add_client(c)
        return cid

    def add_client(self, **overrides) -> int:
        """Join a fresh client at runtime (elasticity, Fig. 21).  Bumps the
        lease epoch and propagates it to every live client; the new cid is
        returned — bind a store with ``cluster.store(cid)``.  Per-client
        keyword overrides (``enable_cache`` etc.) default to the cluster's
        construction settings."""
        cid = self._spawn_client(**overrides)
        self._bump_epoch()
        return cid

    def remove_client(self, cid: int, *, drain: bool = True):
        """Leave gracefully: drain the client's in-flight pipeline, then
        deregister it and bump the lease epoch.  Subsequent submits (or
        ``store(cid)`` bindings) raise the typed ``ClientCrashed`` with
        reason ``'removed'``."""
        client = self.clients.get(cid)
        if client is None:
            raise ClientCrashed(cid, "removed" if cid in self.scheduler.removed
                                else "unknown")
        if drain and not client.crashed:
            # round-robin the WHOLE cluster: an in-flight op of this client
            # may legally wait on another client's progress (e.g. a SNAPSHOT
            # loser polling for the winner's commit)
            guard = 0
            while self.scheduler.inflight(cid):
                progressed = False
                for ecid in self.scheduler.eligible_cids():
                    # rotate the lane pick: no QP starves behind a retry
                    # loop flooding another lane (see run_round_robin)
                    progressed |= self.scheduler.step(ecid, pick=guard)
                if not progressed or (guard := guard + 1) > 10**6:
                    raise SchedulerStalled(
                        f"client {cid}: could not drain before removal")
        self.scheduler.remove_client(cid)
        self.master.release_client(cid)
        self.clients.pop(cid)
        self._free_cids.append(cid)
        self._bump_epoch()

    def _bump_epoch(self):
        """Commit a lease-epoch bump to every live client — the same
        membership commit the master performs after MN recovery (§5.2)."""
        self.pool.epoch += 1
        for c in self.clients.values():
            if not c.crashed:
                c.epoch = self.pool.epoch

    # ------------------------------------------------------- MN elasticity
    def add_mn(self, *, wait: bool = True) -> int:
        """Join a fresh memory node at runtime (online scale-out): the
        node commits to the membership ring, receives fresh data regions,
        and index shards are re-homed onto the grown ring by live
        migration — bulk copy + dual-write window + epoch-bump cutover
        (core/migrate.py).  With ``wait=True`` (and no concurrent
        workload) the call drives the migrations to completion; with
        ``wait=False`` they ride the workload's own scheduler/fleet ticks.
        Returns the new MN id."""
        mid = self.migrator.add_mn()
        if wait:
            self.migrator.drive()
        return mid

    def remove_mn(self, mid: int, *, wait: bool = True):
        """Gracefully drain + retire a memory node (online scale-in).
        Raises the typed ``InsufficientReplicas`` if removal would leave
        fewer members than the replication factor."""
        self.migrator.remove_mn(mid)
        if wait:
            self.migrator.drive()

    def rebalance(self, *, wait: bool = True) -> int:
        """Re-place index shards on the current membership ring; returns
        the number of shard migrations started."""
        n = self.migrator.rebalance()
        if wait:
            self.migrator.drive()
        return n

    # --------------------------------------------------------------- faults
    def crash_mn(self, mid: int):
        """Crash-stop an MN; the scheduler auto-detects and the master
        re-homes its regions (Alg. 3) ``mn_detect_delay`` ticks later."""
        self.scheduler.crash_mn(mid)

    def crash_client(self, cid: int):
        """Crash-stop a client; its in-flight futures resolve ``CRASHED``
        (retriable) and later submits raise ``ClientCrashed``."""
        self.scheduler.crash_client(cid)

    def recover_client(self, cid: int, reassign_to_cid: Optional[int] = None
                       ) -> RecoveryStats:
        """§5.3 recovery of a crashed client from its embedded operation
        logs; stats also accumulate into ``health().recovery``."""
        target = (self.clients[reassign_to_cid]
                  if reassign_to_cid is not None else None)
        st = self.master.recover_client(cid, reassign_to=target)
        accumulate_recovery(self.recovery_totals, st)
        self.client_recoveries += 1
        return st

    def inject(self, plan: FaultPlan) -> FaultInjector:
        """Install a declarative fault schedule on the scheduler loop."""
        injector = FaultInjector(self, plan)
        self.scheduler.add_tick_hook(injector.poll)
        return injector

    # -------------------------------------------------------------- driving
    def drain(self):
        """Drive every in-flight op of every live client to completion."""
        self.scheduler.run_round_robin()

    def fleet(self):
        """The (memoized) fleet engine over this cluster's scheduler: one
        tick advances every client's in-flight op-phases as batched array
        operations — the ≥1024-concurrent-client driving mode.  See
        core/fleet.py."""
        from .fleet import FleetEngine            # local: avoid import cycle
        if self._fleet is None:
            self._fleet = FleetEngine(self.scheduler)
        return self._fleet

    # ------------------------------------------------------- choice points
    def choices(self):
        """The enabled scheduler transitions at the current state — the
        model checker's enumeration surface (see sim.Scheduler.choices)."""
        return self.scheduler.choices()

    def fire(self, ch: Choice) -> bool:
        """Execute one enabled transition (see sim.Scheduler.fire)."""
        return self.scheduler.fire(ch)

    # --------------------------------------------------------------- replay
    def trace(self) -> SimTrace:
        """Schedule-replay hook: the (cid, pick) decisions taken so far by
        step-mode driving.  Feed to ``replay`` on a fresh same-(seed,
        config) cluster given the same submission sequence to reproduce
        the run bit-identically.  Fleet-mode ticks are schedule-free
        (deterministic from the seed alone) and contribute no decisions."""
        return self.scheduler.trace()

    def replay(self, trace: SimTrace, *, start: int = 0):
        """Re-execute a recorded schedule verbatim (see ``trace``)."""
        self.scheduler.run_trace(trace, start=start)

    # ---------------------------------------------- sanitizers and telemetry
    def attach_tracer(self, capacity: int = 1 << 16):
        """Verb tracer over the pool."""
        _not_ported("the verb tracer", "A12")

    def race_findings(self, rules=None, on_truncated: str = "warn"):
        """Happens-before race pass over traced verbs."""
        _not_ported("the race detector", "A12")

    def heap_audit(self):
        """Post-drain DM heap/epoch sanitizer."""
        _not_ported("the heap auditor", "A12")

    def metrics(self) -> Dict:
        """Registry snapshot with latency percentiles from the obs hub."""
        _not_ported("the obs hub (metrics)", "A11")

    def profile(self, *, include_bg: bool = False) -> Dict:
        """Causal op profile."""
        _not_ported("the causal profiler", "A11")

    # ---------------------------------------------------------------- health
    def health(self) -> ClusterHealth:
        """Cluster observability snapshot: MN liveness, lease epoch,
        per-client pipeline depth / cache stats, cumulative recovery."""
        sched = self.scheduler
        done_by_cid: Dict[int, int] = {}
        crashed_by_cid: Dict[int, int] = {}
        for r in sched.history:
            if r.result is None:
                continue
            if r.result.status == CRASHED:
                crashed_by_cid[r.cid] = crashed_by_cid.get(r.cid, 0) + 1
            else:
                done_by_cid[r.cid] = done_by_cid.get(r.cid, 0) + 1
        clients = [
            ClientHealth(cid=cid, status="crashed" if c.crashed else "live",
                         epoch=c.epoch, inflight=sched.inflight(cid),
                         cache_entries=len(c.cache),
                         completed_ops=done_by_cid.get(cid, 0),
                         crashed_ops=crashed_by_cid.get(cid, 0))
            for cid, c in sorted(self.clients.items())
        ] + [
            ClientHealth(cid=cid, status="removed", epoch=-1, inflight=0,
                         cache_entries=0,
                         completed_ops=done_by_cid.get(cid, 0),
                         crashed_ops=crashed_by_cid.get(cid, 0))
            for cid in sorted(sched.removed)
        ]
        mns = [MNHealth(mid=m.mid, alive=m.alive,
                        primary_regions=sum(
                            reps[0] == m.mid
                            for reps in self.pool.placement.values()),
                        hosted_regions=len(m.regions),
                        bytes_served=int(self.pool.mn_bytes[m.mid]),
                        retired=m.retired)
               for m in self.pool.mns]
        return ClusterHealth(epoch=self.pool.epoch, tick=sched.tick,
                             mns=mns, clients=clients,
                             recovery=self.recovery_totals,
                             client_recoveries=self.client_recoveries,
                             mn_recoveries=sched.mn_recoveries,
                             crashed_ops=sched.crashed_ops)
