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
  cluster performed; ``metrics()`` the registry snapshot of the obs hub
  (``repro_torch.obs``), attached at construction; ``attach_tracer()``
  and ``profile()`` the verb tracer and the causal RTT profile.

Concurrency/crash tests that need verb-level schedules still drive
``sim.Scheduler`` directly.

Counterpart of the JAX package's ``core/store.py``.  ``FuseeCluster(...,
device=None)`` keeps the whole region slab on ``"cuda"`` and raises where
no GPU is present; pass ``device="cpu"`` to run on the CPU.  The obs hub
and the verb tracer are host numpy and read no device tensor;
``race_findings()`` runs on the tracer's host ring, and ``heap_audit()``
reads each region replica it needs with one host copy.
"""
from __future__ import annotations

from typing import Dict, Optional

from .api import KINDS, KVStore, SimBackend
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
from ..configs.fusee_paper import FuseePaperConfig
from ..obs.flight import ClusterObs


class FuseeCluster:
    def __init__(self, cfg: Optional[DMConfig] = None, *, num_clients: int = 4,
                 seed: int = 0, enable_cache: bool = True,
                 cache_threshold: float = 0.5,
                 replication_mode: str = "snapshot",
                 mn_detect_delay: int = 0,
                 obs_dump_dir: Optional[str] = None,
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
        # observability hub (repro_torch.obs): op-level flight recorder,
        # latency histograms, per-MN load series, heat sketch — attached to
        # the hot-path hook points by default; detach_obs() restores the
        # structurally-zero-cost path (one is-None test per hook site).
        # The cap-model link rate comes from the paper config: one tick is
        # one verb RTT, so link_gbps/8 * rtt_us of bytes move per tick.
        pc = FuseePaperConfig()
        self.obs = ClusterObs(
            self.scheduler, self.pool, kinds=KINDS + ("search_batch",),
            link_bytes_per_tick=pc.link_gbps * 1e9 / 8 * pc.rtt_us * 1e-6,
            dump_dir=obs_dump_dir)
        self.attach_obs()
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

    def _master_trace_ctx(self):
        """Attribute the upcoming pool traffic to the master in the verb
        trace: direct API calls (recover_client, add/remove_mn, rebalance)
        run outside a scheduler tick, so the tracer context may still hold
        the last-stepped client's identity."""
        tr = self.pool._tracer
        if tr is not None:
            tr.set_master_ctx(self.scheduler.tick)

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
        self._master_trace_ctx()
        mid = self.migrator.add_mn()
        if wait:
            self.migrator.drive()
        return mid

    def remove_mn(self, mid: int, *, wait: bool = True):
        """Gracefully drain + retire a memory node (online scale-in).
        Raises the typed ``InsufficientReplicas`` if removal would leave
        fewer members than the replication factor."""
        self._master_trace_ctx()
        self.migrator.remove_mn(mid)
        if wait:
            self.migrator.drive()

    def rebalance(self, *, wait: bool = True) -> int:
        """Re-place index shards on the current membership ring; returns
        the number of shard migrations started."""
        self._master_trace_ctx()
        n = self.migrator.rebalance()
        if wait:
            self.migrator.drive()
        return n

    # --------------------------------------------------------------- faults
    def crash_mn(self, mid: int):
        """Crash-stop an MN; the scheduler auto-detects and the master
        re-homes its regions (Alg. 3) ``mn_detect_delay`` ticks later."""
        obs = self.scheduler.obs
        if obs is not None:
            obs.fault("crash_mn", mid, self.scheduler.tick)
        self.scheduler.crash_mn(mid)

    def crash_client(self, cid: int):
        """Crash-stop a client; its in-flight futures resolve ``CRASHED``
        (retriable) and later submits raise ``ClientCrashed``."""
        obs = self.scheduler.obs
        if obs is not None:
            obs.fault("crash_client", cid, self.scheduler.tick)
        self.scheduler.crash_client(cid)

    def recover_client(self, cid: int, reassign_to_cid: Optional[int] = None
                       ) -> RecoveryStats:
        """§5.3 recovery of a crashed client from its embedded operation
        logs; stats also accumulate into ``health().recovery``."""
        target = (self.clients[reassign_to_cid]
                  if reassign_to_cid is not None else None)
        self._master_trace_ctx()
        st = self.master.recover_client(cid, reassign_to=target)
        accumulate_recovery(self.recovery_totals, st)
        self.client_recoveries += 1
        obs = self.scheduler.obs
        if obs is not None:
            obs.recovery("client_recovery", self.scheduler.tick, cid=cid,
                         arg=st.redone_ops,
                         rtts=(st.get_metadata_rtts + st.traverse_log_rtts
                               + st.recover_requests_rtts
                               + st.construct_free_list_rtts))
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

    def arm_migration_event(self, name: str = "migrate"):
        """Expose live-migration progress as an enumerable choice point:
        while any migration is active, ``Choice('event', name=...)`` is
        enabled and each firing advances the migration engine one boundary
        (one bulk-copy chunk, or the master-arbitrated cutover commit).
        With this armed, a checker controls exactly when the cutover's
        epoch bump lands relative to every client verb."""
        # detach the auto tick hook: begin_tick runs inside every fired
        # choice, so leaving it hooked would advance the migration (and
        # land the cutover) implicitly, outside the enumerated schedule
        self.migrator.manual = True
        self.scheduler.remove_tick_hook(self.migrator._tick_hook)
        self.migrator._hooked = False
        self.scheduler.arm_event(
            name, lambda s: self.migrator.tick(),
            enabled=lambda s: bool(self.migrator.active), once=False)

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

    # ------------------------------------------------------------ sanitizers
    def attach_tracer(self, capacity: int = 1 << 16):
        """Attach a verb tracer (``repro_torch.analysis``) to this cluster's
        pool and return it.  While attached, every one-sided verb is
        appended to a fixed-capacity host ring, and the fleet engine runs
        the per-kind batch verbs instead of the fused tick (which bypasses
        the wrapped entry points) unless the tracer is paused; ``detach()``
        restores the unwrapped verbs (zero residual cost).  Idempotent:
        returns the existing tracer if one is already attached."""
        from ..analysis.trace import VerbTracer  # local: analysis is opt-in
        if self.pool._tracer is not None:
            return self.pool._tracer
        return VerbTracer(capacity=capacity).attach(self.pool)

    def race_findings(self, rules=None, on_truncated: str = "warn"):
        """Happens-before race pass over the attached tracer's events (see
        ``repro_torch.analysis.races``).  Requires ``attach_tracer`` first.
        ``on_truncated`` governs saturated-ring behavior: "warn" (default)
        emits ``TruncatedTraceWarning``, "fail" raises, "ignore" is
        silent — a wrapped ring can hide both races and their guards."""
        from ..analysis import races             # local: analysis is opt-in
        if self.pool._tracer is None:
            raise ValueError(
                "no tracer attached — call attach_tracer() before running "
                "the race detector")
        findings = races.detect(self.pool._tracer, scheduler=self.scheduler,
                                rules=rules, on_truncated=on_truncated)
        obs = self.scheduler.obs
        if obs is not None and findings:
            obs.dump("race_finding")
        return findings

    def heap_audit(self):
        """Post-drain DM heap/epoch sanitizer (``repro_torch.analysis.heapcheck``):
        index→object reachability, leak/double-free/use-after-free checks,
        placement-ring epoch consistency.  Call after ``drain()``."""
        from ..analysis import heapcheck         # local: analysis is opt-in
        report = heapcheck.audit(self)
        obs = self.scheduler.obs
        if obs is not None and not report.ok:
            obs.dump("heap_audit")
        return report

    # --------------------------------------------------------- observability
    def attach_obs(self) -> ClusterObs:
        """(Re)attach the observability hub to the hot-path hook points
        (scheduler op begin/settle, fleet per-tick sampling, heap heat)."""
        self.scheduler.obs = self.obs
        self.pool._obs = self.obs
        return self.obs

    def detach_obs(self) -> ClusterObs:
        """Detach the hub: every hook site degrades to one attribute load
        + ``is None`` test.  The metrics registry itself stays live —
        fleet / migration counters are plain handle bumps, not hub
        hooks."""
        self.obs.flush()
        self.scheduler.obs = None
        self.pool._obs = None
        return self.obs

    def metrics(self) -> Dict:
        """Registry snapshot plus a latency summary: for every op-latency
        histogram, conservative p50/p99/p999 (bucket upper edges) and the
        sample count.  Deterministic — ``json.dumps`` of this snapshot is
        byte-identical across same-(seed, config, schedule) runs, on any
        device and in either package.  When the hot-key monitor is enabled
        (``enable_hotspot``), a ``"hotspot"`` block (top-k keys, zipf-θ,
        imbalance, regime) rides along — int-valued, so the determinism
        contract is unchanged."""
        snap = self.obs.snapshot()
        reg = self.scheduler.metrics
        pct: Dict[str, Dict] = {}
        for name in snap["histograms"]:
            h = reg.get(name)
            pct[name] = {"count": h.total, "p50": h.percentile(0.50),
                         "p99": h.percentile(0.99),
                         "p999": h.percentile(0.999)}
        snap["percentiles"] = pct
        if self.obs.hotspot is not None:
            snap["hotspot"] = self.obs.hotspot.snapshot()
        return snap

    def enable_hotspot(self, **kw):
        """Turn on the streaming hot-key/skew monitor (obs/hotspot.py):
        space-saving top-k over the heat-touch key stream, online zipf-θ,
        EWMA shard/MN imbalance, and typed ``regime`` flight events on
        threshold crossings.  Opt-in: the default hub carries no monitor.
        Returns the ``HotKeyMonitor``."""
        return self.obs.enable_hotspot(**kw)

    def profile(self, *, include_bg: bool = False) -> Dict:
        """One-call causal profile of everything recorded so far: span
        trees (obs/spans.py) folded into the critical-path RTT-attribution
        report (obs/profile.py).  Requires ``attach_tracer()`` — the
        flight recorder alone has no per-verb rows.  When this cluster
        drives a ``FleetEngine`` the wall-clock tick-phase split rides
        along under ``"tick_phases"``."""
        from ..obs.profile import critical_path_report
        from ..obs.spans import spans_from_cluster
        ss = spans_from_cluster(self)
        report = critical_path_report(ss, include_bg=include_bg)
        report["spans"] = ss
        if self._fleet is not None:
            report["tick_phases"] = self._fleet.tick_phase_profile()
        return report

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
