"""The first-class failure surface of the FUSEE cluster (§5, Alg. 3-4).

FUSEE's distinguishing claim is that *clients* handle metadata corruption
and membership changes under failures; this module makes that machinery a
public API instead of a test backdoor:

* typed errors — ``ClientCrashed`` (submits on a crashed/removed client)
  and ``SchedulerStalled`` (the backend has unresolved ops but the
  scheduler has no runnable work), replacing bare asserts/RuntimeErrors;
* ``CRASHED`` op outcome — in-flight futures of a crashed client resolve
  to a typed *retriable* ``OpResult`` instead of hanging (events.py);
* ``FaultPlan`` / ``FaultInjector`` — declarative fault schedules
  (crash_client / crash_mn / recover_client at tick- or completed-op-count
  boundaries) that drive the scheduler via its tick hooks, replacing the
  ad-hoc crash calls previously scattered across tests and benchmarks;
* ``ClusterHealth`` — the observability snapshot behind
  ``FuseeCluster.health()``: per-MN liveness, lease epoch, per-client
  pipeline depth / cache state, and cumulative ``RecoveryStats``.

Counterpart of the JAX package's ``core/faults.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional, Tuple

from .master import RecoveryStats

if TYPE_CHECKING:                      # pragma: no cover - typing only
    from .sim import Scheduler
    from .store import FuseeCluster


# ------------------------------------------------------------- typed errors
class ClusterError(RuntimeError):
    """Base of every typed failure raised by the cluster surface."""


class ClientCrashed(ClusterError):
    """Submit (or store binding) rejected: the client is crashed, removed,
    or unknown.  Retriable on any live client — the op never entered the
    pipeline."""

    def __init__(self, cid: int, reason: str = "crashed"):
        self.cid = cid
        self.reason = reason
        super().__init__(
            f"client {cid} is {reason}; the op was not submitted "
            f"(resubmit on a live client or add_client() a replacement)")


class SchedulerStalled(ClusterError):
    """The backend holds unresolved ops but the scheduler has no runnable
    work — a wiring bug (e.g. a future detached from its record), never a
    legal protocol state."""


class ProtocolViolation(ClusterError):
    """An internal protocol invariant was broken — a bug in this repo (or
    a test harness misusing an internal surface), never a legal runtime
    state.  The message carries reproducing context (cid / op / region /
    tick) so a failing storm seed can be replayed; the protocol lint
    (repro.analysis.lint, rule L005) requires protocol code to raise this
    instead of bare ``assert``."""


class RegionLost(ClusterError):
    """A region has no live replica left: more than r-1 MNs hosting it
    failed simultaneously, which is outside the paper's §5.1 fault model
    (data loss — recovery cannot proceed)."""

    def __init__(self, region: int, detail: str = ""):
        self.region = region
        super().__init__(
            f"region {region} lost: no live replica remains "
            f"(>= r simultaneous MN failures){' — ' + detail if detail else ''}")


class InsufficientReplicas(ClusterError):
    """``remove_mn`` rejected: draining the node would leave fewer ring
    members than the replication factor, so some region could not keep r
    replicas.  The membership is unchanged — add an MN first."""


class OrderedIndexDisabled(ClusterError):
    """SCAN/RANGE rejected: the cluster was built without the ordered
    keydir (``DMConfig.ordered_index=False``).  Range queries need the
    ordered secondary index (core/ordered.py) — enable it at
    construction; the hash index alone cannot answer them."""

    def __init__(self):
        super().__init__(
            "scan/range require DMConfig(ordered_index=True): the RACE "
            "hash index cannot answer range queries")


# ------------------------------------------------------------- fault plans
_ACTIONS = ("crash_client", "crash_mn", "recover_client",
            "add_mn", "remove_mn")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``action`` on ``target`` when the trigger
    boundary passes.  Exactly one of ``at_tick`` (scheduler tick) or
    ``after_ops`` (cluster-wide completed-op count) must be set."""
    action: str
    target: int
    at_tick: Optional[int] = None
    after_ops: Optional[int] = None
    reassign_to: Optional[int] = None   # recover_client only

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"expected one of {_ACTIONS}")
        if (self.at_tick is None) == (self.after_ops is None):
            raise ValueError("exactly one of at_tick / after_ops required")

    def due(self, sched: "Scheduler") -> bool:
        if self.at_tick is not None:
            return sched.tick >= self.at_tick
        return sched.completed_ops >= self.after_ops


class FaultPlan:
    """Declarative fault schedule; build with the chainable helpers:

        plan = (FaultPlan()
                .crash_mn(2, after_ops=48)
                .crash_client(0, after_ops=56)
                .recover_client(0, reassign_to=1, after_ops=60))
        injector = cluster.inject(plan)

    Events with the same trigger fire in plan order."""

    def __init__(self, events: Optional[List[FaultEvent]] = None):
        self.events: List[FaultEvent] = list(events or [])

    def _add(self, ev: FaultEvent) -> "FaultPlan":
        self.events.append(ev)
        return self

    def crash_client(self, cid: int, *, at_tick: Optional[int] = None,
                     after_ops: Optional[int] = None) -> "FaultPlan":
        return self._add(FaultEvent("crash_client", cid, at_tick=at_tick,
                                    after_ops=after_ops))

    def crash_mn(self, mid: int, *, at_tick: Optional[int] = None,
                 after_ops: Optional[int] = None) -> "FaultPlan":
        return self._add(FaultEvent("crash_mn", mid, at_tick=at_tick,
                                    after_ops=after_ops))

    def recover_client(self, cid: int, *, reassign_to: Optional[int] = None,
                       at_tick: Optional[int] = None,
                       after_ops: Optional[int] = None) -> "FaultPlan":
        return self._add(FaultEvent("recover_client", cid, at_tick=at_tick,
                                    after_ops=after_ops,
                                    reassign_to=reassign_to))

    def add_mn(self, *, at_tick: Optional[int] = None,
               after_ops: Optional[int] = None) -> "FaultPlan":
        """Membership event: join a fresh MN mid-run; shard migrations
        ride the workload's scheduler ticks (core/migrate.py)."""
        return self._add(FaultEvent("add_mn", -1, at_tick=at_tick,
                                    after_ops=after_ops))

    def remove_mn(self, mid: int, *, at_tick: Optional[int] = None,
                  after_ops: Optional[int] = None) -> "FaultPlan":
        """Membership event: gracefully drain + retire an MN mid-run."""
        return self._add(FaultEvent("remove_mn", mid, at_tick=at_tick,
                                    after_ops=after_ops))

    @staticmethod
    def storm(rng, *, clients, mns: int, replication: int = 2,
              n_client_crashes: int = 2, n_mn_crashes: int = 1,
              first_op: int = 8, spacing: int = 10,
              recover_delay: int = 8, n_add_mns: int = 0,
              remove_added: bool = False,
              crash_during_migration: bool = False) -> "FaultPlan":
        """A randomized fault storm, fully determined by ``rng`` (pass a
        ``SimRng`` substream — ``cluster.rng.stream('faults')`` — so the
        storm replays bit-identically from the run seed).

        Crashes ``n_client_crashes`` distinct clients at spaced
        completed-op boundaries, each recovered ``recover_delay`` ops
        later with its log reassigned to a never-crashed survivor; crashes
        up to ``n_mn_crashes`` MNs, capped at ``mns - replication`` so no
        region ever loses all its replicas.  Safety of the caps — not the
        timing — is what makes "no acknowledged write is lost" a fair
        invariant to assert after the storm.

        Membership churn: ``n_add_mns`` joins fresh MNs mid-storm (shard
        migrations ride the workload ticks); ``remove_added`` drains each
        added MN again one spacing later (a full scale-out/scale-in
        cycle across live cutovers); ``crash_during_migration`` crashes
        one extra original MN two ops after the first join — i.e. while
        shard copies are in flight — capped so no region can lose all
        replicas (the post-join member count covers the extra crash)."""
        clients = list(clients)
        n_cc = min(n_client_crashes, max(len(clients) - 1, 0))
        victims = [clients[int(i)] for i in
                   rng.choice(len(clients), size=n_cc, replace=False)]
        survivors = [c for c in clients if c not in victims]
        n_mc = max(0, min(n_mn_crashes, mns - replication))
        mn_victims = [int(m) for m in
                      rng.choice(mns, size=n_mc, replace=False)]
        timeline: List[Tuple[str, int]] = \
            [("client", c) for c in victims] + [("mn", m) for m in mn_victims]
        order = rng.permutation(len(timeline))
        plan = FaultPlan()
        t = first_op
        for i in order:
            kind, target = timeline[int(i)]
            if kind == "client":
                heir = survivors[int(rng.integers(len(survivors)))] \
                    if survivors else None
                plan.crash_client(target, after_ops=t)
                plan.recover_client(target, reassign_to=heir,
                                    after_ops=t + recover_delay)
            else:
                plan.crash_mn(target, after_ops=t)
            t += spacing
        # membership churn rides after the base storm (draws only happen
        # when requested, so churn-free storms keep their seed sequences)
        crashed = set(mn_victims)
        n_removals = n_add_mns if remove_added else 0
        for i in range(n_add_mns):
            plan.add_mn(after_ops=t)
            if crash_during_migration and i == 0:
                cand = [m for m in range(mns) if m not in crashed]
                # one extra crash is safe iff the ring keeps >= replication
                # members after ALL planned churn (adds, this crash, and
                # any later removals of the added MNs)
                if cand and (mns + n_add_mns - len(crashed) - 1
                             - n_removals) >= replication:
                    vm = cand[int(rng.integers(len(cand)))]
                    crashed.add(vm)
                    plan.crash_mn(vm, after_ops=t + 2)
            t += spacing
            if remove_added:
                plan.remove_mn(mns + i, after_ops=t)
                t += spacing
        return plan

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)


class FaultInjector:
    """Binds a ``FaultPlan`` to a cluster: installed as a scheduler tick
    hook, it fires each event (through the public cluster surface, so
    recovery stats accumulate) the first time its boundary passes."""

    def __init__(self, cluster: "FuseeCluster", plan: FaultPlan):
        self.cluster = cluster
        self.pending: List[FaultEvent] = list(plan)
        self.fired: List[Tuple[int, FaultEvent]] = []

    @property
    def done(self) -> bool:
        return not self.pending

    def poll(self, sched: "Scheduler"):
        while True:
            due = next((e for e in self.pending if e.due(sched)), None)
            if due is None:
                if not self.pending:   # plan exhausted: stop polling forever
                    sched.remove_tick_hook(self.poll)
                return
            self.pending.remove(due)
            self._fire(due, sched)

    def _fire(self, ev: FaultEvent, sched: "Scheduler"):
        if ev.action == "crash_client":
            self.cluster.crash_client(ev.target)
        elif ev.action == "crash_mn":
            self.cluster.crash_mn(ev.target)
        elif ev.action == "add_mn":
            self.cluster.add_mn(wait=False)
        elif ev.action == "remove_mn":
            self.cluster.remove_mn(ev.target, wait=False)
        else:
            self.cluster.recover_client(ev.target,
                                        reassign_to_cid=ev.reassign_to)
        self.fired.append((sched.tick, ev))
        obs = sched.obs
        if obs is not None:
            # auto-dump the flight ring once per injected fault class
            # (no-op unless the hub was armed with a dump_dir)
            obs.dump("fault_" + ev.action)


# ------------------------------------------------------------ health views
@dataclass
class MNHealth:
    mid: int
    alive: bool
    primary_regions: int
    hosted_regions: int
    bytes_served: int
    retired: bool = False       # gracefully removed (remove_mn), not crashed


@dataclass
class ClientHealth:
    cid: int
    status: str                 # 'live' | 'crashed' | 'removed'
    epoch: int
    inflight: int               # current pipeline depth
    cache_entries: int
    completed_ops: int
    crashed_ops: int            # ops of this client resolved CRASHED


@dataclass
class ClusterHealth:
    """Snapshot returned by ``FuseeCluster.health()``."""
    epoch: int
    tick: int
    mns: List[MNHealth] = field(default_factory=list)
    clients: List[ClientHealth] = field(default_factory=list)
    recovery: RecoveryStats = field(default_factory=RecoveryStats)
    client_recoveries: int = 0
    mn_recoveries: int = 0
    crashed_ops: int = 0
    migrating_regions: int = 0      # regions inside a live-migration window
    migrations: List[Dict] = field(default_factory=list)  # per-region detail

    @property
    def alive_mns(self) -> int:
        return sum(m.alive for m in self.mns)

    @property
    def retired_mns(self) -> int:
        return sum(m.retired for m in self.mns)

    @property
    def live_clients(self) -> int:
        return sum(c.status == "live" for c in self.clients)

    def summary(self) -> str:
        return (f"epoch={self.epoch} tick={self.tick} "
                f"mns={self.alive_mns}/{len(self.mns)} alive "
                f"clients={self.live_clients}/{len(self.clients)} live "
                f"recoveries={self.client_recoveries}+{self.mn_recoveries}mn "
                f"crashed_ops={self.crashed_ops}")


def accumulate_recovery(total: RecoveryStats, st: RecoveryStats):
    """Fold one recovery's stats into a cumulative total (health view)."""
    for f in dataclasses.fields(RecoveryStats):
        setattr(total, f.name, getattr(total, f.name) + getattr(st, f.name))
