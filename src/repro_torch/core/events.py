"""Verb / phase vocabulary shared by the client state machines, the master,
and the scheduler (sim.py).

A client op is a Python generator that yields ``Phase`` objects.  One phase is
one doorbell-batched verb group = **1 network RTT** (§4.6 RDMA optimizations:
doorbell batching + selective signaling make each phase a single round trip).
The scheduler executes the verbs of a phase one at a time, interleaved with
other clients' verbs (preserving per-(client, MN) FIFO), then resumes the
generator with the result list.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class Verb:
    kind: str                 # 'read' | 'write' | 'cas' | 'faa' | 'alloc' | 'free'
    region: int = 0
    replica: int = 0
    off: int = 0
    n: int = 0                # read length (words)
    words: Optional[list] = None
    exp: int = 0
    new: int = 0
    delta: int = 0
    mn: int = -1              # alloc/free RPC target
    # Lease epoch at issue time (stamped by the scheduler when the phase's
    # doorbell batch is posted).  A verb whose epoch is stale by execution
    # time FAILs instead of silently resolving its replica index against
    # the *new* placement — the §5.2 membership-change model: re-homing a
    # region invalidates outstanding MRs, so in-flight verbs bounce and
    # the client retries against the committed new epoch.  Without this, a
    # write issued as "replica 1" before an MN crash can land on whatever
    # node becomes replica 1 afterwards, and an acknowledged KV object can
    # be missing from the post-recovery primary.
    epoch: int = -1

    def target_mn(self, pool) -> int:
        if self.kind in ("alloc", "free"):
            return self.mn
        reps = pool.placement.get(self.region)
        if reps is None or self.replica >= len(reps):
            return -1
        return reps[self.replica]


# Typed retry/stall cause vocabulary (obs/spans.py span trees): why a
# phase was (re)issued.  "" = first-attempt protocol work.  Client state
# machines stamp these on the Phase; the verb tracer records them per row
# so the causal profiler can attribute every RTT of a retry loop to the
# event that forced it.
CAUSE_NONE = ""
CAUSE_CAS_LOST = "cas_lost"          # lost a SNAPSHOT/empty-slot CAS round
CAUSE_FP_COLLISION = "fp_collision"  # fp matched, object didn't verify (stale/collision)
CAUSE_STALE_EPOCH = "stale_epoch"    # §5.2 lease bounce / dead-MN FAIL -> reissue
CAUSE_LOSE_POLL = "lose_poll"        # SNAPSHOT loser polling the winner's commit
CAUSE_FULL = "full"                  # allocation pressure: re-ask after failed grant
CAUSE_MIG_DUAL = "mig_dual_write"    # executed inside a live-migration dual-write window
CAUSES = (CAUSE_NONE, CAUSE_CAS_LOST, CAUSE_FP_COLLISION, CAUSE_STALE_EPOCH,
          CAUSE_LOSE_POLL, CAUSE_FULL, CAUSE_MIG_DUAL)


@dataclass
class Phase:
    verbs: List[Verb]
    label: str = ""
    background: bool = False   # off the op's latency critical path (§4.4 frees,
                               # loser used-bit resets) but still bandwidth-counted
    cause: str = CAUSE_NONE    # typed retry/stall cause (see CAUSES above)


@dataclass
class MasterCall:
    """Client->master RPC (Alg 4 fail_query etc.). Costs rpc_rtts round trips."""
    kind: str                  # 'fail_query' | 'refresh' | 'init' | 'fail_report'
    payload: Any = None


# Op result statuses
OK = "OK"
NOT_FOUND = "NOT_FOUND"
EXISTS = "EXISTS"
FULL = "FULL"
CRASHED = "CRASHED"        # op's client crashed mid-flight (crash-stop §5.1);
                           # retriable on any live client after recovery


@dataclass
class OpResult:
    status: str
    value: Optional[list] = None
    rtts: int = 0              # critical-path RTTs actually spent
    bg_rtts: int = 0           # background round trips
    rule: Optional[str] = None # winning SNAPSHOT rule, for Fig-9/RTT accounting
    page: Optional[int] = None # device-backend page id backing this key

    @property
    def retriable(self) -> bool:
        """True when the op did not report an outcome and may be resubmitted
        on a live client (CRASHED: any partial effect is repaired or redone
        by §5.3 client recovery before it becomes observable)."""
        return self.status == CRASHED
