"""Linearizability checking for per-key KV histories.

FUSEE's correctness claim (§A.3) is that each replicated index slot behaves
as a linearizable register with last-writer-wins semantics, which lifts to
per-key linearizability of SEARCH/INSERT/UPDATE/DELETE (out-of-place values
are unique).  This module implements a Wing&Gong-style DFS checker over the
real-time partial order: feasible for the small histories the property tests
generate (<= ~10 concurrent ops per key).

Semantics of the sequential specification (a single register per key):
  insert(v): value <- v            (our INSERT upserts on duplicates)
  update(v): value <- v if present else NOT_FOUND (no state change)
  delete():  OK        -> value <- ABSENT  (a *blind write* of ABSENT: the
                          paper's uniqueness argument does not apply to the
                          all-writers-write-NULL case, so concurrent deleters
                          may all report OK; see DESIGN.md §deviations)
             NOT_FOUND -> requires value already ABSENT (observed absence)
  search():  returns current value or ABSENT

Counterpart of the JAX package's ``core/linearize.py``, line for line: pure
Python over the scheduler's op records.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import FrozenSet, List, Optional, Tuple

ABSENT = None


@dataclass(frozen=True)
class HOp:
    op_id: int
    kind: str                    # insert | update | delete | search
    inv: int
    resp: int
    wrote: Optional[tuple]       # value written (insert/update), else None
    read: Optional[tuple]        # value returned (search), ABSENT -> ('<absent>',)
    status: str = "OK"           # OK | NOT_FOUND


def check_linearizable(ops: List[HOp], initial=ABSENT) -> bool:
    """DFS over linearization prefixes with memoization."""
    n = len(ops)
    ops = sorted(ops, key=lambda o: o.op_id)
    idx = {o.op_id: i for i, o in enumerate(ops)}

    def transition(o: HOp, value):
        if o.kind == "search":
            if o.status == "NOT_FOUND":
                return (value is ABSENT), value
            return (value is not ABSENT and tuple(value) == tuple(o.read)), value
        if o.kind == "insert":
            return o.status == "OK", tuple(o.wrote)
        if o.kind == "update":
            if value is ABSENT:
                return o.status == "NOT_FOUND", value
            return o.status == "OK", tuple(o.wrote)
        if o.kind == "delete":
            if o.status == "NOT_FOUND":
                return value is ABSENT, value
            return True, ABSENT  # blind write of ABSENT
        raise ValueError(o.kind)

    seen = set()

    def dfs(remaining: FrozenSet[int], value) -> bool:
        if not remaining:
            return True
        key = (remaining, value)
        if key in seen:
            return False
        # candidate = ops with no other remaining op fully preceding them
        rem_ops = [ops[idx[i]] for i in remaining]
        min_resp = min(o.resp for o in rem_ops)
        for o in rem_ops:
            if o.inv > min_resp:
                continue  # some remaining op completed before this one began
            ok, nv = transition(o, value)
            if not ok:
                continue
            if dfs(remaining - {o.op_id}, nv):
                return True
        seen.add(key)
        return False

    return dfs(frozenset(o.op_id for o in ops), initial)


def records_to_hops(records, key) -> List[HOp]:
    """Convert sim.OpRecord list to per-key HOps.

    ``key`` may be an int (protocol key space) or bytes/str (public API
    key space) — the latter is encoded through core/codec.py, matching
    what the pipelined API stamped onto the records.  Fused multi-key
    SEARCH batches appear as one ``search_batch`` parent record (key None,
    skipped here) plus one expanded per-key ``search`` record each.
    """
    if not isinstance(key, int):
        from .codec import encode_key
        key = encode_key(key)
    out = []
    for r in records:
        if r.key != key or r.result is None:
            continue
        if r.kind not in ("insert", "update", "delete", "search"):
            continue  # scan/range/search_batch: not per-key register ops
        status = r.result.status
        if status not in ("OK", "NOT_FOUND"):
            continue  # FULL etc. — excluded from register semantics
        wrote = tuple(r.value) if r.kind in ("insert", "update") and r.value is not None else None
        read = tuple(r.result.value) if (r.kind == "search" and r.result.value is not None) else None
        out.append(HOp(op_id=r.op_id, kind=r.kind, inv=r.inv_tick,
                       resp=r.resp_tick, wrote=wrote, read=read, status=status))
    return out
