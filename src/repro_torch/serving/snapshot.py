"""SNAPSHOT replication protocol as one batched CAS epoch on device.

The event-level simulator (core/client.py) executes Algorithm 1+2 verb by
verb.  On the serving path the same protocol runs as a *vectorized epoch*:
a batch of W writers all CAS their backup slots, observe the CAS return
values (``v_list``), evaluate the three conflict-resolution rules, and the
unique winner commits the primary — no locks, no serialization, exactly
the paper's collaborative conflict resolution.

The replica axis r of ``index`` is the set of memory nodes holding index
replicas.  The "CAS arrival order" at each replica is an explicit
per-replica priority ``prios`` (r, W): the network's nondeterminism, drawn
by the caller (``KVPool`` from its own ``torch.Generator``; the parity
tests feed the JAX package's draws).  The atomicity of RDMA_CAS becomes a
scatter-min: each backup slot accepts exactly one writer per epoch because
all writers present the same expected value ``v_old``.  Equal priorities
on one slot go to the lowest writer index.

Counterpart of the JAX package's ``serving/snapshot_jax.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_INT32_MAX = 2 ** 31 - 1


class EpochResult(NamedTuple):
    index: torch.Tensor      # (r, M) updated replicas (flat slots)
    win: torch.Tensor        # (W,) bool — this writer's value was committed
    committed: torch.Tensor  # (W,) int32 — value now in the writer's slot
    rule: torch.Tensor       # (W,) int32 — 1/2/3 for winners, 0 for losers


def _first_min(slot: torch.Tensor, prio: torch.Tensor, M: int):
    """won[w]: ``prio[w]`` is finite and the least of all writers on
    ``slot[w]`` (ties to the lowest writer index) — the writer whose CAS
    arrives first at that slot."""
    best = torch.full((M,), float("inf"), dtype=prio.dtype,
                      device=prio.device).scatter_reduce(
        0, slot, prio, reduce="amin")
    cand = torch.isfinite(prio) & (prio == best[slot])
    W = slot.shape[0]
    widx = torch.arange(W, device=slot.device)
    first = torch.full((M,), W, dtype=torch.int64,
                       device=slot.device).scatter_reduce(
        0, slot, torch.where(cand, widx, W), reduce="amin")
    return cand & (first[slot] == widx)


def snapshot_epoch(index: torch.Tensor, slot_idx: torch.Tensor,
                   v_old: torch.Tensor, v_new: torch.Tensor,
                   prios: torch.Tensor) -> EpochResult:
    """One SNAPSHOT write round for a batch of writers.

    index: (r, M) int32 flat replicated slots (replica 0 = primary).
    slot_idx: (W,) target slot per writer (-1 = inactive writer).
    v_old: (W,) int32 expected value (what the writer read from the primary).
    v_new: (W,) int32 proposed value (unique per writer by out-of-place
    alloc).  prios: (r, W) float CAS arrival priorities (lower = earlier).
    """
    r, M = index.shape
    active = slot_idx >= 0
    slot = torch.where(active, slot_idx, 0).to(torch.int64)
    inf = torch.full_like(prios[0], float("inf"))

    cur_primary = index[0, slot]
    # a CAS can only succeed if the expected value matches the *current*
    # replica value; all writers share v_old so each backup slot accepts at
    # most one writer per epoch (RDMA_CAS atomicity).
    can = active & (cur_primary == v_old)

    if r == 1:
        # degenerate single-replica mode: plain CAS race on the primary
        win = _first_min(slot, torch.where(can, prios[0], inf), M)
        new0 = index[0].clone()
        new0[slot[win]] = v_new[win]
        return EpochResult(new0[None], win, new0[slot],
                           win.to(torch.int32))

    new_index = index.clone()
    for b in range(1, r):
        valid = can & (index[b, slot] == v_old)
        won_cas = _first_min(slot, torch.where(valid, prios[b], inf), M)
        new_index[b, slot[won_cas]] = v_new[won_cas]

    # v_list per writer: the values now in its backup slots (CAS returns)
    v_list = new_index[1:, slot].T                      # (W, r-1)
    nb = r - 1
    eq = v_list == v_new[:, None]
    n_eq = eq.sum(dim=1)
    rule1 = n_eq == nb
    rule2 = ~rule1 & (2 * n_eq > nb)
    # Rule 3: no majority anywhere -> smallest proposed value wins.  The
    # primary is untouched within an epoch, so the Alg.2 line-12 check
    # (primary still == v_old) always passes for ``can`` writers.
    has_any = n_eq > 0
    # a slot is rule-3 eligible only if NO writer on it got a majority
    slot_major = torch.zeros(M, dtype=torch.int32, device=index.device) \
        .scatter_reduce(0, slot, (can & (rule1 | rule2)).to(torch.int32),
                        reduce="amax") > 0
    vmax = torch.full_like(v_new, _INT32_MAX)
    own_min = torch.where(eq, v_new[:, None], vmax[:, None]).amin(dim=1)
    vmin_per_slot = torch.full((M,), _INT32_MAX, dtype=v_new.dtype,
                               device=index.device).scatter_reduce(
        0, slot, torch.where(can & has_any, own_min, vmax), reduce="amin")
    rule3 = (can & has_any & ~(rule1 | rule2) & ~slot_major[slot]
             & (v_new == vmin_per_slot[slot]))
    win = can & (rule1 | rule2 | rule3)

    # winner commits: repair divergent backups + CAS primary
    new_index[:, slot[win]] = v_new[win]
    committed = new_index[0, slot]
    rule = torch.where(rule1, 1, torch.where(rule2, 2, torch.where(rule3, 3,
                                                                   0)))
    return EpochResult(new_index, win, committed,
                       torch.where(win, rule, 0).to(torch.int32))


def snapshot_epoch_np(index, slot_idx, v_old, v_new, order):
    """Numpy oracle executing the same epoch sequentially (CAS by CAS) in an
    explicit per-replica arrival ``order``."""
    index = np.array(index)
    r, M = index.shape
    W = len(slot_idx)
    # phase 2: backup CAS races in arrival order
    for b in range(1, r):
        for w in order[b % len(order)]:
            if slot_idx[w] < 0:
                continue
            s = slot_idx[w]
            if index[0, s] == v_old[w] and index[b, s] == v_old[w]:
                index[b, s] = v_new[w]
    win = np.zeros(W, bool)
    rulev = np.zeros(W, np.int32)
    for w in range(W):
        if slot_idx[w] < 0 or index[0, slot_idx[w]] != v_old[w]:
            continue
        s = slot_idx[w]
        vl = index[1:, s]
        n_eq = int((vl == v_new[w]).sum())
        nb = r - 1
        if nb == 0:
            win[w], rulev[w] = True, 1
            continue
        if n_eq == nb:
            win[w], rulev[w] = True, 1
        elif 2 * n_eq > nb:
            win[w], rulev[w] = True, 2
        elif n_eq > 0:
            # rule 3 candidates: defer; resolved after majority check
            rulev[w] = -3
    # rule 3: per slot, smallest v_new among candidates wins if no majority
    for s in set(int(s) for s in slot_idx if s >= 0):
        cands = [w for w in range(W)
                 if slot_idx[w] == s and rulev[w] == -3]
        if any(win[w] for w in range(W) if slot_idx[w] == s):
            for w in cands:
                rulev[w] = 0
            continue
        if cands:
            wmin = min(cands, key=lambda w: v_new[w])
            win[wmin], rulev[wmin] = True, 3
            for w in cands:
                if w != wmin:
                    rulev[w] = 0
    # winners commit all replicas + primary
    for w in range(W):
        if win[w]:
            index[:, slot_idx[w]] = v_new[w]
    committed = np.array([index[0, s] if s >= 0 else 0 for s in slot_idx])
    return index, win, committed, np.maximum(rulev, 0)
