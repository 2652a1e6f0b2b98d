"""Happens-before race analysis over a recorded verb trace.

The FUSEE protocol *embraces* data races: index slots are raced by CAS and
arbitrated by SNAPSHOT rules, object reads race used-bit resets and are
validated by CRC, the ordered keydir plain-writes unreachable fresh leaves
before linking them.  A naive conflict detector would drown in legal races,
so every rule here is scoped by the protocol's own legalization argument —
a finding is a conflict the protocol has **no** story for:

``stale_epoch``
    A mutation executed under a lease epoch older than the pool epoch.
    The §5.2 membership model requires such verbs to bounce (MR invalid);
    one reaching memory means a guard is missing (the stale-epoch
    redirection bug class).
``lost_cas_ack``
    An op acked OK after *losing* an empty-slot index CAS (expected 0,
    found a different key's slot value) with no later successful index
    mutation installing its value and no master arbitration
    (``MASTER_WIN``).  The acknowledged write is nowhere in the index —
    the lost-write bug class.
``ww_race``
    Plain WRITEs from two different clients to the same DM word, with
    op intervals overlapping in real time, writing different values,
    where *neither* writer holds a CAS claim nearby (same region within
    16 words, won earlier in the same op).  QP FIFO never orders verbs
    of different clients, so nothing serializes these.  CAS-guarded
    completion writes (ordered-keydir backup broadcasts after a won
    claim) are excluded — the claim CAS is the serialization point.
``index_plain_write``
    A client-context plain WRITE or FAA to a RACE index shard.  Clients
    mutate index slots exclusively through CAS (Alg 1); a plain write
    cannot lose a race and is unconditionally wrong (read/write conflict
    scoping: data-region reads are CRC-validated, so only the index —
    where a torn or blind write is never validated — is flagged).
``clear_order``
    Within one op, a word cleared to 0 on the primary replica in a
    strictly earlier phase than on some backup.  Delete/clear paths must
    clear backups first (primary last), mirroring SNAPSHOT phase order —
    otherwise a crash between the phases resurrects the value from a
    backup after the primary already acked it gone.
``torn_read``
    A READ of an index/keydir word interleaved (by execution order)
    between two mutations of one other-client phase (doorbell batch)
    touching its range — a multi-verb mutation observed mid-flight where
    no validation catches it.  Data-region torn reads are legal (CRC +
    retry) and not flagged.

The pass is numpy-vectorized: word ranges are expanded with repeat/cumsum,
conflicts are localized by a lexsort over (word, seq), and only words with
cross-client activity fall back to per-word Python (a handful even in
storm traces), so million-verb traces analyze in seconds.

Counterpart of the JAX package's ``analysis/races.py``, rule for rule.  It
reads the port's ``VerbTracer`` ring, which is host numpy holding the same
int64 bit patterns as the reference's on the same run, so the findings
(rule, event indices, detail) are the reference's.  ``_storm_run`` drives
the port's cluster on ``device`` (the card unless the caller asks for the
CPU); the trace never leaves the host.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .trace import CAS, FAA, READ, VERB_NAMES, WRITE

__all__ = ["Finding", "detect", "report", "ALL_RULES",
           "TruncatedTraceWarning", "TruncatedTraceError"]

ALL_RULES = ("stale_epoch", "lost_cas_ack", "ww_race", "index_plain_write",
             "clear_order", "torn_read")

# a plain write within this many words of an earlier same-op CAS win (same
# region) counts as that claim's replication-completion write
CAS_GUARD_WINDOW = 16
# cap on per-word pairwise work: a word with pathological event counts is
# truncated (and the truncation reported) instead of going quadratic
MAX_EVENTS_PER_WORD = 256


@dataclass(frozen=True)
class Finding:
    rule: str
    region: int
    replica: int
    off: int                       # offending word address
    cids: Tuple[int, ...]
    verbs: Tuple[str, ...]
    op_ids: Tuple[int, ...]
    seqs: Tuple[int, ...]
    detail: str

    def __str__(self) -> str:
        return (f"[{self.rule}] region {self.region} replica {self.replica}"
                f" word {self.off}: cids {list(self.cids)} verbs"
                f" {list(self.verbs)} ops {list(self.op_ids)} — {self.detail}")


@dataclass
class _OpInfo:
    cid: int
    inv: int
    resp: int
    status: Optional[str] = None
    rule: Optional[str] = None


def _op_table(scheduler) -> Dict[int, _OpInfo]:
    ops: Dict[int, _OpInfo] = {}
    if scheduler is None:
        return ops
    horizon = scheduler.tick + 1
    for rec in scheduler.history:
        resp = rec.resp_tick if rec.resp_tick >= 0 else horizon
        info = _OpInfo(cid=rec.cid, inv=rec.inv_tick, resp=resp)
        if rec.result is not None:
            info.status = rec.result.status
            info.rule = rec.result.rule
        ops[rec.op_id] = info
    return ops


class TruncatedTraceWarning(UserWarning):
    """The tracer ring wrapped: the analysis covers a truncated window."""


class TruncatedTraceError(RuntimeError):
    """Raised by ``detect(..., on_truncated="fail")`` on a wrapped ring."""


def detect(tracer, scheduler=None, rules=None,
           on_truncated: str = "warn") -> List[Finding]:
    """Run the race rules over ``tracer``'s retained window.

    ``scheduler`` supplies op real-time intervals and outcomes (required
    for ``lost_cas_ack`` and the concurrency test of ``ww_race``; without
    it those rules degrade conservatively to seq-order only).

    A saturated ring silently weakens every rule — happens-before edges
    and CAS guards anchored in dropped records are invisible, so both
    false negatives AND false positives (an unguarded-looking write whose
    guard fell off) are possible.  ``on_truncated`` decides what a wrapped
    ring does: ``"warn"`` (default) emits a ``TruncatedTraceWarning``,
    ``"fail"`` raises ``TruncatedTraceError`` (CI mode), ``"ignore"``
    analyzes silently.
    """
    if on_truncated not in ("warn", "fail", "ignore"):
        raise ValueError(f"on_truncated={on_truncated!r}: expected "
                         "'warn', 'fail' or 'ignore'")
    pool = tracer.pool
    if pool is None:
        raise ValueError("tracer is not attached to a pool")
    if tracer.dropped:
        msg = (f"tracer ring wrapped: {tracer.dropped} oldest record(s) "
               f"dropped (capacity {tracer.capacity}, {tracer.n} emitted) — "
               "race analysis covers the retained window only")
        if on_truncated == "fail":
            raise TruncatedTraceError(msg)
        if on_truncated == "warn":
            warnings.warn(msg, TruncatedTraceWarning, stacklevel=2)
    return detect_events(tracer.events(), tracer.labels,
                         index_regions=set(pool.index_region_set),
                         ordered_regions=set(pool.ordered_region_set),
                         ops=_op_table(scheduler), rules=rules)


def detect_events(ev, labels, *, index_regions, ordered_regions,
                  ops: Dict[int, _OpInfo], rules=None) -> List[Finding]:
    rules = set(ALL_RULES if rules is None else rules)
    findings: List[Finding] = []
    if len(ev["seq"]) == 0:
        return findings
    ctx = _Ctx(ev, labels, index_regions, ordered_regions, ops)
    if "stale_epoch" in rules:
        findings += _rule_stale_epoch(ctx)
    if "lost_cas_ack" in rules:
        findings += _rule_lost_cas_ack(ctx)
    if "index_plain_write" in rules:
        findings += _rule_index_plain_write(ctx)
    if "clear_order" in rules:
        findings += _rule_clear_order(ctx)
    if "ww_race" in rules or "torn_read" in rules:
        findings += _word_conflict_rules(ctx, rules)
    findings.sort(key=lambda f: (f.rule, f.seqs))
    return findings


def report(findings: List[Finding], tracer=None) -> str:
    """Human-readable race report (one block per finding)."""
    dropped = tracer.dropped if tracer is not None else 0
    if not findings:
        if dropped:
            # "clean" over a truncated window is NOT a clean verdict
            return (f"race detector: no findings in retained window — "
                    f"NOT clean: ring wrapped, oldest {dropped} "
                    "record(s) dropped\n")
        return "race detector: clean (0 findings)\n"
    lines = [f"race detector: {len(findings)} finding(s)"]
    if dropped:
        lines.append(f"  (ring wrapped: oldest {dropped} events "
                     "dropped — findings cover the retained window)")
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    lines.append("  " + ", ".join(f"{r}: {n}"
                                  for r, n in sorted(by_rule.items())))
    for i, f in enumerate(findings, 1):
        lines.append(f"--- finding {i} ---")
        lines.append(str(f))
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
@dataclass
class _Ctx:
    ev: dict
    labels: list
    index_regions: set
    ordered_regions: set
    ops: Dict[int, _OpInfo]
    masks: dict = field(default_factory=dict)

    def __post_init__(self):
        ev = self.ev
        verb, ok = ev["verb"], ev["ok"].astype(bool)
        client = ev["cid"] >= 0
        hit = (verb == CAS) & ok & (ev["old"] == ev["arg"])
        mut = ok & ((verb == WRITE) | (verb == FAA) | hit)
        in_index = np.isin(ev["region"], sorted(self.index_regions)) \
            if self.index_regions else np.zeros(len(verb), bool)
        in_ordered = np.isin(ev["region"], sorted(self.ordered_regions)) \
            if self.ordered_regions else np.zeros(len(verb), bool)
        self.masks = dict(ok=ok, client=client, hit=hit, mut=mut,
                          in_index=in_index, in_ordered=in_ordered)

    def label_of(self, i: int) -> str:
        lid = int(self.ev["label"][i])
        return self.labels[lid] if 0 <= lid < len(self.labels) else "?"

    def concurrent(self, op_a: int, op_b: int) -> bool:
        """Real-time overlap of two op intervals; unknown ops are treated
        as concurrent (conservative)."""
        a, b = self.ops.get(op_a), self.ops.get(op_b)
        if a is None or b is None:
            return True
        return a.inv <= b.resp and b.inv <= a.resp


def _mk(ctx: _Ctx, rule: str, idxs, detail: str) -> Finding:
    ev = ctx.ev
    idxs = [int(i) for i in idxs]
    i0 = idxs[0]
    return Finding(
        rule=rule, region=int(ev["region"][i0]),
        replica=int(ev["replica"][i0]), off=int(ev["off"][i0]),
        cids=tuple(int(ev["cid"][i]) for i in idxs),
        verbs=tuple(VERB_NAMES[int(ev["verb"][i])] for i in idxs),
        op_ids=tuple(int(ev["op_id"][i]) for i in idxs),
        seqs=tuple(int(ev["seq"][i]) for i in idxs),
        detail=detail)


# ----------------------------------------------------------- scalar rules
def _rule_stale_epoch(ctx: _Ctx) -> List[Finding]:
    ev, m = ctx.ev, ctx.masks
    cand = (m["client"] & m["ok"] & (ev["verb"] != READ)
            & (ev["epoch_issue"] >= 0)
            & (ev["epoch_issue"] != ev["epoch_exec"]))
    out = []
    for i in np.nonzero(cand)[0]:
        out.append(_mk(
            ctx, "stale_epoch", [i],
            f"mutation issued under lease epoch {int(ev['epoch_issue'][i])} "
            f"executed at pool epoch {int(ev['epoch_exec'][i])} "
            f"(phase '{ctx.label_of(i)}', tick {int(ev['tick'][i])}) — "
            "stale verbs must bounce, not land on re-homed placement"))
    return out


def _rule_lost_cas_ack(ctx: _Ctx) -> List[Finding]:
    ev, m = ctx.ev, ctx.masks
    lost_empty = (m["client"] & m["in_index"] & (ev["verb"] == CAS)
                  & m["ok"] & (ev["arg"] == 0) & (ev["old"] != 0)
                  & (ev["old"] != ev["val"]))
    if not lost_empty.any():
        return []
    # value a mutation installs: write payload first word / cas new value
    installed = np.where(ev["verb"] == WRITE, ev["arg"], ev["val"])
    install = m["client"] & m["in_index"] & m["mut"] & (ev["verb"] != FAA)
    out = []
    seen_ops = set()
    for i in np.nonzero(lost_empty)[0]:
        op = int(ev["op_id"][i])
        if op in seen_ops:
            continue
        info = ctx.ops.get(op)
        if info is None or info.status != "OK":
            continue   # op retried / failed / still open: protocol handled it
        if info.rule == "MASTER_WIN":
            continue   # master arbitration installed the value (Alg 4)
        v_new = int(ev["val"][i])
        old_u = int(ev["old"][i]) & 0xFFFFFFFFFFFFFFFF
        if (old_u >> 56) == ((v_new & 0xFFFFFFFFFFFFFFFF) >> 56):
            continue   # same-fingerprint winner: a same-key racer upserted
                       # the slot, so losing + acking OK is last-writer-wins
                       # (the loser's value linearizes just before the
                       # winner's).  A true lost write to a DIFFERENT key
                       # matches fps only 1/255 of the time.
        later_ok = (install & (ev["op_id"] == op)
                    & (installed == v_new) & (ev["seq"] > ev["seq"][i]))
        if later_ok.any():
            continue   # the op retried and its value did land
        seen_ops.add(op)
        out.append(_mk(
            ctx, "lost_cas_ack", [i],
            f"op {op} (cid {int(ev['cid'][i])}) acked OK "
            f"(rule {info.rule}) after losing an empty-slot CAS: expected "
            f"0, found {int(ev['old'][i]) & 0xFFFFFFFFFFFFFFFF:#x}, wanted "
            f"{v_new & 0xFFFFFFFFFFFFFFFF:#x} — acknowledged write is "
            "nowhere in the index"))
    return out


def _rule_index_plain_write(ctx: _Ctx) -> List[Finding]:
    ev, m = ctx.ev, ctx.masks
    cand = (m["client"] & m["in_index"] & m["ok"]
            & ((ev["verb"] == WRITE) | (ev["verb"] == FAA)))
    out = []
    for i in np.nonzero(cand)[0]:
        out.append(_mk(
            ctx, "index_plain_write", [i],
            f"client {int(ev['cid'][i])} mutated an index shard with a "
            f"plain {VERB_NAMES[int(ev['verb'][i])].upper()} (phase "
            f"'{ctx.label_of(i)}') — index slots may only be CASed"))
    return out


def _rule_clear_order(ctx: _Ctx) -> List[Finding]:
    ev, m = ctx.ev, ctx.masks
    # scope: index/keydir words only, where a zero IS the authoritative
    # state.  Data-region clears (used-bit resets, delete cleanup) may
    # legally touch replicas across phases in either order — readers
    # validate objects by CRC + used bit, so a half-cleared object can
    # never resurrect an acked-gone value.
    zero = m["client"] & m["ok"] & (m["in_index"] | m["in_ordered"]) & (
        ((ev["verb"] == WRITE) & (ev["n"] == 1) & (ev["arg"] == 0))
        | (m["hit"] & (ev["val"] == 0)))
    idxs = np.nonzero(zero)[0]
    if len(idxs) == 0:
        return []
    key = np.stack([ev["op_id"][idxs], ev["region"][idxs],
                    ev["off"][idxs]], axis=1)
    _, inverse = np.unique(key, axis=0, return_inverse=True)
    groups: Dict[int, list] = {}
    for pos, g in zip(idxs, inverse):
        groups.setdefault(int(g), []).append(int(pos))
    out = []
    for members in groups.values():
        prim = [i for i in members if ev["replica"][i] == 0]
        back = [i for i in members if ev["replica"][i] > 0]
        if not prim or not back:
            continue
        p = min(prim, key=lambda i: int(ev["phase"][i]))
        b = max(back, key=lambda i: int(ev["phase"][i]))
        if int(ev["phase"][p]) < int(ev["phase"][b]):
            out.append(_mk(
                ctx, "clear_order", [p, b],
                f"op {int(ev['op_id'][p])} cleared primary replica 0 at "
                f"phase {int(ev['phase'][p])} ('{ctx.label_of(p)}') before "
                f"backup replica {int(ev['replica'][b])} at phase "
                f"{int(ev['phase'][b])} ('{ctx.label_of(b)}') — clears "
                "must land on backups first"))
    return out


# ----------------------------------------------------- per-word conflicts
def _expand_words(ev, idxs):
    """Per-word rows for events ``idxs``: (event_row, word) arrays."""
    lens = ev["n"][idxs]
    lens = np.maximum(lens, 0)
    rows = np.repeat(idxs, lens)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    word = ev["off"][rows] + (np.arange(int(lens.sum())) - starts)
    return rows, word


def _word_conflict_rules(ctx: _Ctx, rules) -> List[Finding]:
    ev, m = ctx.ev, ctx.masks
    out: List[Finding] = []
    # candidate events: client plain writes everywhere (ww_race) plus
    # reads + mutations in the index/keydir scope (torn_read)
    ww_mask = m["client"] & (ev["verb"] == WRITE) & m["ok"] \
        if "ww_race" in rules else np.zeros(len(ev["seq"]), bool)
    torn_scope = m["in_index"] | m["in_ordered"]
    torn_mask = m["client"] & torn_scope & (m["mut"] | (ev["verb"] == READ)) \
        if "torn_read" in rules else np.zeros(len(ev["seq"]), bool)
    cand = ww_mask | torn_mask
    idxs = np.nonzero(cand)[0]
    if len(idxs) == 0:
        return out
    rows, word = _expand_words(ev, idxs)
    key = ((ev["region"][rows].astype(np.int64) << 40)
           | (ev["replica"][rows].astype(np.int64) << 36) | word)
    # words touched by >= 2 distinct client cids
    pairs = np.unique(np.stack([key, ev["cid"][rows]], axis=1), axis=0)
    wkeys, counts = np.unique(pairs[:, 0], return_counts=True)
    hot = set(wkeys[counts >= 2].tolist())
    if not hot:
        return out
    sel = np.isin(key, np.fromiter(hot, np.int64, len(hot)))
    per_word: Dict[int, list] = {}
    for r, k in zip(rows[sel], key[sel]):
        per_word.setdefault(int(k), []).append(int(r))
    guards = _cas_guards(ctx)
    for k, members in per_word.items():
        members = sorted(set(members), key=lambda i: int(ev["seq"][i]))
        if len(members) > MAX_EVENTS_PER_WORD:
            members = members[:MAX_EVENTS_PER_WORD]
        w = k & ((1 << 36) - 1)
        if "ww_race" in rules:
            out += _ww_pairs(ctx, [i for i in members if ww_mask[i]],
                             w, guards)
        if "torn_read" in rules:
            out += _torn_reads(ctx, [i for i in members if torn_mask[i]], w)
    return out


def _cas_guards(ctx: _Ctx) -> Dict[Tuple[int, int], list]:
    """(cid, op) -> [(seq, region, off)] of successful CAS claims."""
    ev, m = ctx.ev, ctx.masks
    guards: Dict[Tuple[int, int], list] = {}
    for i in np.nonzero(m["client"] & m["hit"])[0]:
        guards.setdefault(
            (int(ev["cid"][i]), int(ev["op_id"][i])), []).append(
            (int(ev["seq"][i]), int(ev["region"][i]), int(ev["off"][i])))
    return guards


def _is_guarded(ev, i, guards) -> bool:
    lst = guards.get((int(ev["cid"][i]), int(ev["op_id"][i])))
    if not lst:
        return False
    seq, region, off = int(ev["seq"][i]), int(ev["region"][i]), \
        int(ev["off"][i])
    return any(s < seq and r == region and abs(o - off) <= CAS_GUARD_WINDOW
               for s, r, o in lst)


def _ww_pairs(ctx: _Ctx, writes, word, guards) -> List[Finding]:
    ev = ctx.ev
    out = []
    for a_pos in range(len(writes)):
        for b_pos in range(a_pos + 1, len(writes)):
            a, b = writes[a_pos], writes[b_pos]
            if ev["cid"][a] == ev["cid"][b]:
                continue    # same client: QP FIFO / program order
            if not ctx.concurrent(int(ev["op_id"][a]), int(ev["op_id"][b])):
                continue    # real-time ordered: last writer legitimately wins
            same_shape = (ev["off"][a] == ev["off"][b]
                          and ev["n"][a] == ev["n"][b])
            same_value = (same_shape and ev["arg"][a] == ev["arg"][b]
                          and ev["val"][a] == ev["val"][b])
            if same_value:
                continue    # idempotent double-write (e.g. keydir ensure)
            if _is_guarded(ev, a, guards) or _is_guarded(ev, b, guards):
                continue    # replication completion of a won CAS claim
            out.append(_mk(
                ctx, "ww_race", [a, b],
                f"unordered plain writes from cids {int(ev['cid'][a])} and "
                f"{int(ev['cid'][b])} to word {word} with different values "
                f"(phases '{ctx.label_of(a)}' / '{ctx.label_of(b)}'): no "
                "QP FIFO edge, no CAS claim — outcome is timing-dependent"))
            return out   # one finding per word is enough signal
    return out


def _torn_reads(ctx: _Ctx, members, word) -> List[Finding]:
    ev, m = ctx.ev, ctx.masks
    reads = [i for i in members if ev["verb"][i] == READ]
    muts = [i for i in members if m["mut"][i]]
    if not reads or len(muts) < 2:
        return []
    out = []
    # mutation groups: one (cid, op, phase) doorbell batch
    groups: Dict[Tuple[int, int, int], list] = {}
    for i in muts:
        groups.setdefault((int(ev["cid"][i]), int(ev["op_id"][i]),
                           int(ev["phase"][i])), []).append(i)
    for r in reads:
        rs = int(ev["seq"][r])
        for (gcid, gop, _), g in groups.items():
            if gcid == int(ev["cid"][r]) or len(g) < 2:
                continue
            seqs = [int(ev["seq"][i]) for i in g]
            if min(seqs) < rs < max(seqs):
                first = min(g, key=lambda i: int(ev["seq"][i]))
                out.append(_mk(
                    ctx, "torn_read", [r, first],
                    f"cid {int(ev['cid'][r])} read word {word} between "
                    f"verbs of cid {gcid} op {gop}'s multi-verb mutation "
                    f"phase ('{ctx.label_of(first)}') — observed a torn "
                    "write in un-validated metadata"))
                return out
    return out


# =============================================================== CLI =======
# ``python -m repro_torch.analysis.races --storm-seed N`` — run the seeded
# fault storm (same shape as tests/test_fault_storm.py) under an attached
# tracer, then run the race pass and the heap/epoch auditor over the result.
# Exits nonzero on any race finding or heap error; ``--out DIR`` saves the
# raw trace as an .npz artifact.  The cluster lives on the card unless
# ``--device cpu`` is given.

def _storm_run(seed: int, *, churn: bool = False, total_ops: int = 160,
               capacity: int = 1 << 16, device=None):
    from ..core import (ClientCrashed, DMConfig, FaultPlan, FuseeCluster,
                        Op)

    n_clients, n_mns, repl = 6, 5, 3
    cl = FuseeCluster(DMConfig(num_mns=n_mns, replication=repl,
                               region_words=1 << 15, regions_per_mn=16,
                               index_shards=4 if churn else 1),
                      num_clients=n_clients, seed=seed, device=device)
    tr = cl.attach_tracer(capacity=capacity)
    storm_kw = dict(clients=range(n_clients), mns=n_mns, replication=repl,
                    n_client_crashes=2, n_mn_crashes=2, first_op=10,
                    spacing=14, recover_delay=8)
    if churn:
        storm_kw.update(n_add_mns=1, remove_added=True,
                        crash_during_migration=True, n_mn_crashes=1)
    plan = FaultPlan.storm(cl.rng.stream("faults"), **storm_kw)
    injector = cl.inject(plan)
    fleet = cl.fleet()
    stores = {c: cl.store(c, max_inflight=0) for c in range(n_clients)}
    submitted = 0
    while submitted < total_ops:
        for c in range(n_clients):
            if submitted >= total_ops:
                break
            k = submitted
            submitted += 1
            try:
                stores[c].submit(Op.put(k, [k, c]))
            except ClientCrashed:
                pass                   # typed rejection: op never entered
        for _ in range(4):
            if cl.scheduler.has_work():
                fleet.tick()
    fleet.run()
    if cl.migrator.busy:
        cl.migrator.drive()
    if not injector.done:
        raise RuntimeError(f"storm plan did not fully fire (seed {seed})")
    return cl, tr


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.races",
        description="Run a seeded fault storm under the verb tracer, then "
                    "the race detector and heap auditor; exit 1 on findings.")
    ap.add_argument("--storm-seed", type=int, default=0, metavar="N",
                    help="SimRng seed for the storm run (default 0)")
    ap.add_argument("--churn", action="store_true",
                    help="add membership churn (MN scale-out + live "
                    "migration + mid-migration crash) to the storm")
    ap.add_argument("--ops", type=int, default=160,
                    help="ops to submit (default 160)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated race rules (default: all)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="save the raw verb trace as DIR/trace-seed<N>.npz")
    ap.add_argument("--no-heapcheck", action="store_true",
                    help="skip the post-drain heap/epoch audit")
    ap.add_argument("--device", default=None,
                    help="torch device of the cluster's slab (default: "
                    "cuda; 'cpu' runs without a card)")
    args = ap.parse_args(argv)

    cl, tr = _storm_run(args.storm_seed, churn=args.churn,
                        total_ops=args.ops, device=args.device)
    rules = tuple(args.rules.split(",")) if args.rules else None
    findings = detect(tr, scheduler=cl.scheduler, rules=rules)
    print(f"[races] seed={args.storm_seed} churn={args.churn} "
          f"device={cl.pool.slab.buf.device} events={tr.n} "
          f"findings={len(findings)}")
    print(report(findings, tr))

    heap_bad = False
    if not args.no_heapcheck:
        from .heapcheck import audit
        rep = audit(cl)
        heap_bad = not rep.ok
        print(f"[heapcheck] {rep}")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(
            args.out, f"trace-seed{args.storm_seed}"
                      f"{'-churn' if args.churn else ''}.npz")
        tr.save(path)
        print(f"[races] trace saved to {path}")
    return 1 if (findings or heap_bad) else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
