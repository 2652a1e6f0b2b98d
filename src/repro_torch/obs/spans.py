"""Causal op span trees: the verb ring joined to the flight recorder.

``build_spans`` links the ``VerbTracer`` verb ring (analysis/trace.py; one
row per executed one-sided verb, each carrying the issuing op's
``(cid, op_id)``, its phase ordinal, the interned phase label, the typed
retry/stall **cause** and the background bit) to the flight recorder's op
begin/settle rows (obs/flight.py) and reconstructs, for every op, the
tree of protocol-phase **spans** it executed:

    op (flight begin..settle)
      +- 1:read_index            cause=""            1 RTT
      +- 2:cas_backups           cause=""            1 RTT
      +- 4:cas_primary           cause=""            1 RTT
      +- 1:read_index            cause="cas_lost"    1 RTT   <- retry round
      +- ...
      +- (untraced)              n RTTs                      <- see below

The reconstruction is **fully vectorized** — one lexsort over the ring and
``reduceat`` segment passes; no per-op Python loops — so profiling a
multi-million-verb ring costs a sort, not a Python traversal.

RTT accounting contract (the conservation guarantee):

* one phase = one doorbell-batched RTT (core/events.py), and the
  scheduler numbers phases with a per-op monotone ordinal
  (``rtts + bg_rtts`` at issue time) — so one ring segment keyed
  ``(cid, op_id, phase)`` is exactly one RTT of that op;
* some RTT beats leave **no ring rows**: empty wait phases
  (``Phase([], ...)``), alloc/free RPC phases (the tracer wraps only the
  eight array-verb entry points), and phases whose every verb was dropped
  pre-pool by the §5.2 stale-epoch guard.  These are materialized as one
  ``(untraced)`` filler entry per op carrying the residual RTT count, so

      observed foreground spans + untraced RTTs == flight-recorder rtts

  holds **exactly** for every settled op — and a negative residual (more
  observed spans than the op reports) is flagged as over-attribution
  instead of being silently clamped;
* background phases (``bg`` column, NOT label conventions) are kept as
  spans but excluded from the foreground conservation sum, mirroring the
  scheduler's ``rtts`` / ``bg_rtts`` split.

Partial trees are flagged, never guessed: an op whose rows may have
fallen off a wrapped verb ring gets ``FLAG_PARTIAL``; an op that never
settled (still in flight, e.g. its client crashed mid-op) gets
``FLAG_OPEN`` and is excluded from conservation; a settled-as-CRASHED op
gets ``FLAG_CRASHED`` (its spans are real — the §5.3 contract is that
partial effects are repaired, not that they didn't happen).

Counterpart of the JAX package's ``obs/spans.py`` (plain numpy over the
host-side verb ring of ``analysis/trace.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .flight import EV_BEGIN, EV_SETTLE

__all__ = ["SpanSet", "build_spans", "spans_from_cluster",
           "spans_to_perfetto", "FLAG_PARTIAL", "FLAG_OVER", "FLAG_OPEN",
           "FLAG_CRASHED", "UNTRACED"]

FLAG_PARTIAL = 1       # verb ring wrapped under this op: spans may be missing
FLAG_OVER = 2          # more fg spans observed than the op's settled rtts
FLAG_OPEN = 4          # op began but never settled (in flight / crashed client)
FLAG_CRASHED = 8       # op settled with status CRASHED (mid-flight crash)

UNTRACED = "(untraced)"

_SPAN_COLS = ("cid", "op_id", "phase", "label", "cause", "bg",
              "t0", "t1", "verbs", "ok_verbs", "op_row")
_OP_COLS = ("cid", "op_id", "kind", "status", "begin_tick", "settle_tick",
            "lat", "rtts", "fg_spans", "bg_spans", "untraced", "flags")


@dataclass
class SpanSet:
    """Column-oriented span trees; see module docstring.

    ``spans`` — one row per executed phase (``op_row`` indexes ``ops``;
    -1 when the op has no flight settle).  ``ops`` — one row per
    flight-recorder op (settled AND still-open).  ``labels`` interns both
    phase labels and causes (the tracer's table); ``flight_labels``
    interns op kinds and statuses.
    """
    spans: Dict[str, np.ndarray]
    ops: Dict[str, np.ndarray]
    labels: List[str]
    flight_labels: List[str]
    trace_dropped: int = 0
    flight_dropped: int = 0

    def label(self, i: int) -> str:
        return self.labels[i] if 0 <= i < len(self.labels) else UNTRACED

    def cause(self, i: int) -> str:
        return self.labels[i] if 0 <= i < len(self.labels) else ""

    @property
    def n_spans(self) -> int:
        return len(self.spans["cid"])

    @property
    def n_ops(self) -> int:
        return len(self.ops["cid"])

    def op_tree(self, cid: int, op_id: int) -> Optional[Dict]:
        """One op's span tree as a plain dict (tests / debugging; the
        profiler folds the column arrays directly)."""
        o = self.ops
        sel = np.flatnonzero((o["cid"] == cid) & (o["op_id"] == op_id))
        if len(sel) == 0:
            return None
        r = int(sel[0])
        s = self.spans
        rows = np.flatnonzero((s["cid"] == cid) & (s["op_id"] == op_id))
        children = [dict(phase=int(s["phase"][i]),
                         label=self.label(int(s["label"][i])),
                         cause=self.cause(int(s["cause"][i])),
                         bg=bool(s["bg"][i]), t0=int(s["t0"][i]),
                         t1=int(s["t1"][i]), verbs=int(s["verbs"][i]),
                         ok_verbs=int(s["ok_verbs"][i]))
                    for i in rows]
        fl = self.flight_labels
        return dict(
            cid=cid, op_id=op_id,
            kind=fl[int(o["kind"][r])] if o["kind"][r] >= 0 else "?",
            status=fl[int(o["status"][r])] if o["status"][r] >= 0 else "",
            begin_tick=int(o["begin_tick"][r]),
            settle_tick=int(o["settle_tick"][r]), lat=int(o["lat"][r]),
            rtts=int(o["rtts"][r]), fg_spans=int(o["fg_spans"][r]),
            untraced=int(o["untraced"][r]), flags=int(o["flags"][r]),
            spans=children)


def _empty(cols) -> Dict[str, np.ndarray]:
    return {c: np.zeros(0, np.int64) for c in cols}


def _pack(cid: np.ndarray, op_id: np.ndarray, base: int) -> np.ndarray:
    """Collision-free composite (cid, op_id) key for searchsorted joins."""
    return cid.astype(np.int64) * base + op_id.astype(np.int64)


def build_spans(trace_ev: Dict[str, np.ndarray], trace_labels: List[str],
                flight_ev: Dict[str, np.ndarray],
                flight_labels: List[str], *,
                trace_dropped: int = 0,
                flight_dropped: int = 0) -> SpanSet:
    """Reconstruct span trees; one sort + segment passes, no per-op loops.

    ``trace_ev`` is ``VerbTracer.events()`` (or a loaded trace npz);
    ``flight_ev`` is ``FlightRecorder.events()`` (or a loaded dump).
    """
    cid_t = np.asarray(trace_ev["cid"], np.int64)
    opid_t = np.asarray(trace_ev["op_id"], np.int64)
    keep = (cid_t >= 0) & (opid_t >= 0)       # client-op-attributable rows

    f_et = np.asarray(flight_ev["etype"], np.int64)
    f_cid = np.asarray(flight_ev["cid"], np.int64)
    f_opid = np.asarray(flight_ev["op_id"], np.int64)
    base = int(max(opid_t.max(initial=0), f_opid.max(initial=0))) + 2

    # ---- span segmentation: one lexsort, one boundary pass --------------
    if keep.any():
        cid_k, opid_k = cid_t[keep], opid_t[keep]
        ph = np.asarray(trace_ev["phase"], np.int64)[keep]
        seq = np.asarray(trace_ev["seq"], np.int64)[keep]
        lab = np.asarray(trace_ev["label"], np.int64)[keep]
        cau = np.asarray(trace_ev["cause"], np.int64)[keep]
        bg = np.asarray(trace_ev["bg"], np.int64)[keep]
        tick = np.asarray(trace_ev["tick"], np.int64)[keep]
        ok = np.asarray(trace_ev["ok"], np.int64)[keep]

        order = np.lexsort((seq, ph, opid_k, cid_k))
        cid_k, opid_k, ph = cid_k[order], opid_k[order], ph[order]
        lab, cau, bg = lab[order], cau[order], bg[order]
        tick, ok = tick[order], ok[order]

        okey = _pack(cid_k, opid_k, base)
        skey = okey * (int(ph.max(initial=0)) + 2) + ph
        starts = np.flatnonzero(np.diff(skey, prepend=skey[0] - 1))
        spans = {
            "cid": cid_k[starts], "op_id": opid_k[starts],
            "phase": ph[starts], "label": lab[starts],
            # a migration window opening mid-phase stamps later verbs of
            # the phase mig_dual_write while earlier ones carry -1: the
            # span takes the max so the window is never lost
            "cause": np.maximum.reduceat(cau, starts),
            "bg": bg[starts],
            "t0": np.minimum.reduceat(tick, starts),
            "t1": np.maximum.reduceat(tick, starts),
            "verbs": np.diff(starts, append=len(skey)),
            "ok_verbs": np.add.reduceat(ok, starts),
        }
        span_okey = okey[starts]
        trace_t_oldest = int(np.asarray(trace_ev["tick"], np.int64).min()) \
            if trace_dropped > 0 else -1
    else:
        spans = _empty(_SPAN_COLS[:-1])
        span_okey = np.zeros(0, np.int64)
        trace_t_oldest = -1

    # ---- the op universe: every flight begin/settle row -----------------
    b_sel = f_et == EV_BEGIN
    s_sel = f_et == EV_SETTLE
    # settled ops (searchsorted join on the packed (cid, op_id) key)
    s_key = _pack(f_cid[s_sel], f_opid[s_sel], base)
    s_sort = np.argsort(s_key, kind="stable")
    s_key = s_key[s_sort]
    s_idx = np.flatnonzero(s_sel)[s_sort]
    # open ops = begins with no settle
    b_key = _pack(f_cid[b_sel], f_opid[b_sel], base)
    b_sort = np.argsort(b_key, kind="stable")
    b_key_s = b_key[b_sort]
    b_idx = np.flatnonzero(b_sel)[b_sort]
    pos = np.searchsorted(s_key, b_key_s)
    has_settle = (pos < len(s_key)) & (s_key[np.minimum(
        pos, max(len(s_key) - 1, 0))] == b_key_s) if len(s_key) else \
        np.zeros(len(b_key_s), bool)
    open_idx = b_idx[~has_settle]
    open_key = b_key_s[~has_settle]

    f_tick = np.asarray(flight_ev["tick"], np.int64)
    f_kind = np.asarray(flight_ev["kind"], np.int64)
    f_lat = np.asarray(flight_ev["lat"], np.int64)
    f_rtts = np.asarray(flight_ev["rtts"], np.int64)
    f_status = np.asarray(flight_ev["status"], np.int64)
    horizon = int(f_tick.max(initial=0))

    n_s, n_o = len(s_idx), len(open_idx)
    ops = {c: np.zeros(n_s + n_o, np.int64) for c in _OP_COLS}
    ops["cid"][:n_s] = f_cid[s_idx]
    ops["op_id"][:n_s] = f_opid[s_idx]
    ops["kind"][:n_s] = f_kind[s_idx]
    ops["status"][:n_s] = f_status[s_idx]
    ops["settle_tick"][:n_s] = f_tick[s_idx]
    ops["lat"][:n_s] = f_lat[s_idx]
    ops["rtts"][:n_s] = f_rtts[s_idx]
    ops["begin_tick"][:n_s] = f_tick[s_idx] - f_lat[s_idx]
    # exact begin ticks where the begin row survived the flight ring
    bpos = np.searchsorted(s_key, b_key_s[has_settle])
    np.put(ops["begin_tick"], bpos, f_tick[b_idx[has_settle]])
    ops["cid"][n_s:] = f_cid[open_idx]
    ops["op_id"][n_s:] = f_opid[open_idx]
    ops["kind"][n_s:] = f_kind[open_idx]
    ops["status"][n_s:] = -1
    ops["begin_tick"][n_s:] = f_tick[open_idx]
    ops["settle_tick"][n_s:] = horizon
    ops["lat"][n_s:] = horizon - f_tick[open_idx]
    ops["rtts"][n_s:] = -1                     # unknown until settle
    ops["flags"][n_s:] |= FLAG_OPEN

    op_key = np.concatenate([s_key, open_key])

    # ---- join spans -> ops, fold per-op observed counts -----------------
    if len(span_okey):
        o_sort = np.argsort(op_key, kind="stable")
        op_key_s = op_key[o_sort]
        pos = np.searchsorted(op_key_s, span_okey)
        posc = np.minimum(pos, max(len(op_key_s) - 1, 0))
        hit = (len(op_key_s) > 0) & (op_key_s[posc] == span_okey) \
            if len(op_key_s) else np.zeros(len(span_okey), bool)
        spans["op_row"] = np.where(hit, o_sort[posc], -1)
        fg = (spans["bg"] == 0).astype(np.int64)
        rows = spans["op_row"][hit]
        np.add.at(ops["fg_spans"], rows, fg[hit])
        np.add.at(ops["bg_spans"], rows, 1 - fg[hit])
    else:
        spans["op_row"] = np.zeros(0, np.int64)

    settled = ops["rtts"] >= 0
    ops["untraced"] = np.where(settled, ops["rtts"] - ops["fg_spans"], 0)
    ops["flags"] |= np.where(settled & (ops["untraced"] < 0), FLAG_OVER, 0)
    crashed_id = flight_labels.index("CRASHED") \
        if "CRASHED" in flight_labels else -2
    ops["flags"] |= np.where(ops["status"] == crashed_id, FLAG_CRASHED, 0)
    if trace_t_oldest >= 0:
        # ring wrapped: any op already in flight at the oldest retained
        # verb may have lost spans — partial, never silently mis-counted
        ops["flags"] |= np.where(ops["begin_tick"] <= trace_t_oldest,
                                 FLAG_PARTIAL, 0)

    return SpanSet(spans=spans, ops=ops, labels=list(trace_labels),
                   flight_labels=list(flight_labels),
                   trace_dropped=int(trace_dropped),
                   flight_dropped=int(flight_dropped))


def spans_from_cluster(cluster) -> SpanSet:
    """Build span trees from a live cluster: requires an attached verb
    tracer (``cluster.attach_tracer()``) and the default obs hub."""
    tr = cluster.pool._tracer
    if tr is None:
        raise ValueError("no tracer attached — call attach_tracer() before "
                         "profiling (the flight recorder alone has no "
                         "per-verb rows to fold)")
    obs = cluster.obs
    obs.flush()
    return build_spans(tr.events(), tr.labels, obs.flight.events(),
                       obs.labels(), trace_dropped=tr.dropped,
                       flight_dropped=obs.flight.dropped)


def spans_to_perfetto(ss: SpanSet, *, tick_us: float = 2.0) -> List[Dict]:
    """Chrome-trace events for the span layer: one nested ``X`` sub-span
    per executed phase under the op's lane (pid 1 / tid cid — Perfetto
    nests complete events by time containment), plus one instant per op
    carrying its untraced-RTT residual and flags.  Merge with
    ``export.flight_to_perfetto(..., spans=ss)``."""
    ev: List[Dict] = []
    s, o = ss.spans, ss.ops
    # The op's flight slice ends at its settle tick (dur == lat ticks),
    # but the final RTT's verbs execute *at* the settle tick — clamp span
    # extents into the parent slice so Perfetto's time-containment
    # nesting holds for the last phase too.
    orow = s["op_row"]
    joined = (orow >= 0) & (orow < ss.n_ops)
    cap = np.full(ss.n_spans, np.inf)
    cap[joined] = np.where(o["rtts"][orow[joined]] >= 0,
                           o["settle_tick"][orow[joined]].astype(float),
                           np.inf)
    for i in range(ss.n_spans):   # lint: allow-obs-loop (export path, not the fold; bounded by retained spans)
        cause = ss.cause(int(s["cause"][i]))
        name = ss.label(int(s["label"][i]))
        if cause:
            name = f"{name} [{cause}]"
        t0 = min(float(s["t0"][i]), cap[i] - 0.5)
        t1 = min(float(s["t1"][i]) + 0.5, cap[i])
        ev.append({
            "name": name, "cat": "phase", "ph": "X", "pid": 1,
            "tid": int(s["cid"][i]), "ts": t0 * tick_us,
            "dur": max(t1 - t0, 0.0) * tick_us,
            "args": {"op_id": int(s["op_id"][i]),
                     "phase": int(s["phase"][i]),
                     "cause": cause, "bg": bool(s["bg"][i]),
                     "verbs": int(s["verbs"][i]),
                     "ok_verbs": int(s["ok_verbs"][i])}})
    flagged = np.flatnonzero((o["untraced"] != 0) | (o["flags"] != 0))
    for r in flagged:   # lint: allow-obs-loop (export path; flagged ops only)
        r = int(r)
        ev.append({
            "name": UNTRACED, "cat": "phase", "ph": "i", "s": "t",
            "pid": 1, "tid": int(o["cid"][r]),
            "ts": int(o["settle_tick"][r]) * tick_us,
            "args": {"op_id": int(o["op_id"][r]),
                     "untraced_rtts": int(o["untraced"][r]),
                     "flags": int(o["flags"][r])}})
    return ev
