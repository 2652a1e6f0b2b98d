"""Critical-path RTT attribution over span trees (obs/spans.py).

``critical_path_report`` folds a ``SpanSet`` into the table the paper's
RTT arguments are made of: **where does each op kind spend its round
trips**, per protocol phase, per typed retry/stall cause — with a
conservation check that the attribution is exact, not approximate:

    for every settled op:
        foreground spans attributed + untraced residual == flight rtts

Violations (over-attribution — more spans than the op reports) are
counted and surfaced, never clamped; partial trees (wrapped verb ring)
are counted separately so a truncated profile is visibly truncated.

The fold is vectorized: groups are packed integer keys over
``(kind, phase-label, cause)``, per-group RTT counts come from
``np.unique``, and per-group p50/p99 of span *tick* durations come from
one lexsort + boundary gather.  The per-row assembly at the end walks
**groups** (taxonomy-bounded, dozens), not ops.

``tick_phase_report`` wraps ``FleetEngine.tick_phase_profile()`` — the
wall-clock coord-build / sweep / scatter / bookkeeping split of the fused
megakernel tick — so a fleet run's ms per tick decomposes into the same
report.  Wall-clock numbers never enter the metrics registry (same-seed
snapshots stay byte-identical); RTT attribution, by contrast, is exact
integer arithmetic and bit-identical across same-seed runs and devices.

Counterpart of the JAX package's ``obs/profile.py`` (plain numpy).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .spans import FLAG_OVER, FLAG_PARTIAL, UNTRACED, SpanSet

__all__ = ["critical_path_report", "format_report", "tick_phase_report"]


def _group_pct(dur: np.ndarray, inv: np.ndarray, n_groups: int, q: float
               ) -> np.ndarray:
    """Per-group q-quantile (nearest-rank) of ``dur`` — one lexsort."""
    order = np.lexsort((dur, inv))
    inv_s, dur_s = inv[order], dur[order]
    starts = np.searchsorted(inv_s, np.arange(n_groups))
    ends = np.searchsorted(inv_s, np.arange(n_groups), side="right")
    cnt = np.maximum(ends - starts, 1)
    at = starts + np.minimum((q * (cnt - 1)).astype(np.int64) + (
        ((q * (cnt - 1)) % 1) > 0).astype(np.int64), cnt - 1)
    return dur_s[np.minimum(at, len(dur_s) - 1)] if len(dur_s) else \
        np.zeros(n_groups, np.int64)


def critical_path_report(ss: SpanSet, *, include_bg: bool = False) -> Dict:
    """Fold span trees into the RTT-attribution report.

    Returns ``{"rows": [...], "conservation": {...}, "totals": {...}}``.
    Rows are ``(kind, phase, cause) -> rtts/share/dur_p50/dur_p99``,
    sorted by attributed RTTs descending; untraced residuals appear as
    ``(kind, "(untraced)", "")`` rows so every row set still sums to the
    ops' measured totals.  Only settled ops participate (open ops have no
    measured total to conserve against)."""
    s, o = ss.spans, ss.ops
    settled = o["rtts"] >= 0
    op_settled = np.zeros(ss.n_ops + 1, bool)
    op_settled[:-1] = settled

    sel = s["op_row"] >= 0
    sel &= op_settled[np.minimum(s["op_row"], ss.n_ops)]
    if not include_bg:
        sel &= s["bg"] == 0
    kind = o["kind"][s["op_row"][sel]]
    lab, cau = s["label"][sel], s["cause"][sel]
    dur = s["t1"][sel] - s["t0"][sel] + 1

    nl = len(ss.labels) + 1
    key = (kind * nl + lab) * (nl + 1) + (cau + 1)
    groups, inv, counts = np.unique(key, return_inverse=True,
                                    return_counts=True)
    p50 = _group_pct(dur, inv, len(groups), 0.50)
    p99 = _group_pct(dur, inv, len(groups), 0.99)

    g_cau = groups % (nl + 1) - 1
    g_lab = (groups // (nl + 1)) % nl
    g_kind = groups // (nl + 1) // nl

    fl = ss.flight_labels
    rows: List[Dict] = []
    for i in range(len(groups)):   # lint: allow-obs-loop (taxonomy-bounded group walk, not per-op)
        rows.append({
            "kind": fl[int(g_kind[i])] if 0 <= g_kind[i] < len(fl)
            else f"?{int(g_kind[i])}",
            "phase": ss.label(int(g_lab[i])),
            "cause": ss.cause(int(g_cau[i])) if g_cau[i] >= 0 else "",
            "rtts": int(counts[i]),
            "dur_p50": int(p50[i]), "dur_p99": int(p99[i]),
        })

    # untraced residuals, folded per kind (exact conservation filler)
    unt = np.where(settled, np.maximum(o["untraced"], 0), 0)
    uk = np.unique(o["kind"][unt > 0]) if ss.n_ops \
        else np.zeros(0, np.int64)
    for k in uk:   # lint: allow-obs-loop (one row per op kind, not per op)
        tot = int(unt[(o["kind"] == k) & settled].sum())
        rows.append({"kind": fl[int(k)] if 0 <= k < len(fl) else f"?{int(k)}",
                     "phase": UNTRACED, "cause": "", "rtts": tot,
                     "dur_p50": 0, "dur_p99": 0})

    attributed = int(counts.sum()) if len(counts) else 0
    untraced_total = int(unt.sum())
    total_rtts = int(o["rtts"][settled].sum())
    for r in rows:   # lint: allow-obs-loop (row list is taxonomy-bounded)
        r["share"] = r["rtts"] / total_rtts if total_rtts else 0.0
    rows.sort(key=lambda r: (-r["rtts"], r["kind"], r["phase"], r["cause"]))

    over = int((settled & (o["flags"] & FLAG_OVER > 0)).sum())
    partial = int((settled & (o["flags"] & FLAG_PARTIAL > 0)).sum())
    conservation = {
        "ops": int(settled.sum()),
        "total_rtts": total_rtts,
        "attributed_rtts": attributed,
        "untraced_rtts": untraced_total,
        "violations": over,
        "partial_ops": partial,
        # exact: every settled op's fg spans + untraced == its rtts, and
        # no op attributed more than it measured
        "ok": over == 0 and (not include_bg) and
        attributed + untraced_total == total_rtts,
    }
    if include_bg:
        # bg spans ride on top of the fg budget; the exact-sum identity
        # only holds for the foreground fold
        conservation["ok"] = over == 0
    return {"rows": rows, "conservation": conservation,
            "totals": {"spans": int(sel.sum()), "ops": ss.n_ops,
                       "open_ops": int((~settled).sum()),
                       "trace_dropped": ss.trace_dropped,
                       "flight_dropped": ss.flight_dropped}}


def format_report(report: Dict, *, top: Optional[int] = None) -> str:
    """Render the attribution rows as an aligned text table (drills/CLI)."""
    rows = report["rows"][:top] if top else report["rows"]
    head = f"{'kind':<14} {'phase':<22} {'cause':<14} " \
           f"{'rtts':>8} {'share':>7} {'p50':>5} {'p99':>5}"
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(f"{r['kind']:<14} {r['phase']:<22} {r['cause']:<14} "
                     f"{r['rtts']:>8} {r['share']:>6.1%} "
                     f"{r['dur_p50']:>5} {r['dur_p99']:>5}")
    c = report["conservation"]
    lines.append(f"conservation: {'OK' if c['ok'] else 'VIOLATED'} "
                 f"({c['attributed_rtts']} attributed + "
                 f"{c['untraced_rtts']} untraced = {c['total_rtts']} rtts "
                 f"over {c['ops']} ops; {c['violations']} violations, "
                 f"{c['partial_ops']} partial)")
    return "\n".join(lines)


def tick_phase_report(engine) -> Dict[str, float]:
    """The fused-megakernel tick decomposition (coord-build / sweep /
    scatter / bookkeeping) from a ``FleetEngine`` — see
    ``FleetEngine.tick_phase_profile``.  Re-exported here so profiling
    callers need only the obs package."""
    return engine.tick_phase_profile()
