"""Exporters/loaders for the observability layer.

* ``flight_to_perfetto`` — Chrome-trace/Perfetto JSON from a flight
  recorder dump: op timelines (one lane per client), migration windows
  (one lane per region) and Alg-3 / §5.3 recovery spans, fault instants.
  Load the result at ``ui.perfetto.dev`` (or chrome://tracing).
* ``load_perfetto`` / ``load_flight`` / ``load_metrics`` — the matching
  loaders; tests round-trip every export through them.
* ``metrics_to_json`` — a registry snapshot (``cluster.metrics()``) to a
  stable JSON file (sorted keys, so same-seed runs produce byte-identical
  files).

Ticks convert to microseconds with the paper's verb RTT (one fleet tick =
one RTT beat, §6.1: ~2 us) so trace timelines are comparable to the
paper's latency numbers.

Counterpart of the JAX package's ``obs/export.py`` (plain numpy and json).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from .flight import (EV_BEGIN, EV_FAULT, EV_MIG, EV_RECOVERY, EV_REGIME,
                     EV_SETTLE, FIELDS, FlightRecorder)

__all__ = ["flight_to_perfetto", "load_perfetto", "load_flight",
           "metrics_to_json", "load_metrics", "TICK_US"]

TICK_US = 2.0      # FuseePaperConfig.rtt_us: one tick ~= one verb RTT


def load_flight(path: str) -> Dict:
    """Load a flight-recorder ``.npz`` dump (columns + labels)."""
    return FlightRecorder.load(path)


def metrics_to_json(snapshot: Dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(snapshot, f, sort_keys=True, separators=(",", ":"))
    return path


def load_metrics(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _label(labels: List[str], i: int) -> str:
    return labels[i] if 0 <= i < len(labels) else f"?{i}"


def flight_to_perfetto(dump: Dict, path: Optional[str] = None, *,
                       tick_us: float = TICK_US, spans=None) -> Dict:
    """Convert a flight dump (``load_flight`` dict, or a live
    ``FlightRecorder.events()`` dict plus ``labels``) into Chrome-trace
    JSON.  Writes to ``path`` when given; returns the trace dict.

    ``spans`` (a ``SpanSet`` from obs/spans.py) nests the causal
    phase-level sub-spans under the op lanes — same pid/tid, ``cat``
    "phase" — so Perfetto renders each op's protocol phases (and their
    retry causes) inside the op slice."""
    labels = dump.get("labels", [])
    cols = {f: np.asarray(dump[f], np.int64) for f in FIELDS}
    n = len(cols["tick"])
    ev: List[Dict] = []
    horizon = int(cols["tick"].max()) if n else 0

    et = cols["etype"]
    # --- op spans: begin matched to settle by (cid, op_id) -------------
    begins: Dict[tuple, int] = {}
    for i in np.nonzero(et == EV_BEGIN)[0]:
        begins[(int(cols["cid"][i]), int(cols["op_id"][i]))] = \
            int(cols["tick"][i])
    for i in np.nonzero(et == EV_SETTLE)[0]:
        cid, op_id = int(cols["cid"][i]), int(cols["op_id"][i])
        lat = int(cols["lat"][i])
        t0 = begins.pop((cid, op_id), int(cols["tick"][i]) - lat)
        ev.append({
            "name": _label(labels, int(cols["kind"][i])),
            "cat": "op", "ph": "X", "pid": 1, "tid": cid,
            "ts": t0 * tick_us, "dur": max(lat, 1) * tick_us,
            "args": {"op_id": op_id, "key": int(cols["key"][i]),
                     "rtts": int(cols["rtts"][i]),
                     "status": _label(labels, int(cols["status"][i]))
                     if cols["status"][i] >= 0 else ""}})
    for (cid, op_id), t0 in sorted(begins.items()):   # still in flight
        ev.append({"name": "in-flight", "cat": "op", "ph": "X",
                   "pid": 1, "tid": cid, "ts": t0 * tick_us,
                   "dur": max(horizon - t0, 1) * tick_us,
                   "args": {"op_id": op_id, "open": True}})

    # --- cluster events: faults, recovery spans, migration windows -----
    for i in np.nonzero(et == EV_FAULT)[0]:
        ev.append({"name": _label(labels, int(cols["kind"][i])),
                   "cat": "fault", "ph": "i", "s": "g",
                   "pid": 2, "tid": 0,
                   "ts": int(cols["tick"][i]) * tick_us,
                   "args": {"target": int(cols["arg"][i])}})
    for i in np.nonzero(et == EV_RECOVERY)[0]:
        rtts = int(cols["lat"][i])
        ev.append({"name": _label(labels, int(cols["kind"][i])),
                   "cat": "recovery", "ph": "X", "pid": 2, "tid": 1,
                   "ts": int(cols["tick"][i]) * tick_us,
                   "dur": max(rtts, 1) * tick_us,
                   "args": {"cid": int(cols["cid"][i]),
                            "arg": int(cols["arg"][i]), "rtts": rtts}})
    open_migs: Dict[int, int] = {}
    for i in np.nonzero(et == EV_MIG)[0]:
        region = int(cols["arg"][i])
        phase = _label(labels, int(cols["kind"][i]))
        tick = int(cols["tick"][i])
        if phase == "start":
            open_migs[region] = tick
        else:                        # cutover / abort closes the window
            t0 = open_migs.pop(region, tick)
            ev.append({"name": f"migrate r{region} ({phase})",
                       "cat": "migration", "ph": "X", "pid": 2,
                       "tid": 2 + region, "ts": t0 * tick_us,
                       "dur": max(tick - t0, 1) * tick_us,
                       "args": {"region": region, "phase": phase}})
    for region, t0 in sorted(open_migs.items()):
        ev.append({"name": f"migrate r{region} (open)",
                   "cat": "migration", "ph": "X", "pid": 2,
                   "tid": 2 + region, "ts": t0 * tick_us,
                   "dur": max(horizon - t0, 1) * tick_us,
                   "args": {"region": region, "phase": "open"}})

    # --- regime crossings from the hot-key monitor ---------------------
    for i in np.nonzero(et == EV_REGIME)[0]:
        ev.append({"name": f"regime: {_label(labels, int(cols['kind'][i]))}",
                   "cat": "regime", "ph": "i", "s": "g",
                   "pid": 2, "tid": 0,
                   "ts": int(cols["tick"][i]) * tick_us,
                   "args": {"theta_milli": int(cols["arg"][i]),
                            "imbalance_milli": int(cols["lat"][i])}})

    # --- causal phase sub-spans (opt-in: profiler attach) --------------
    if spans is not None:
        from .spans import spans_to_perfetto
        ev.extend(spans_to_perfetto(spans, tick_us=tick_us))

    # process naming metadata
    for pid, name in ((1, "clients"), (2, "cluster")):
        ev.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                   "args": {"name": name}})
    trace = {"traceEvents": sorted(
        ev, key=lambda e: (e.get("ts", 0), e.get("pid", 0),
                           e.get("tid", 0), e.get("name", ""))),
        "displayTimeUnit": "ms",
        "otherData": {"tick_us": tick_us, "events": n,
                      "dropped": int(dump.get("dropped", 0))}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f, separators=(",", ":"))
    return trace


def load_perfetto(path: str) -> Dict:
    """Load an exported Chrome-trace JSON back (round-trip check)."""
    with open(path) as f:
        trace = json.load(f)
    if "traceEvents" not in trace:
        raise ValueError(f"{path}: not a Chrome-trace JSON "
                         f"(missing traceEvents)")
    return trace
