"""A cell's traced run with the program's own recorder on, and what its
spans and counters read.

    python3 perfbench/program.py --workload <cell> --seed <n>
        --seconds <s> [--no-profiler]

A stand-in, until the benchmark's own traced run enables the recorder:
then ``idle_gaps`` and ``launches_by_span`` move into
``trace.profile_summary``, the four readings become ``metrics/`` readers,
and this file and its test go.  It reaches into the harness's private
``_instrument`` and ``trace``'s private helpers, so an edit to those
shows here first as a failure of ``tests/test_perfbench_program.py``.

The run is the benchmark's ``--trace 1`` run (``harness.execute``) with
``ServeEngine.enable_trace`` called where the harness sets its wrappers,
so the program's spans (``repro_torch/obs/serve.py``) and the harness's
(``trace.py``) record the same window.  Four readings of the program:

* ``decode_launch_ms``: mean host time of ``serve.decode`` (entry to
  return: every kernel enqueued, none waited for).  It is read only from
  a ``--no-profiler`` run: with the profiler, every unprofiled step
  follows the profiled waves and carries the profiler's after-cost, which
  grows with the launches a step makes; there it is None;
* ``decode_launches_per_step``: the profiler's CPU-side calls whose name
  has ``Launch`` in it (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
  ``cudaLaunchKernelExC``, ``cudaGraphLaunch``) made inside a profiled
  ``serve.decode``, per profiled ``serve.decode`` (so None in a
  ``--no-profiler`` run);
* ``queue_wait_p90_ms``: p90 of ``serve.queue`` over the requests
  submitted at or after the first unprofiled step that follows the
  profiled ones (None below 10 such requests);
* ``snapshot_epochs_per_insert_wave``: SNAPSHOT epochs per
  ``serve.admit.insert`` over the window's admissions.

Beside them it prints the profiled waves' idle gaps named by the
innermost program span open at each gap's middle (``idle_gaps``; where
none is open, by the harness's rule), the launch calls by the innermost
program span open at their start (``launches_by_span``), the recorder's
counters and cost, and how its spans compare with the harness's.  The
last line of standard output is a JSON object of all of it, with the
harness's result under ``result``.  Where the engine has no recorder (an
older program) the run goes on and every reading of the program is None.
The benchmark's own runs never enable the recorder.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUTSIDE = "outside any span"
MIN_QUEUED = 10


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Traced:
    result: Dict
    engine: object
    spans: object                   # the harness's ``trace.Spans``
    prof: object                    # its ``WaveProfiler``, or None
    program: object                 # the engine's ``ServeTrace``, or None

    @property
    def window(self) -> Optional[List[int]]:
        """The profiled window, epoch ns, where the profiler ran."""
        if self.prof is None or self.prof.prof is None:
            return None
        return self.prof.window

    def profiled(self, name: str) -> List[bool]:
        """For each program span ``name``, whether it started inside the
        profiled window."""
        w = self.window
        return [w is not None and w[0] <= self.program.epoch_ns(s.t0) <= w[1]
                for s in self.program.of(name)]

    def steady(self, name: str) -> list:
        """Program spans ``name`` taken with the profiler off."""
        return [s for s, p in zip(self.program.of(name),
                                  self.profiled(name)) if not p]


def traced_run(cell, seed: int, seconds: float, device: str, card: str,
               peaks: Dict, profile: bool = True) -> Traced:
    """``harness.execute``'s traced run with the recorder enabled (with
    CUDA event pairs on a card) right after the harness's wrappers.
    Without ``profile`` the wrappers take the host's clock alone and no
    profiler runs, so what the traced run's steps cost beyond an
    untraced run's is the wrappers' and the recorder's."""
    import torch
    from perfbench import harness
    box: Dict = {}
    inner = harness._instrument

    def instrument(engine, model, admits, mix, dev, sync):
        # the harness profiles and records events only on a CUDA device
        spans, prof = inner(engine, model, admits, mix,
                            dev if profile else torch.device("cpu"), sync)
        enable = getattr(engine, "enable_trace", None)
        box.update(engine=engine, spans=spans, prof=prof,
                   program=enable() if enable else None)
        return spans, prof

    harness._instrument = instrument
    try:
        result = harness.execute(cell, seed, seconds, True, device,
                                 time.perf_counter(), card, peaks)
    finally:
        harness._instrument = inner
    return Traced(result, **box)


def profile_events(prof) -> tuple:
    """The profiled window's device events and every CPU-side call, each
    ``(start, end, name)`` in epoch ns, from ``trace.WaveProfiler``."""
    import torch
    w0, w1 = prof.window
    dev, calls = [], []
    for e in prof.prof.profiler.kineto_results.events():
        item = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if item[0] >= w0 and item[1] <= w1:
                dev.append(item)
        else:
            calls.append(item)
    return sorted(dev), calls


def under(program, k: np.ndarray, name: str) -> np.ndarray:
    """Whether each program span index of ``k`` (-1: none) is span
    ``name`` or lies inside one."""
    par = np.asarray(program.parent, np.int64)
    is_name = np.asarray(program.name, object) == name
    hit = np.zeros(len(k), bool)
    cur = np.asarray(k, np.int64).copy()
    while (cur >= 0).any():
        on = cur >= 0
        hit[on] |= is_name[cur[on]]
        cur[on] = par[cur[on]]
    return hit


def idle_gaps(dev, calls, window, outer, program) -> tuple:
    """Idle device time in ``window`` (epoch ns) between the busy
    intervals of ``dev``, summed by ``"<span> / <host call>"``: the span
    is the innermost program span open at the gap's middle, or, where
    none is, the harness's rule (``trace._gaps``: the innermost
    ``perfbench.`` span of ``outer``, ``(start, end, name)`` in epoch ns),
    and the host call the top-level CPU-side call open there.  Returns the
    sums, and per gap its middle (epoch ns), length (ns) and program span
    (-1: none)."""
    from perfbench import trace
    w0, w1 = window[0], window[1] - window[0]

    def rel(xs):
        return [(a - w0, b - w0, n) for a, b, n in xs]
    iv = np.array([(a, b) for a, b, _ in rel(dev)], np.float64)
    ends = np.maximum.accumulate(np.concatenate([[0.0], iv[:, 1]]))
    starts = np.concatenate([iv[:, 0], [w1]])
    gap = starts - ends
    keep = gap > 0
    mids, gap = ((starts + ends) / 2)[keep], gap[keep]
    outer = rel(outer)
    step = [s for s in outer if s[2] == trace.STEP]
    inner = [s for s in outer if s[2] != trace.STEP]
    where = [i if i != "-" else o for i, o in
             zip(trace._lookup(inner, mids, "-"),
                 trace._lookup(step, mids, OUTSIDE))]
    what = trace._lookup(trace._top_level(rel(calls)), mids, "python")
    mids = mids.astype(np.int64) + w0
    k = (program.innermost(mids) if program is not None
         else np.full(len(mids), -1, np.int64))
    out: Dict[str, float] = defaultdict(float)
    for j, a, b, g in zip(k, where, what, gap):
        out[f"{program.name[j] if j >= 0 else a} / {b}"] += g * 1e-9
    return dict(out), (mids, gap, k)


def launches_by_span(calls, program) -> Dict[str, int]:
    """The CPU-side calls with ``Launch`` in their name, by the innermost
    program span open at their start."""
    k = program.innermost([a for a, _, n in calls if "Launch" in n])
    return dict(Counter(program.name[j] if j >= 0 else OUTSIDE for j in k))


# ------------------------------------------------------------ readings --
def decode_launch_ms(t: Traced) -> Optional[float]:
    """None where the profiler ran: its after-cost is in every step."""
    if t.window is not None:
        return None
    calls = t.program.of("serve.decode")
    return statistics.mean(s.ms for s in calls) if calls else None


def decode_launches(t: Traced, calls) -> Optional[Dict[str, float]]:
    """Launch calls inside the profiled ``serve.decode`` spans, per span,
    by the innermost program span open at their start."""
    n = sum(t.profiled("serve.decode"))
    if calls is None or not n:
        return None
    k = t.program.innermost([a for a, _, m in calls if "Launch" in m])
    k = k[under(t.program, k, "serve.decode")]
    return {name: c / n for name, c in
            Counter(t.program.name[j] for j in k).items()}


def decode_launches_per_step(t: Traced, calls) -> Optional[float]:
    by_span = decode_launches(t, calls)
    return sum(by_span.values()) if by_span is not None else None


def queued(t: Traced) -> list:
    """``serve.queue`` spans of the requests submitted at or after the
    first unprofiled step that follows the profiled ones (all of them
    where nothing was profiled)."""
    from perfbench import trace
    on = t.spans.of(trace.STEP, True)
    t_from = 0
    if on:
        after = [s.t0 for s in t.spans.of(trace.STEP, False)
                 if s.t0 > on[-1].t1]
        if not after:
            return []
        t_from = int(after[0] * 1e9)
    return [s for s in t.program.of("serve.queue")
            if s.t0 >= t_from and s.t1 >= 0]


def queue_wait_p90_ms(t: Traced) -> Optional[float]:
    waits = [s.ms for s in queued(t)]
    if len(waits) < MIN_QUEUED:
        return None
    return float(np.percentile(np.asarray(waits), 90))


def snapshot_epochs_per_insert_wave(t: Traced) -> Optional[float]:
    waves = t.program.of("serve.admit.insert")
    if not waves:
        return None
    return sum(s.attrs["epochs"] for s in waves) / len(waves)


def stamp_ns(pairs: int = 20000) -> float:
    """Host ns of one ``begin`` / ``end`` pair of the recorder."""
    from repro_torch.obs.serve import ServeTrace
    tr = ServeTrace()
    t0 = time.perf_counter_ns()
    for _ in range(pairs):
        tr.end(tr.begin("model.mix", 0))
    return (time.perf_counter_ns() - t0) / pairs


def _mean(xs) -> Optional[float]:
    xs = list(xs)
    return statistics.mean(xs) if xs else None


def _ratio(a, b) -> Optional[float]:
    return a / b if a is not None and b else None


def compare(t: Traced) -> Dict:
    """The program's spans against the harness's: host and device time
    of the model calls, the admissions' host time, and the hits counted
    against the requests' own."""
    out = {}
    for name in ("prefill", "decode"):
        mine = t.steady(f"serve.{name}")
        theirs = [s for s in t.spans.of(f"perfbench.{name}", False)]
        out[f"{name}_host_ratio"] = _ratio(
            _mean(s.ms for s in mine), _mean(1e3 * s.s for s in theirs))
        out[f"{name}_device_ratio"] = _ratio(
            _mean(s.device_ms for s in mine if s.device_ms is not None),
            _mean(1e3 * s.dev_s for s in theirs if s.events is not None))
    admits = [s for s in t.steady("serve.admit") if s.attrs["admitted"]]
    pool = t.result["metrics"].get("pool_admit_ms", {}).get("value")
    out["admit_host_ratio"] = _ratio(_mean(s.ms for s in admits), pool)
    eng = t.engine
    reqs = [r for r in eng.finished + list(eng.active.values()) if r.rid >= 0]
    out["hits_counted"] = t.program.counters().get("serve.prefix.hits", 0)
    out["hits_of_requests"] = sum(r.prefix_hits for r in reqs)
    return out


def decode_idle(t: Traced, gaps_detail) -> Optional[Dict]:
    """Idle time inside the profiled decode steps: in all, and the share
    under a program span other than ``serve.step``."""
    if gaps_detail is None:
        return None
    mids, gap, k = gaps_detail
    steps = [s for s in t.program.of("serve.step")
             if s.attrs.get("kind") == "decode"]
    a = np.array([t.program.epoch_ns(s.t0) for s in steps], np.int64)
    b = np.array([t.program.epoch_ns(s.t1) for s in steps], np.int64)
    i = np.searchsorted(a, mids, side="right") - 1
    inside = (i >= 0) & (b[np.maximum(i, 0)] >= mids)
    named = inside & (k >= 0) & (np.asarray(t.program.name, object)[
        np.maximum(k, 0)] != "serve.step")
    total = float(gap[inside].sum()) * 1e-9
    return {"idle_s": total, "named_share": float(gap[named].sum()) * 1e-9 /
            total if total else None}


def decode_kernels_per_step(t: Traced, dev) -> Optional[float]:
    """Device kernels (copies and sets left out) that started inside the
    profiled decode steps, per step."""
    w = t.window
    steps = [s for s in t.program.of("serve.step")
             if s.attrs.get("kind") == "decode"
             and w[0] <= t.program.epoch_ns(s.t0) <= w[1]]
    if not steps:
        return None
    a = np.array([t.program.epoch_ns(s.t0) for s in steps], np.int64)
    b = np.array([t.program.epoch_ns(s.t1) for s in steps], np.int64)
    st = np.array([x for x, _, n in dev
                   if not n.startswith(("Memcpy", "Memset"))], np.int64)
    i = np.searchsorted(a, st, side="right") - 1
    return float(((i >= 0) & (b[np.maximum(i, 0)] >= st)).sum()) / len(steps)


def read(t: Traced) -> Dict:
    """Every reading of the program in ``t`` (None where it has none)."""
    names = ("decode_launch_ms", "decode_launches_per_step",
             "queue_wait_p90_ms", "snapshot_epochs_per_insert_wave")
    if t.program is None:
        return {"metrics": dict.fromkeys(names)}
    ev = profile_events(t.prof) if t.window else None
    calls = ev[1] if ev else None
    out = {"metrics": {
        "decode_launch_ms": decode_launch_ms(t),
        "decode_launches_per_step": decode_launches_per_step(t, calls),
        "queue_wait_p90_ms": queue_wait_p90_ms(t),
        "snapshot_epochs_per_insert_wave":
            snapshot_epochs_per_insert_wave(t)},
        "compare": compare(t), "counters": t.program.counters()}
    q = [s.ms for s in queued(t)]
    out["queued"] = {"n": len(q),
                     "median_ms": statistics.median(q) if q else None}
    inserts = t.program.of("serve.admit.insert")
    out["insert_waves"] = {"n": len(inserts),
                           "keys": sum(s.attrs["keys"] for s in inserts)}
    decode_steps = {s.step for s in t.program.of("serve.decode")}
    nested = [st for st, ok in zip(t.program.step, t.program.nested)
              if ok and st in decode_steps]
    per = len(nested) / len(decode_steps) if decode_steps else 0
    out["stamps"] = {"spans_per_decode_step": per, "ns_per_span": stamp_ns()}
    out["stamps"]["us_per_decode_step"] = \
        per * out["stamps"]["ns_per_span"] * 1e-3
    if ev:
        outer = [(s.ns0, s.ns1, s.name) for s in t.spans.spans if s.profiled]
        gaps, detail = idle_gaps(ev[0], calls, t.window, outer, t.program)
        top = sorted(gaps.items(), key=lambda kv: -kv[1])
        out["idle_gaps"] = [[k, float(v)] for k, v in top[:16]]
        out["decode_idle"] = decode_idle(t, detail)
        out["launches_by_span"] = launches_by_span(
            [c for c in calls if t.window[0] <= c[0] <= t.window[1]],
            t.program)
        out["decode_kernels_per_step"] = decode_kernels_per_step(t, ev[0])
        out["decode_launches_by_span"] = decode_launches(t, calls)
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--no-profiler", action="store_true",
                    help="no profiler and no CUDA events in the harness's "
                    "wrappers: the steps' walls then carry only the "
                    "wrappers' and the recorder's cost")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from perfbench import peaks, run, spec
    run._environment()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("program.py: needs a CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    card = torch.cuda.get_device_name(0)
    cell.power_limit = peaks.power_limit()
    t = traced_run(cell, args.seed, args.seconds, "cuda:0", card,
                   peaks.peaks(card), profile=not args.no_profiler)
    out = read(t)
    for k, v in out["metrics"].items():
        log(f"[program] {k} = {v!r}")
    for k in ("compare", "queued", "insert_waves", "stamps", "decode_idle",
              "decode_kernels_per_step", "decode_launches_by_span",
              "launches_by_span", "counters"):
        log(f"[program] {k}: {out.get(k)!r}")
    for k, v in out.get("idle_gaps", []):
        log(f"[program] idle {k}: {float(v)!r} s")
    print(json.dumps({**out, "seed": args.seed, "card": card,
                      "power_limit": cell.power_limit,
                      "result": t.result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
