"""What a traced run records: spans from the benchmark's own wrappers
around the calls into each layer, and the device's timeline from
``torch.profiler`` over whole waves.

The wrappers are set on the engine and the model objects (instance
attributes), around ``ServeEngine.step`` and ``_admit``, ``_emit``,
``Model.prefill`` and ``Model.decode_step``.  Only the step's span
synchronises the card, before and after its call, and the engine's
``_emit`` already waits for the step's tokens, so the instrument adds no
wait of its own inside a step.  The spans inside a step take the host's
clock; around ``prefill`` and ``decode_step`` they also record a pair of
CUDA events on the stream, whose elapsed time (``dev_s``) is how long the
card took from reaching the call's first kernel to finishing its last.
Spans taken while the profiler runs are marked ``profiled``.

The profiler records the card's activity alone (kernels, copies, sets,
and the CUDA runtime calls that launched them), not every host op, so
that it slows the host little.  Its timestamps are the host's epoch
nanoseconds, which the spans also carry (``ns0``, ``ns1``), so
``profile_summary`` tells each idle gap of the card by the innermost span
and the runtime call open at its middle.  It reduces the raw events to
the device's busy time (the union of the intervals of every event on the
card), the window's length, and device time by kernel name.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

STEP = "perfbench.step"      # the span the others nest in


@dataclass
class Span:
    name: str
    t0: float                # perf_counter seconds
    t1: float
    ns0: int                 # epoch nanoseconds, the profiler's clock
    ns1: int
    attrs: Dict = field(default_factory=dict)
    profiled: bool = False
    events: Optional[tuple] = None   # CUDA events around a device call

    @property
    def s(self) -> float:
        return self.t1 - self.t0

    @property
    def dev_s(self) -> float:
        """The card's time from the call's first kernel to its last (its
        host wall time where no events were recorded).  Read once the
        card has passed the call."""
        if self.events is None:
            return self.s
        return self.events[0].elapsed_time(self.events[1]) * 1e-3


class Spans:
    """The spans of one run, and the wrappers that record them."""

    def __init__(self, sync: Callable[[], None], cuda: bool):
        self.sync = sync
        self.cuda = cuda
        self.spans: List[Span] = []
        self.profiling = False

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wrap(self, obj, attr: str, name: str,
             attrs: Optional[Callable] = None, sync: bool = False,
             device: bool = False):
        """Replace ``obj.attr`` by a timed call recording span ``name``;
        ``attrs(args, result)`` gives the span's attributes.  ``sync``:
        synchronise the card on both sides; ``device``: record CUDA
        events around the call."""
        fn = getattr(obj, attr)
        events = device and self.cuda

        def timed(*args, **kw):
            if sync:
                self.sync()
            ns0, t0 = time.time_ns(), time.perf_counter()
            ev0 = self._event() if events else None
            out = fn(*args, **kw)
            ev1 = self._event() if events else None
            if sync:
                self.sync()
            t1, ns1 = time.perf_counter(), time.time_ns()
            self.spans.append(Span(name, t0, t1, ns0, ns1,
                                   attrs(args, out) if attrs else {},
                                   self.profiling,
                                   (ev0, ev1) if events else None))
            return out
        setattr(obj, attr, timed)

    def of(self, name: str, profiled: Optional[bool] = None) -> List[Span]:
        return [s for s in self.spans if s.name == name
                and (profiled is None or s.profiled == profiled)]


class WaveProfiler:
    """``torch.profiler`` over whole waves: started before the step that
    admits the first, stopped before the step that would admit the wave
    after the last."""

    def __init__(self, spans: Spans, waves: int):
        self.spans = spans
        self.waves = waves
        self.prof = None
        self.window = None
        self.done = False

    @staticmethod
    def _profile():
        return torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def warm(self, fn: Callable[[], None]):
        """Run ``fn`` under a first, discarded profile: the profiler's own
        start-up (seconds on a card's first use) then stays in set-up."""
        with self._profile():
            fn()

    def start(self):
        self.prof = self._profile()
        self.prof.start()
        self.spans.sync()
        self.window = [time.time_ns(), None]
        self.spans.profiling = True

    def stop(self):
        if self.prof is None or self.done:
            return
        self.spans.sync()
        self.window[1] = time.time_ns()
        self.spans.profiling = False
        self.prof.stop()
        self.done = True

    def summary(self) -> Optional[Dict]:
        if self.prof is None:
            return None
        spans = [(s.ns0, s.ns1, s.name) for s in self.spans.spans
                 if s.profiled]
        return profile_summary(self.prof, self.window, spans)

    def before_step(self, admitting: bool, prefills: int):
        """Called before every step of the window."""
        if self.prof is None and admitting:
            self.start()
        elif (self.prof is not None and not self.done and admitting
              and prefills >= self.waves):
            self.stop()


def _union(iv: np.ndarray) -> float:
    """Total length of the union of intervals ``iv`` (n, 2), sorted."""
    total, end = 0.0, -np.inf
    for a, b in iv:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:160]


def profile_summary(prof, window, spans) -> Optional[Dict]:
    """Busy and window seconds, device seconds by kernel, idle gaps by
    host activity, from the profiler's raw events within ``window``
    (epoch ns); None without any device event there."""
    dev, ops = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() != torch.autograd.DeviceType.CPU:
            dev.append(item)
        else:
            ops.append(item)
    w0, w1 = window[0], window[1] - window[0]

    def rel(xs):            # integer ns from the window's start
        return [(a - w0, b - w0, n) for a, b, n in xs]
    dev = sorted(d for d in rel(dev) if d[0] >= 0 and d[1] <= w1)
    if not dev:
        return None
    spans, ops = rel(spans), rel(ops)
    iv = np.array([(a, b) for a, b, _ in dev], dtype=np.float64)
    busy = float(_union(iv)) * 1e-9
    by_kernel: Dict[str, float] = defaultdict(float)
    calls: Dict[str, int] = defaultdict(int)
    for a, b, n in dev:
        by_kernel[_short(n)] += (b - a) * 1e-9
        calls[_short(n)] += 1
    gaps = _gaps(iv, w1, spans, ops)
    return {"busy_s": busy, "window_s": w1 * 1e-9,
            "kernel_s": dict(by_kernel), "kernel_calls": dict(calls),
            "idle_gaps": gaps}


def _top_level(ops: List[tuple]) -> List[tuple]:
    out, end = [], -1
    for a, b, n in sorted(ops):
        if a >= end:
            out.append((a, b, n))
            end = b
    return out


def _lookup(ivals: List[tuple], at: np.ndarray, missing: str) -> List[str]:
    """For each time in ``at``, the name of the interval of ``ivals``
    (disjoint) open there, else ``missing``."""
    ivals = sorted(ivals)
    if not ivals:
        return [missing] * len(at)
    starts = np.array([a for a, _, _ in ivals], dtype=np.float64)
    ends = np.array([b for _, b, _ in ivals], dtype=np.float64)
    i = np.searchsorted(starts, at, side="right") - 1
    ok = (i >= 0) & (ends[np.maximum(i, 0)] >= at)
    return [ivals[j][2] if o else missing for j, o in zip(i, ok)]


def _gaps(iv, w1, spans, ops) -> Dict[str, float]:
    """Idle device time between busy intervals in the window [0, w1],
    summed by the innermost ``perfbench.`` span and the top-level host op
    open at its middle."""
    ends = np.maximum.accumulate(np.concatenate([[0.0], iv[:, 1]]))
    starts = np.concatenate([iv[:, 0], [w1]])
    gap = starts - ends
    keep = gap > 0
    mids = ((starts + ends) / 2)[keep]
    gap = gap[keep]
    outer = [s for s in spans if s[2] == STEP]
    inner = [s for s in spans if s[2] != STEP]
    where = [i if i != "-" else o for i, o in
             zip(_lookup(inner, mids, "-"),
                 _lookup(outer, mids, "outside any span"))]
    what = _lookup(_top_level(ops), mids, "python")
    out: Dict[str, float] = defaultdict(float)
    for a, b, g in zip(where, what, gap):
        out[f"{a} / {b}"] += g * 1e-9
    return dict(out)
