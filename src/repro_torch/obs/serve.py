"""Wall-clock spans and counters of the serve path.

``ServeEngine.enable_trace`` creates one ``ServeTrace`` and hands it to
its ``Model``; until then both hold ``trace = None`` and every site of the
serve path costs one ``is None`` test.  The rest of ``obs/`` is the
fleet's deterministic tick-clock telemetry; this recorder is the serve
path's wall clock, for setting the host's work beside the device's.

Spans are rows of plain lists: a name, start and end in
``time.perf_counter_ns()``, the parent span (the innermost span open at
the start), the engine step, the request id where there is one, the
layer for the model's per-layer spans, and attributes given at the end.
Spans opened with ``begin`` nest; a request's ``serve.queue`` (submission
to the admission that gave it a slot) runs across steps and takes no part
in the nesting.  With ``events`` the spans opened with
``device=True`` also record a CUDA event pair on the current stream,
read once the card has passed it (``end_step``; an event is only queried,
never waited for).

``offset_ns`` (``time.time_ns() - time.perf_counter_ns()``, taken once at
creation) maps every stamp onto the epoch nanoseconds of
``torch.profiler``'s timeline, so ``innermost`` names the span the host
was in at any instant of a device trace.

Counters are ``Registry`` counters (counts only, so they keep that
module's determinism): prefix blocks searched, hit and missed; inserts
answered OK, lost (another page won the slot) and FULL; insert waves and
the SNAPSHOT epochs they took (the advance of ``pool.stats["epochs"]``
across each INSERT wave); and the launches of the kernels the engine
names (``launched``), the advance of each one's ``launches`` across every
step; and how each decode step ran (``Model.decode_step``):
``serve.decode.eager``, ``.graph_captures`` or ``.graph_replays``
(``DECODE_KINDS``, each present from the start).  A replayed step runs
no Python per layer: it is one ``serve.decode`` span with no ``model.*``
spans inside, and its kernels advance their ``launches`` by the launches
the captured graph holds (counted at the capture, not seen at the replay:
a profiler trace sees the replayed kernels), so the ``serve.launches.*``
counters count layers x steps as on an eager step.  The model's spans
are taken on the steps that run eagerly, a capture's eager first run
among them.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.events import OK
from .registry import Registry

STEP = "serve.step"
DECODE_KINDS = ("eager", "graph_captures", "graph_replays")   # serve.decode.*

_now = time.perf_counter_ns


class Span(NamedTuple):
    index: int
    name: str
    t0: int                 # perf_counter ns
    t1: int                 # -1 while open
    parent: int             # -1 at the root (and for queue spans)
    step: int
    rid: int                # -1 where no request
    layer: int              # -1 outside the model's layers
    attrs: Dict
    device_ms: Optional[float]   # the CUDA event pair's elapsed time

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6


class ServeTrace:
    """The serve path's spans and counters; see the module docstring."""

    def __init__(self, events: bool = False, launched: Sequence = ()):
        self.events = events
        self.launched = tuple(launched)     # kernels with a ``launches``
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.name: List[str] = []
        self.t0: List[int] = []
        self.t1: List[int] = []
        self.parent: List[int] = []
        self.step: List[int] = []
        self.rid: List[int] = []
        self.layer: List[int] = []
        self.attrs: List[Dict] = []
        self.nested: List[bool] = []
        self.device_ms: Dict[int, float] = {}
        self.registry = Registry()
        self.steps = -1             # the engine step being recorded
        self._stack: List[int] = [-1]           # -1: the root
        self._events: Dict[int, tuple] = {}       # span -> (start, end)
        self._queued: Dict[int, int] = {}         # id(req) -> queue span
        self._launch0 = (0,) * len(self.launched)
        for kind in DECODE_KINDS:           # present from the start, at 0
            self.registry.counter("serve.decode." + kind)

    # ------------------------------------------------------------ spans --
    def _open(self, name: str, parent: int, rid: int, layer: int,
              nested: bool) -> int:
        i = len(self.name)
        self.name.append(name)
        self.t0.append(_now())
        self.t1.append(-1)
        self.parent.append(parent)
        self.step.append(self.steps)
        self.rid.append(rid)
        self.layer.append(layer)
        self.attrs.append({})
        self.nested.append(nested)
        return i

    def begin(self, name: str, layer: int = -1, device: bool = False) -> int:
        """Open span ``name`` inside the innermost open one; returns its
        index for ``end``."""
        i = self._open(name, self._stack[-1], -1, layer, True)
        self._stack.append(i)
        if device and self.events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events[i] = (ev, None)
        return i

    def end(self, i: int, **attrs) -> None:
        """Close span ``i`` (the innermost open one) with ``attrs``."""
        if i in self._events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events[i] = (self._events[i][0], ev)
        self.t1[i] = _now()
        if attrs:
            self.attrs[i].update(attrs)
        self._stack.pop()

    def begin_step(self) -> int:
        self.steps += 1
        self._launch0 = tuple(k.launches for k in self.launched)
        return self.begin(STEP)

    def end_step(self, i: int, kind: str) -> None:
        """Close step span ``i``; count its kernel launches, and read the
        CUDA event pairs the card has passed."""
        for k, n0 in zip(self.launched, self._launch0):
            self.count("serve.launches." + k.__name__, k.launches - n0)
        for s, (a, b) in list(self._events.items()):
            if b is not None and b.query():
                self.device_ms[s] = a.elapsed_time(b)
                del self._events[s]
        self.end(i, kind=kind)

    # ------------------------------------------------------- requests --
    def submitted(self, req) -> None:
        """``req`` entered the queue: its queue span opens."""
        self._queued[id(req)] = self._open("serve.queue", -1, req.rid, -1,
                                           False)

    def admitted(self, reqs: Iterable) -> None:
        t = _now()
        for req in reqs:
            q = self._queued.pop(id(req), None)
            if q is not None:
                self.t1[q] = t
                self.attrs[q]["slot"] = req.slot

    # -------------------------------------------------------- counters --
    def count(self, name: str, n: int = 1) -> None:
        self.registry.counter(name).inc(n)

    def counters(self) -> Dict[str, int]:
        return self.registry.snapshot()["counters"]

    def admission(self, found: Optional[np.ndarray],
                  results: Optional[list], epochs: int) -> Dict:
        """Count an admission's SEARCH answers ``found``, its INSERT wave's
        ``results`` and the SNAPSHOT epochs that wave took (None and 0
        where there was no such wave); returns them as the admit span's
        attributes."""
        found = () if found is None else found
        results = results or ()
        hits = int(np.count_nonzero(found))
        ok = sum(r.status == OK for r in results)
        full = sum(r.page is None or r.page < 0 for r in results)
        out = {"blocks": len(found), "hits": hits,
               "misses": len(found) - hits, "inserts_ok": ok,
               "inserts_lost": len(results) - ok - full,
               "inserts_full": full, "epochs": epochs}
        self.count("serve.prefix.searched", len(found))
        self.count("serve.prefix.hits", hits)
        self.count("serve.prefix.misses", len(found) - hits)
        for k in ("ok", "lost", "full"):
            self.count("serve.insert." + k, out["inserts_" + k])
        self.count("serve.insert.waves", int(bool(results)))
        self.count("serve.snapshot.epochs", epochs)
        return out

    # --------------------------------------------------------- reading --
    def span(self, i: int) -> Span:
        return Span(i, self.name[i], self.t0[i], self.t1[i], self.parent[i],
                    self.step[i], self.rid[i], self.layer[i], self.attrs[i],
                    self.device_ms.get(i))

    def of(self, name: str) -> List[Span]:
        return [self.span(i) for i, n in enumerate(self.name) if n == name]

    def epoch_ns(self, t: int) -> int:
        """A ``perf_counter_ns`` stamp on the epoch-ns clock."""
        return t + self.offset_ns

    def innermost(self, epoch_ns) -> np.ndarray:
        """For each epoch-ns time, the index of the innermost nested span
        open there (the latest started still open), else -1."""
        t = np.asarray(epoch_ns, np.int64) - self.offset_ns
        idx = np.flatnonzero(np.asarray(self.nested, bool))
        if not len(idx):
            return np.full(t.shape, -1, np.int64)
        t0 = np.asarray(self.t0, np.int64)[idx]
        t1 = np.asarray(self.t1, np.int64)[idx]
        t1[t1 < 0] = np.iinfo(np.int64).max
        pos = np.full(len(self.name), -1, np.int64)
        pos[idx] = np.arange(len(idx))
        par = np.asarray(self.parent, np.int64)[idx]
        par = np.where(par >= 0, pos[np.maximum(par, 0)], -1)
        k = np.searchsorted(t0, t, side="right") - 1
        while True:           # climb out of the spans closed before t
            up = (k >= 0) & (t1[np.maximum(k, 0)] < t)
            if not up.any():
                break
            k[up] = par[k[up]]
        return np.where(k >= 0, idx[np.maximum(k, 0)], -1)
