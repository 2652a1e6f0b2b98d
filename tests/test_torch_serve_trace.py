"""The serve path's recorder (``repro_torch/obs/serve.py``) on the CPU.

A reduced llama3 engine serves six requests sharing a 64-token prefix
over two slots (so four of them queue), with the recorder on and off:
the span tree of its steps, the served tokens and the engine's and pool's
counters equal either way, nothing recorded or allocated with it off, no
synchronising call added with it on, the recorder's counters equal to
what ``_admit`` computed, every decode step counted as eager on the CPU,
and its epoch-ns mapping.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get, reduced
from repro_torch.models import build
from repro_torch.obs import serve as S
from repro_torch.serving import PoolConfig, Request, ServeEngine

CFG = reduced(get("llama3-8b"))


@pytest.fixture(scope="module")
def params():
    return build(CFG, device="cpu").init(seed=0)


def _serve(params, trace: bool):
    """Six requests (a shared 64-token prefix and 16 own tokens, 4 new
    each) through a fresh engine; returns it, its recorder and the
    pool's SNAPSHOT epochs before the first submission."""
    eng = ServeEngine(build(CFG, device="cpu"), params, max_batch=2,
                      max_len=128, pool_cfg=PoolConfig(
                          n_pages=256, n_buckets=64, slots_per_bucket=4))
    tr = eng.enable_trace() if trace else None
    epochs = eng.pool.stats["epochs"]
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 128, 64).astype(np.int32)
    for i in range(6):
        tail = rng.integers(0, 128, 16).astype(np.int32)
        eng.submit(Request(rid=i, prompt=np.concatenate([shared, tail]),
                           max_new=4))
    eng.run(max_ticks=60)
    return eng, tr, epochs


def _served(eng) -> dict:
    return {"requests": [(r.rid, r.out, r.prefix_hits, r.slot)
                         for r in eng.finished],
            "metrics": eng.metrics(), "health": eng.health(),
            "pool": dict(eng.pool.stats)}


PARENTS = {
    "serve.step": None, "serve.admit": "serve.step",
    "serve.admit.hash": "serve.admit", "serve.admit.search": "serve.admit",
    "serve.admit.insert": "serve.admit", "serve.prefill": "serve.step",
    "serve.decode": "serve.step", "serve.emit": "serve.step",
    "serve.emit.sync": "serve.emit",
    **{f"model.{m}": ("serve.prefill", "serve.decode")
       for m in ("embed", "select", "mix", "ffn", "head")}}


def test_span_tree_of_the_engine_steps(params):
    eng, tr, _ = _serve(params, True)
    n = len(tr.name)
    assert n and all(t1 >= t0 for t0, t1 in zip(tr.t0, tr.t1))
    for i in range(n):
        s = tr.span(i)
        if s.name == "serve.queue":
            assert s.parent == -1 and 0 <= s.rid < 6
            continue
        want = PARENTS[s.name]
        if want is None:
            assert s.parent == -1
            continue
        p = tr.span(s.parent)
        assert p.name in ((want,) if isinstance(want, str) else want)
        assert p.t0 <= s.t0 <= s.t1 <= p.t1 and p.step == s.step
    steps = tr.of("serve.step")
    assert [s.step for s in steps] == list(range(len(steps)))
    assert [s.attrs["kind"] for s in steps].count("prefill") == \
        len(tr.of("serve.prefill")) == 3          # 3 waves of 2
    assert len(tr.of("serve.decode")) == eng.steps - 3
    layers = CFG.n_layers
    for s in tr.of("serve.decode"):
        mix = [m.layer for m in tr.of("model.mix") if m.parent == s.index]
        assert mix == list(range(layers))
        assert s.attrs["batch"] == 2 and s.attrs["valid"] > 80
    queue = tr.of("serve.queue")
    assert sorted(s.rid for s in queue) == list(range(6))
    admits = [s for s in tr.of("serve.admit") if s.attrs["admitted"]]
    slots = {r.rid: r.slot for r in eng.finished}
    for q in queue:             # each ends inside the admission of its slot
        assert sum(a.t0 <= q.t1 <= a.t1 for a in admits) == 1
        assert q.attrs["slot"] == slots[q.rid]
    waits = sorted(s.ms for s in tr.of("serve.queue"))
    assert waits[3] > waits[1]        # the second and third waves queue


def test_served_tokens_and_counters_equal_on_and_off(params):
    on, _, _ = _serve(params, True)
    off, _, _ = _serve(params, False)
    assert _served(on) == _served(off)


def test_off_records_and_allocates_nothing(params, monkeypatch):
    def fail(*a, **kw):
        raise AssertionError("the recorder was reached while off")
    monkeypatch.setattr(S.ServeTrace, "__init__", fail)
    for name in ("begin", "end", "begin_step", "end_step", "submitted",
                 "admitted", "admission", "count"):
        monkeypatch.setattr(S.ServeTrace, name, fail)
    eng, tr, _ = _serve(params, False)
    assert tr is None and eng.trace is None and eng.model.trace is None
    assert len(eng.finished) == 6


SYNCS = ("cpu", "item", "tolist", "numpy", "__int__", "__float__",
         "__bool__")


def test_on_adds_no_synchronising_call(params, monkeypatch):
    """Calls that wait for the device (or read a tensor on the host) are
    as many with the recorder on as off."""
    calls = {}

    def counted(owner, name):
        fn = getattr(owner, name)

        def wrap(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(owner, name, wrap)
    for name in SYNCS:
        counted(torch.Tensor, name)
    counted(torch.cuda, "synchronize")
    counts = []
    for trace in (False, True):
        calls.clear()
        _serve(params, trace)
        counts.append(dict(calls))
    assert counts[0] == counts[1] and counts[0]["cpu"] > 0


class _Event:
    """A stand-in for ``torch.cuda.Event`` that counts what is asked of
    it; the card has always passed it."""
    asked: dict = {}

    def __init__(self, enable_timing=False):
        assert enable_timing

    def _ask(self, what):
        _Event.asked[what] = _Event.asked.get(what, 0) + 1

    def record(self):
        self._ask("record")

    def query(self):
        self._ask("query")
        return True

    def elapsed_time(self, other):
        self._ask("elapsed_time")
        return 2.5

    def synchronize(self):
        raise AssertionError("the recorder waited for an event")

    wait = synchronize


def test_event_pairs_are_read_after_the_step_without_waiting(params,
                                                             monkeypatch):
    """With ``events`` each model call records a pair, read at the end of
    its step by ``query`` and ``elapsed_time`` alone."""
    monkeypatch.setattr(S.torch.cuda, "Event", _Event)
    _Event.asked = {}
    eng = ServeEngine(build(CFG, device="cpu"), params, max_batch=2,
                      max_len=128, pool_cfg=PoolConfig(
                          n_pages=256, n_buckets=64, slots_per_bucket=4))
    eng.trace = eng.model.trace = tr = S.ServeTrace(events=True)
    eng.submit(Request(rid=0, prompt=np.arange(70, dtype=np.int32),
                       max_new=3))
    eng.run(max_ticks=10)
    calls = tr.of("serve.prefill") + tr.of("serve.decode")
    assert len(calls) == 3 and all(s.device_ms == 2.5 for s in calls)
    assert _Event.asked == {"record": 6, "query": 3, "elapsed_time": 3}
    assert not tr._events and tr.of("model.mix")[0].device_ms is None


def test_counters_equal_what_admit_computed(params):
    eng, tr, epochs = _serve(params, True)
    c = tr.counters()
    assert c["serve.prefix.hits"] == sum(r.prefix_hits for r in eng.finished)
    assert c["serve.snapshot.epochs"] == eng.pool.stats["epochs"] - epochs
    assert c["serve.prefix.hits"] > 0 and c["serve.snapshot.epochs"] > 0
    assert c["serve.prefix.searched"] == \
        c["serve.prefix.hits"] + c["serve.prefix.misses"] == 6
    assert c["serve.insert.ok"] + c["serve.insert.lost"] + \
        c["serve.insert.full"] == c["serve.prefix.misses"]
    waves = tr.of("serve.admit.insert")
    assert c["serve.insert.waves"] == len(waves)
    assert sum(s.attrs["epochs"] for s in waves) == c["serve.snapshot.epochs"]
    admits = [s for s in tr.of("serve.admit") if s.attrs["admitted"]]
    assert sum(s.attrs["hits"] for s in admits) == c["serve.prefix.hits"]
    assert sum(s.attrs["epochs"] for s in admits) == \
        c["serve.snapshot.epochs"]
    assert sum(s.attrs["admitted"] for s in admits) == 6
    launches = {k: n for k, n in c.items() if k.startswith("serve.launch")}
    assert launches == dict.fromkeys(
        ("serve.launches.race_lookup", "serve.launches.paged_attention",
         "serve.launches.flash_attention"), 0)        # none on the CPU


def test_decode_kind_counters_on_the_cpu(params):
    """The three counters of how a decode step ran are present from the
    recorder's start; on the CPU every decode step runs eagerly (no CUDA
    graph is captured or replayed), each with its model spans."""
    assert {k: v for k, v in S.ServeTrace().counters().items()
            if k.startswith("serve.decode.")} == dict.fromkeys(
        ("serve.decode.eager", "serve.decode.graph_captures",
         "serve.decode.graph_replays"), 0)
    eng, tr, _ = _serve(params, True)
    c = tr.counters()
    n = len(tr.of("serve.decode"))
    assert n == eng.steps - 3 and n > 0
    assert c["serve.decode.eager"] == n
    assert c["serve.decode.graph_replays"] == 0
    assert c["serve.decode.graph_captures"] == 0
    assert not eng.model._graphed and eng.model._graph is None


def test_epoch_ns_mapping_within_a_millisecond():
    tr = S.ServeTrace()
    i = tr.begin("serve.step")
    now = time.time_ns()
    tr.end(i)
    assert abs(tr.epoch_ns(tr.t0[i]) - now) < 1_000_000
    assert abs(tr.epoch_ns(tr.t1[i]) - now) < 1_000_000


def _synthetic(monkeypatch, marks):
    """A recorder built from ``marks``: ("begin", name, t) / ("end", t),
    perf ns equal to epoch ns."""
    clock = [0]
    monkeypatch.setattr(S, "_now", lambda: clock[0])
    tr = S.ServeTrace()
    tr.offset_ns = 0
    open_ = []
    for m in marks:
        clock[0] = m[-1]
        if m[0] == "begin":
            open_.append(tr.begin(m[1]))
        else:
            tr.end(open_.pop())
    return tr


MARKS = [("begin", "serve.step", 0), ("begin", "serve.decode", 10),
         ("begin", "model.mix", 20), ("end", 30), ("begin", "model.ffn", 40),
         ("end", 50), ("end", 60), ("begin", "serve.emit", 70), ("end", 90),
         ("end", 100), ("begin", "serve.step", 200), ("end", 210)]


@pytest.mark.parametrize("t,want", [
    (-5, None), (0, "serve.step"), (5, "serve.step"), (15, "serve.decode"),
    (25, "model.mix"), (30, "model.mix"), (35, "serve.decode"),
    (45, "model.ffn"), (55, "serve.decode"), (65, "serve.step"),
    (80, "serve.emit"), (150, None), (205, "serve.step"), (300, None)])
def test_innermost_span_open_at_a_time(monkeypatch, t, want):
    tr = _synthetic(monkeypatch, MARKS)
    tr.submitted(Request(rid=0, prompt=np.zeros(4, np.int32)))
    k = int(tr.innermost([t])[0])
    assert (tr.name[k] if k >= 0 else None) == want
