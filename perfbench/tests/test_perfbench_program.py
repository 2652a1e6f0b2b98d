"""``program.py``: a traced tiny CPU run with the program's recorder on
reads the program's spans and counters, whose spans nest with the
harness's and agree with them; the nested idle-gap attribution and
``launches_by_span`` on synthetic intervals; the harness's rule where no
program span is open; and a program without a recorder (an older one)
still runs, its readings None."""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_tiny as T  # noqa: E402
from perfbench import program, trace  # noqa: E402


def _tiny(seconds):
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return program.traced_run(T.cell(), 2 ** 31 + 7, seconds, "cpu",
                                  "cpu", T.PEAKS)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    t = _tiny(3.0)
    return t, program.read(t)


def test_traced_tiny_run_reads_the_program(tiny):
    t, out = tiny
    assert t.result["correct"] is True
    got = out["metrics"]
    assert got["decode_launch_ms"] > 0
    assert got["queue_wait_p90_ms"] > 0 and out["queued"]["n"] >= 10
    assert got["snapshot_epochs_per_insert_wave"] >= 1.0
    assert got["decode_launches_per_step"] is None     # no profile here
    assert "idle_gaps" not in out
    c = out["compare"]
    assert c["hits_counted"] == c["hits_of_requests"] > 0
    assert out["stamps"]["spans_per_decode_step"] == \
        7 + 3 * T.cell().config["num_hidden_layers"]


@pytest.mark.parametrize("mine,theirs,close", [
    ("serve.step", "perfbench.step", True),
    ("serve.admit", "perfbench.admit", True),
    ("serve.emit", "perfbench.emit", False),
    ("serve.prefill", "perfbench.prefill", True),
    ("serve.decode", "perfbench.decode", True)])
def test_program_spans_nest_with_the_harness_spans(tiny, mine, theirs,
                                                   close):
    """Each program span and its harness span nest (the engine's model
    call spans sit around the harness's wrappers of ``prefill`` and
    ``decode_step``, the others inside theirs), one for one, and their
    mean host times agree within 5%; but ``_emit``'s, ~0.1 ms on this
    cell, of which the wrapper's own stamps are some microseconds."""
    t, _ = tiny
    a = t.program.of(mine)
    b = t.spans.of(theirs)
    assert len(a) == len(b) > 0
    for s, w in zip(a, b):
        w0, w1 = int(w.t0 * 1e9), int(w.t1 * 1e9)
        assert (w0 <= s.t0 <= s.t1 <= w1) or (s.t0 <= w0 <= w1 <= s.t1)
    ms = np.mean([s.ms for s in a]), np.mean([1e3 * w.s for w in b])
    assert abs(ms[0] / ms[1] - 1) < (0.05 if close else 0.5)


def _recorder(monkeypatch, marks):
    from repro_torch.obs import serve as S
    clock = [0]
    monkeypatch.setattr(S, "_now", lambda: clock[0])
    tr = S.ServeTrace()
    tr.offset_ns = 1000            # epoch ns = perf ns + 1000
    open_ = []
    for m in marks:
        clock[0] = m[-1] - 1000
        if m[0] == "begin":
            open_.append(tr.begin(m[1]))
        else:
            tr.end(open_.pop())
    return tr


# a decode step whose card idles in its layers, then one the recorder
# missed; in epoch ns from the window's start at 1000
MARKS = [("begin", "serve.step", 1000), ("begin", "serve.decode", 1100),
         ("begin", "model.mix", 1200), ("end", 1400),
         ("begin", "model.ffn", 1400), ("end", 1700), ("end", 1800),
         ("end", 2000)]
OUTER = [(1000, 2000, trace.STEP), (1100, 1800, "perfbench.decode"),
         (2100, 2550, trace.STEP)]
DEV = [(1050, 1250, "k0"), (1350, 1450, "k1"), (1650, 1750, "k2"),
       (1950, 2150, "k3"), (2450, 2500, "k4")]
CALLS = [(1210, 1230, "cudaLaunchKernel"), (1420, 1440, "cuLaunchKernelEx"),
         (1500, 1520, "cudaLaunchKernelExC"), (1530, 1540, "cudaMemcpyAsync"),
         (1900, 1910, "cudaGraphLaunch"), (2200, 2300, "cudaLaunchKernel")]
WINDOW = [1000, 2700]


def test_nested_attribution_and_launches_by_span(monkeypatch):
    tr = _recorder(monkeypatch, MARKS)
    gaps, (mids, gap, k) = program.idle_gaps(DEV, CALLS, WINDOW, OUTER, tr)
    want = {"serve.step / python": 250e-9,        # [1000, 1050], [1750, 1950]
            "model.mix / python": 100e-9,                 # [1250, 1350]
            "model.ffn / python": 200e-9,                 # [1450, 1650]
            "perfbench.step / cudaLaunchKernel": 300e-9,  # [2150, 2450]
            "outside any span / python": 200e-9}          # [2500, 2700]
    assert gaps.keys() == want.keys()
    for key, v in want.items():
        assert gaps[key] == pytest.approx(v)
    assert program.launches_by_span(CALLS, tr) == {
        "model.mix": 1, "model.ffn": 2, "serve.step": 1,
        "outside any span": 1}
    under = program.under(tr, tr.innermost([c[0] for c in CALLS]),
                          "serve.decode")
    assert under.tolist() == [True, True, True, True, False, False]
    prof = SimpleNamespace(prof=object(), window=WINDOW)
    t = program.Traced({}, None, None, prof, tr)
    assert program.decode_launches(t, CALLS) == {"model.mix": 1,
                                                 "model.ffn": 2}
    assert program.decode_launches_per_step(t, CALLS) == 3
    assert program.decode_launch_ms(t) is None     # the profiler ran


def test_without_program_spans_the_harness_rule_holds(monkeypatch):
    """With no program span open (or none at all) every gap is named as
    ``trace._gaps`` names it."""
    w0 = WINDOW[0]
    rel = [(a - w0, b - w0, n) for a, b, n in DEV]
    iv = np.array([(a, b) for a, b, _ in rel], np.float64)
    theirs = trace._gaps(iv, WINDOW[1] - w0,
                         [(a - w0, b - w0, n) for a, b, n in OUTER],
                         [(a - w0, b - w0, n) for a, b, n in CALLS])
    empty = _recorder(monkeypatch, [])
    for prog in (None, empty):
        mine, _ = program.idle_gaps(DEV, CALLS, WINDOW, OUTER, prog)
        assert mine.keys() == theirs.keys()
        for key in mine:
            assert mine[key] == pytest.approx(theirs[key])


def test_a_program_without_the_recorder_still_runs(monkeypatch):
    from repro_torch.serving import ServeEngine
    monkeypatch.delattr(ServeEngine, "enable_trace")
    t = _tiny(1.0)
    assert t.program is None and t.result["correct"] is True
    assert program.read(t) == {"metrics": dict.fromkeys(
        ("decode_launch_ms", "decode_launches_per_step",
         "queue_wait_p90_ms", "snapshot_epochs_per_insert_wave"))}
    plain = T.run(T.cell(), traced=True, seconds=1.0)
    assert sorted(t.result["metrics"]) == sorted(plain["metrics"])
    assert sorted(t.result) == sorted(plain)
