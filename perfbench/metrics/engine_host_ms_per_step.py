"""Time of an engine step in which neither the pool's admission runs nor
the model's work runs on the card: the wall time of ``ServeEngine.step``
(the one span synchronised on both sides) less the host wall time of its
``_admit`` and the card's time for its ``prefill`` or ``decode_step``
(``Span.dev_s``), mean over the steps taken with the profiler off.  What
remains is the engine's own host work that the card waits on: building
the step's inputs and launching before the first kernel, and ``_emit``
and retiring after the last.  Layer: engine (``serving/engine.py``)."""

ADMIT = "perfbench.admit"
MODEL = ("perfbench.prefill", "perfbench.decode")


def read(run):
    steps = run.steady("perfbench.step")
    if not steps:
        return None
    inner = [(s, s.s) for s in run.spans.of(ADMIT)] + [
        (s, s.dev_s) for name in MODEL for s in run.spans.of(name)]
    rest = []
    for st in steps:
        rest.append(st.s - sum(t for s, t in inner
                               if s.t0 >= st.t0 and s.t1 <= st.t1))
    return 1e3 * sum(rest) / len(rest)


def explain(run):
    return f"over {len(run.steady('perfbench.step'))} steps"
