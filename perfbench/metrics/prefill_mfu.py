"""The prefill's share of the card's peak: the counted bound of each
``Model.prefill`` call (``count.prefill``: the larger of its FLOPs at the
bf16 peak and its bytes at the HBM bandwidth; compute-bound at these
shapes, so the share of the FLOP peak) over the card's time for it
(``Span.dev_s``: CUDA events around the call, with no sync around it),
summed over the calls taken with the profiler off.  Layer: model step
(``models/model.py``, ``attention.py``, ``ffn.py``)."""


def _costs(run):
    calls = run.steady("perfbench.prefill")
    costs = [run.count_prefill(s.attrs["batch"], s.attrs["seq"])
             for s in calls]
    return calls, costs


def read(run):
    calls, costs = _costs(run)
    if not calls:
        return None
    return 100.0 * sum(run.bound_s(c) for c in costs) / sum(
        s.dev_s for s in calls)


def explain(run):
    calls, costs = _costs(run)
    if not calls:
        return ""
    c, s = costs[0], calls[0]
    return (f"{len(calls)} calls of {s.attrs['batch']} x {s.attrs['seq']}: "
            f"{c['flops']!r} FLOPs, {c['bytes']!r} bytes, bound "
            f"{run.bound_s(c)!r} s ({run.bound_kind(c)}), mean device time "
            f"{sum(x.dev_s for x in calls) / len(calls)!r} s")
