"""The decode step's share of its roofline peak: the counted bound of
each ``Model.decode_step`` call (``count.decode``: the larger of its FLOPs
at the bf16 peak and its bytes at the HBM bandwidth; memory-bound at
these shapes, so the share of the bandwidth) over the card's time for it
(``Span.dev_s``: CUDA events around the call, with no sync around it;
where the host launches slower than the card runs, the card's waits are
in it), summed over the calls taken with the profiler off.  Layer: model
step (``models/model.py``, ``attention.py``, ``ffn.py``)."""


def _costs(run):
    calls = run.steady("perfbench.decode")
    costs = [run.count_decode(s.attrs["batch"], s.attrs["valid"])
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
    c, s = costs[-1], calls[-1]
    return (f"{len(calls)} calls; the last, {s.attrs['batch']} rows over "
            f"{s.attrs['valid']} positions: {c['flops']!r} FLOPs, "
            f"{c['bytes']!r} bytes, bound {run.bound_s(c)!r} s "
            f"({run.bound_kind(c)}); mean device time "
            f"{sum(x.dev_s for x in calls) / len(calls)!r} s")
