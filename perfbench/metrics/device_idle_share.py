"""Share of the profiled waves' wall time in which no kernel, copy or
set ran on the card (``torch.profiler``, whole waves).  Layer: device."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def explain(run):
    p = run.profile
    return (f"busy {p['busy_s']!r} s of {p['window_s']!r} s profiled"
            if p else "")
