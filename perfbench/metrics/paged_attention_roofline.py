"""``paged_attention``'s share of its roofline: the kernel row's bound
(``count.paged_call``, one call per layer of each profiled decode step)
over the profiler's device time of the ``paged_split*`` and
``paged_combine*`` kernels (each call launches one of each).  Layer:
kernels (``csrc/paged_attention.cu``)."""

KERNELS = ("paged_split", "paged_combine")


def _parts(run):
    p = run.profile
    if not p:
        return None
    calls = run.spans.of("perfbench.decode", True)
    bound = sum(run.widths.layers * run.bound_s(
        run.count_paged(s.attrs["batch"], s.attrs["valid"])) for s in calls)
    names = [k for k in p["kernel_s"] if any(n in k for n in KERNELS)]
    dev = sum(p["kernel_s"][k] for k in names)
    launches = sum(p["kernel_calls"][k] for k in names)
    return bound, dev, launches, 2 * run.widths.layers * len(calls)


def read(run):
    parts = _parts(run)
    if not parts or parts[1] <= 0 or parts[2] != parts[3]:
        return None
    return 100.0 * parts[0] / parts[1]


def explain(run):
    parts = _parts(run)
    if not parts:
        return ""
    return (f"bound {parts[0]!r} s over {parts[1]!r} s of device time; "
            f"{parts[2]} launches traced for {parts[3]} calls counted")
