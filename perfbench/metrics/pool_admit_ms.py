"""Host wall time of each ``ServeEngine._admit`` that admitted at least
one request (the batched SEARCH through ``race_lookup``, the INSERT
wave's page allocation, page writes and SNAPSHOT epochs, which wait for
their answers), mean over the calls taken with the profiler off.  The
card is idle when it starts: the step before ended in ``_emit``'s wait
for its tokens.  Layer: FUSEE prefix-cache pool."""


def _calls(run):
    return [s for s in run.steady("perfbench.admit")
            if s.attrs.get("admitted", 0) > 0]


def read(run):
    calls = _calls(run)
    if not calls:
        return None
    return 1e3 * sum(s.s for s in calls) / len(calls)


def explain(run):
    return f"over {len(_calls(run))} admissions"
