#!/usr/bin/env python3
"""Run a checkout's ``chip_smoke.py`` with a host clock around every
``repro_torch.core.ordered.locate_leaves`` call of its YCSB-E phase.

    python3 tools/time_locates.py CHECKOUT [chip_smoke arguments]

``CHECKOUT`` is the root of any checkout of this repository whose port
has ``ordered.locate_leaves`` and whose ``chip_smoke.py`` has
``phase_ycsbe`` (this one, or an older one unpacked beside it).  The
script puts that checkout's ``src`` and ``tests`` first on the path, wraps
``locate_leaves`` (counting only while ``phase_ycsbe`` runs on the card),
runs the checkout's own ``chip_smoke.main`` with the given arguments, and
then prints one line to standard error (chip_smoke's standard output,
last line included, is left as it is):

    [locate] NAME: N calls, S s of host time, MS ms each

Two checkouts run this way in one call on one card give comparable host
times per locate: the same wrapper around the same entry point.  Exit
code: chip_smoke's.
"""
from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path


def main(argv) -> int:
    root = Path(argv[0]).resolve()
    sys.path[:0] = [str(root / "src"), str(root / "tests")]
    import repro_torch.core.ordered as O
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    acc = {"on": False, "calls": 0, "s": 0.0}
    orig_locate, orig_phase = O.locate_leaves, smoke.phase_ycsbe

    def locate_leaves(client, starts):
        t0 = time.perf_counter()
        out = orig_locate(client, starts)
        if acc["on"]:
            acc["s"] += time.perf_counter() - t0
            acc["calls"] += 1
        return out

    def phase_ycsbe(*args, **kw):
        acc["on"] = True
        try:
            return orig_phase(*args, **kw)
        finally:
            acc["on"] = False

    O.locate_leaves, smoke.phase_ycsbe = locate_leaves, phase_ycsbe
    rc = smoke.main(argv[1:])
    print(f"[locate] {root.name}: {acc['calls']} calls, {acc['s']:.3f} s of "
          f"host time, {1e3 * acc['s'] / max(acc['calls'], 1):.4f} ms each; "
          f"leaf_probe at one start, device ms: "
          f"{one_start(smoke) if rc == 0 else 'not measured'}",
          file=sys.stderr, flush=True)
    return rc


def one_start(smoke) -> str:
    """The checkout's ``leaf_probe`` at N = 1 against M seeded sorted lows,
    timed on the device by its chip_smoke's ``device_time_ms``: on device
    tensors, and, where the checkout's wrapper takes them, with the start
    and the answer in pinned host memory (how this tree's locate path
    launches it)."""
    import numpy as np
    import torch
    from repro_torch.kernels import leaf_probe
    rng = np.random.default_rng(0)
    out = []
    for m in (15, 1024, 3312, 35_000):
        lows = np.sort(rng.integers(0, 1 << 64, m, dtype=np.uint64))
        lw = torch.from_numpy(lows.view(np.int64)).cuda()
        one = torch.from_numpy(lows[m // 3:m // 3 + 1].view(np.int64))
        st = one.cuda()
        dev = smoke.device_time_ms(lambda: leaf_probe(st, lw))
        try:
            h_st = one.pin_memory()
            h_out = torch.empty(1, dtype=torch.int32).pin_memory()
            ms = smoke.device_time_ms(lambda: leaf_probe(h_st, lw, out=h_out))
            pinned = f"{ms:.6f}"
        except (TypeError, ValueError):
            pinned = "n/a"
        out.append(f"M={m} {dev:.6f} (pinned {pinned})")
    return ", ".join(out)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
