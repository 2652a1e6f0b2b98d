#!/usr/bin/env python3
"""Run a checkout's fleet phase of ``chip_smoke.py`` with a host clock
around every ``FleetEngine.probe_wave`` call, then time that checkout's
``race_lookup`` at the probe path's shapes.

    python3 tools/time_probes.py CHECKOUT [chip_smoke arguments]

``CHECKOUT`` is the root of any checkout of this repository whose
``chip_smoke.py`` has ``phase_build``, ``phase_fleet`` (returning the
cluster, the engine, the acknowledged writes, a capture whose ``rl``
holds the largest probe's keys and table, the launch counts and the phase
stats), ``phase_audit``, ``signature`` and ``device_time_ms`` (this one,
or an older one unpacked beside it).  The script puts that checkout's
``src`` and ``tests`` first on the path, wraps ``probe_wave``, runs those
three phases with the given arguments (chip_smoke's own lines go to
standard output) and prints one line to standard error:

    [probe] NAME: N probe_wave calls, S s of host time, MS ms each;
    signature sha1 H; race_lookup device ms at spb 8 ...; at spb 16 ...;
    launch floor F; probe per call P ms

The signature (pool bytes, health, op history and fleet counters after the
audit) must be equal for two checkouts of the same protocol.  The device
times go through the checkout's public wrapper ``race_lookup(keys,
table)``: N = 1 and 64 (the largest probe's first keys), that probe, and
65 536 keys (half drawn from it) against its table; the probe's N against
a (32 768, 16) table of 100 000 seeded keys.  "probe per call" is that
checkout's ``probe_to_host`` on the largest probe, from a Python list of
the folded keys to host answers (the list made into the argument that
tree's ``probe_to_host`` takes: a device tensor, or a numpy array).  Two
checkouts run this way in one call on one card give comparable numbers.
Exit code: 0, or 1 if a phase failed.
"""
from __future__ import annotations

import hashlib
import importlib.util
import sys
import time
from pathlib import Path


def main(argv) -> int:
    root = Path(argv[0]).resolve()
    sys.path[:0] = [str(root / "src"), str(root / "tests")]
    import torch
    import repro_torch.core.fleet as F
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    args = smoke.argparse.ArgumentParser()
    for flag, default in (("--keys", 100_000), ("--clients", 1024),
                          ("--value-words", 123), ("--ops-per-client", 16),
                          ("--e-keys", 40_000), ("--seed", 0)):
        args.add_argument(flag, type=int, default=default)
    args = args.parse_args(argv[1:])
    if not torch.cuda.is_available():
        print("time_probes: no CUDA device", file=sys.stderr)
        return 1
    acc = {"calls": 0, "s": 0.0}
    orig = F.FleetEngine.probe_wave

    def probe_wave(self, wants):
        t0 = time.perf_counter()
        out = orig(self, wants)
        acc["s"] += time.perf_counter() - t0
        acc["calls"] += 1
        return out

    F.FleetEngine.probe_wave = probe_wave
    try:
        smoke.phase_build()
        cl, fleet, acked, capture, _launches, _stats = smoke.phase_fleet(args)
    finally:
        F.FleetEngine.probe_wave = orig
    smoke.phase_audit(cl, fleet, acked)
    sig = hashlib.sha1(repr(smoke.signature(cl, fleet)).encode()).hexdigest()
    print(f"[probe] {root.name}: {acc['calls']} probe_wave calls, "
          f"{acc['s']:.3f} s of host time, "
          f"{1e3 * acc['s'] / max(acc['calls'], 1):.4f} ms each; signature "
          f"sha1 {sig}; {kernel_times(smoke, capture)}",
          file=sys.stderr, flush=True)
    return 0


def kernel_times(smoke, capture) -> str:
    import numpy as np
    import torch
    import repro_torch.core.api as api
    from repro_torch.core.shadow import build_shadow
    from repro_torch.kernels import race_lookup
    keys, table = capture.rl
    q_np = (keys.cpu().numpy() if torch.is_tensor(keys) else keys)
    q_np = q_np.astype(np.int64)
    rng = np.random.default_rng(17)
    dev = table.device
    q = torch.from_numpy(q_np).to(dev)
    big = np.where(rng.random(65536) < 0.5, rng.choice(q_np, 65536),
                   rng.integers(0, 1 << 32, 65536)).astype(np.int64)
    out = []
    for n, k in ((1, q[:1]), (64, q[:64]), (q.numel(), q),
                 (65536, torch.from_numpy(big).to(dev))):
        ms = smoke.device_time_ms(lambda: race_lookup(k, table))
        out.append(f"N={n} {ms:.6f}")
    stored = torch.from_numpy(rng.integers(0, 1 << 32, 100_000)).to(dev)
    t16 = build_shadow(stored, spb=16)
    k16 = torch.cat([stored[:q.numel() // 2], torch.from_numpy(
        rng.integers(0, 1 << 32, q.numel() - q.numel() // 2)).to(dev)])
    ms16 = smoke.device_time_ms(lambda: race_lookup(k16, t16))
    floor = smoke.device_time_ms(lambda: torch.cuda._sleep(0))
    q_list = q_np.tolist()
    if hasattr(api, "fold32"):                 # takes a numpy array
        def probe():
            return api.probe_to_host(np.array(q_list, np.int64), table)
    else:                                       # takes a device tensor
        def probe():
            return api.probe_to_host(
                torch.tensor(q_list, dtype=torch.int64, device=dev), table)
    per_call = smoke.time_ms(probe, iters=300)
    return (f"race_lookup device ms at spb {table.shape[1]} (table "
            f"{tuple(table.shape)}): " + ", ".join(out)
            + f"; at spb 16, N={k16.numel()}: {ms16:.6f}; launch floor "
            f"(torch.cuda._sleep(0)) {floor:.6f}; probe per call "
            f"{per_call:.5f} ms at N={q.numel()}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
