#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and then:

1. prints the card's name and power limit as ``nvidia-smi`` reports them;
2. holds each kernel bit for bit against its plain PyTorch version on edge
   inputs (keys 0, 2^31 and 2^32-1; slab words >= 2^63 and at the 32-bit
   boundary; zero-length and ragged read verbs);
3. drives the store at the paper's scale (``configs/fusee_paper.py``: 5 MNs,
   replication 2, 100 000 keys, 1 KiB KV pairs, zipf 0.99) with 1024
   clients through ``FleetEngine.submit_wave``: a preload, then YCSB-A, then
   YCSB-C.  The kernels' launch counts are set to 0 just before and read
   just after; both must be > 0.  Each kernel is then checked and timed on
   the inputs the run gave it;
4. audits the drained store: every acknowledged write reads back through GET
   with a value that may legally be last, and every key's index slot is
   identical on both replicas;
5. runs a small step-mode fault scenario (client crash, MN crash,
   auto-recovery, client recovery) on the card;
6. runs the same small seeded fleet run and fault scenario on ``cuda`` and on
   ``cpu`` and requires equal signatures (pool bytes, health, op history,
   counters, per-MN bytes);
7. fires ``add_mn`` under fleet load on the card, requires every read batch
   of the migration's dual-write windows and bulk copy to launch
   ``fleet_read`` once, and holds that run against the same run on ``cpu``.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as its
last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the last line.  It needs no network and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BW_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str):
    if not cond:
        raise SmokeFailure(what)


def log(msg: str):
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers
def zipf_keys(n_keys: int, theta: float, size: int, rng):
    import numpy as np
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    p = ranks ** (-theta)
    p /= p.sum()
    return rng.choice(n_keys, size=size, p=p)


def fleet_dmconfig(n_clients: int, n_keys: int, *, n_mns: int,
                   replication: int, objects: int = 0, obj_words: int = 8):
    """DMConfig sized for a fleet run: index slots >= 4x keys, a meta region
    covering every client's 64 words, >= 4 blocks of headroom per client
    (the JAX package's ``benchmarks/common.py::fleet_dmconfig`` rules), and
    data regions that hold at least 1.5x the ``objects`` of ``obj_words``
    words the run writes."""
    from repro_torch.core import DMConfig
    buckets = 256
    while buckets * 7 < 4 * n_keys:
        buckets *= 2
    region_words = 1 << 14
    while region_words < max(buckets * 7, n_clients * 64):
        region_words <<= 1
    block_words = 1 << 9
    bpr = region_words // (block_words + 1)
    regions_per_mn = max(8, -(-4 * n_clients // (bpr * n_mns)) + 1)
    cfg = DMConfig(num_mns=n_mns, replication=replication,
                   region_words=region_words, block_words=block_words,
                   regions_per_mn=regions_per_mn, index_buckets=buckets)
    if objects:
        per_block = cfg.block_payload_words // obj_words
        # one partly filled block per client on top of the packed ones
        blocks = -(-objects // per_block) + n_clients
        need = -(-3 * blocks // (2 * bpr * n_mns))
        cfg.regions_per_mn = max(cfg.regions_per_mn, need)
    return cfg


def time_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_time_ms(fn, iters: int = 50) -> float:
    """Device time per call: the stream is held in a sleep kernel while the
    host enqueues ``iters`` calls, so the events bracket the calls' device
    execution back to back and not the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)          # ~30 ms at H100 clocks
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def drive_waves(fleet, backends, plans, depth: int = 4) -> int:
    """Closed loop: refill every client to ``depth`` in-flight ops through
    ``submit_wave``, tick the fleet until the plans drain."""
    sched = fleet.sched
    cursor = [0] * len(plans)
    futs = []
    while True:
        wave = []
        for c, plan in enumerate(plans):
            room = depth - sched.inflight(c)
            if room > 0 and cursor[c] < len(plan):
                ops = plan[cursor[c]:cursor[c] + room]
                cursor[c] += len(ops)
                wave.append((backends[c], ops))
        if wave:
            for fs in fleet.submit_wave(wave):
                futs.extend(fs)
        if not sched.has_work():
            break
        fleet.tick()
    return futs


# ------------------------------------------------------------- signatures
def pool_bytes(cl) -> bytes:
    return b"".join(mn.regions[g].cpu().numpy().tobytes()
                    for mn in cl.pool.mns for g in sorted(mn.regions))


def signature(cl, fleet=None):
    h = cl.health()
    health = (h.epoch, h.tick, h.crashed_ops, h.client_recoveries,
              h.mn_recoveries,
              tuple((m.mid, m.alive, m.primary_regions, m.hosted_regions,
                     m.bytes_served) for m in h.mns),
              tuple((c.cid, c.status, c.epoch, c.inflight, c.cache_entries,
                     c.completed_ops, c.crashed_ops) for c in h.clients))
    history = tuple(
        (r.cid, r.op_id, r.kind, r.key, r.inv_tick, r.resp_tick, r.rtts,
         r.bg_rtts, r.result.status,
         tuple(r.result.value) if isinstance(r.result.value, list) else None)
        for r in cl.scheduler.history if r.result is not None)
    counters = {} if fleet is None else {
        k: v for k, v in fleet.stats().items()
        if k not in ("verbs_per_tick", "array_calls_per_tick")}
    return {"pool_bytes": pool_bytes(cl), "health": health,
            "history": history, "counters": counters,
            "mn_bytes": tuple(cl.pool.mn_bytes.tolist())}


# ---------------------------------------------------------- small scenarios
def small_fleet_run(device: str, seed: int = 3):
    """24 clients, 64 keys: preload, then YCSB-A through submit_wave."""
    import numpy as np
    from repro_torch.core import FuseeCluster, Op
    n_clients, n_keys = 24, 64
    cfg = fleet_dmconfig(n_clients, n_keys, n_mns=4, replication=2)
    cl = FuseeCluster(cfg, num_clients=n_clients, seed=seed, device=device)
    fleet = cl.fleet()
    backends = [cl.store(c, max_inflight=0).backend for c in range(n_clients)]
    drive_waves(fleet, backends, [[Op.insert(k, [k, c]) for k in
                                   range(c, n_keys, n_clients)]
                                  for c in range(n_clients)])
    wl = cl.rng.stream("workload")
    plans = [[] for _ in range(n_clients)]
    for i in range(n_clients * 8):
        key = int(wl.integers(n_keys))
        plans[i % n_clients].append(
            Op.update(key, [i, i]) if wl.random() < 0.5 else Op.get(key))
    drive_waves(fleet, backends, plans)
    check(np.all(cl.pool.mn_bytes >= 0), "negative byte counts")
    return cl, fleet


def fault_run(device: str, seed: int = 1):
    """Step-mode ops with a client crash + recovery and an MN crash with
    auto-recovery; the master's direct region access runs on ``device``."""
    from repro_torch.core import (ClientCrashed, DMConfig, FaultPlan,
                                  FuseeCluster, Op)
    n_clients = 6
    cl = FuseeCluster(DMConfig(num_mns=5, replication=2),
                      num_clients=n_clients, seed=seed, device=device)
    plan = FaultPlan()
    plan.crash_client(2, after_ops=25)
    plan.recover_client(2, reassign_to=3, after_ops=45)
    plan.crash_mn(1, after_ops=60)
    cl.inject(plan)
    stores = {c: cl.store(c) for c in range(n_clients)}
    wl = cl.rng.stream("workload")
    steps = cl.rng.stream("steps")
    futs = []
    for rnd in range(14):
        for c in range(n_clients):
            ops = []
            for j in range(4):
                r, key = wl.random(), int(wl.integers(40))
                ops.append(Op.put(key, [rnd, c, j]) if r < 0.45 else
                           Op.get(key) if r < 0.9 else Op.delete(key))
            try:
                futs += stores[c].submit_batch(ops)
            except ClientCrashed:
                pass
        for _ in range(40):
            cids = cl.scheduler.eligible_cids()
            if not cids:
                break
            cl.scheduler.step(cids[int(steps.integers(len(cids)))],
                              pick=int(steps.integers(4)))
    cl.drain()
    check(all(f.done() for f in futs), "fault run left unresolved futures")
    return cl, futs


class ReadWatch:
    """Checks, per ``pool.read_batch`` call, that a batch with a live verb
    launched ``fleet_read`` exactly once and one without launched nothing."""

    def __init__(self, pool):
        from repro_torch.kernels import fleet_read
        self.calls = self.bad = 0
        orig = pool.read_batch

        def read_batch(*args):
            before = fleet_read.launches
            out = orig(*args)
            live = any(r is not None for r in out)
            self.calls += live
            self.bad += (fleet_read.launches - before) != int(live)
            return out

        pool.read_batch = read_batch


def add_mn_run(device: str, seed: int = 11, watch=None):
    """16 clients, 96 keys, 3 MNs, 8 index shards: a preload, then 50/50
    updates and GETs through submit_wave with ``add_mn`` fired at tick 6,
    so index shards migrate under load.  While a dual-write window is open
    the fleet runs the per-kind batch verbs, whose READ (and the migration's
    bulk copy) goes through ``read_batch``."""
    import dataclasses
    from repro_torch.core import FuseeCluster, Op
    n_clients, n_keys = 16, 96
    cfg = dataclasses.replace(
        fleet_dmconfig(n_clients, n_keys, n_mns=3, replication=2),
        index_shards=8)
    cl = FuseeCluster(cfg, num_clients=n_clients, seed=seed, device=device)
    if watch is not None:
        watch = watch(cl.pool)
    fleet = cl.fleet()
    sched = cl.scheduler
    backends = [cl.store(c, max_inflight=0).backend for c in range(n_clients)]
    for k in range(n_keys):
        sched.submit(k % n_clients, "insert", k, [k])
    fleet.run()
    wl = cl.rng.stream("workload")
    plans = [[] for _ in range(n_clients)]
    for i in range(n_clients * 10):
        key = int(wl.integers(n_keys))
        plans[i % n_clients].append(
            Op.update(key, [i]) if wl.random() < 0.5 else Op.get(key))
    cursor, tick = [0] * n_clients, 0
    while True:
        wave = []
        for c in range(n_clients):
            room = 4 - sched.inflight(c)
            if room > 0 and cursor[c] < len(plans[c]):
                ops = plans[c][cursor[c]:cursor[c] + room]
                cursor[c] += len(ops)
                wave.append((backends[c], ops))
        if wave:
            fleet.submit_wave(wave)
        if tick == 6:
            cl.add_mn(wait=False)
        if not sched.has_work() and not cl.migrator.busy:
            break
        fleet.tick()
        tick += 1
    check(len(cl.pool.mns) == 4, "add_mn run: the MN did not join")
    return cl, fleet, watch


def compare(a: dict, b: dict, what: str):
    for k in a:
        check(a[k] == b[k], f"{what}: cuda and cpu differ in {k}")


# --------------------------------------------------------------- phases
def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {len(libs)} kernel libraries ready in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs.values()))


def phase_edge_checks(dev):
    import numpy as np
    import torch
    from repro_torch.core.shadow import build_shadow
    from repro_torch.kernels import (fleet_read, fleet_read_plain,
                                     race_lookup, race_lookup_plain)
    rng = np.random.default_rng(0)
    edge = np.array([0, 1 << 31, (1 << 32) - 1, (1 << 31) - 1, 1], np.int64)
    stored = np.concatenate([edge[:3], rng.integers(0, 1 << 32, 5000)])
    table = build_shadow(torch.tensor(stored, device=dev))
    q = torch.tensor(np.concatenate(
        [edge, stored[:2000], rng.integers(0, 1 << 32, 2000)]), device=dev)
    p_k, f_k = race_lookup(q, table)
    p_p, f_p = race_lookup_plain(q, table)
    torch.cuda.synchronize()
    check(torch.equal(p_k, p_p) and torch.equal(f_k, f_p),
          "race_lookup differs from its plain version on edge inputs")
    check(bool(f_k[:3].all()), "race_lookup missed a stored edge key")
    for spb in (1, 7, 16):                      # other row widths, tiny table
        t = build_shadow(torch.tensor(stored[:40], device=dev), spb=spb,
                         min_buckets=2)
        a, b = race_lookup(q, t), race_lookup_plain(q, t)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"race_lookup differs at spb={spb}")

    n = 4096
    words = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    words[::5] = (1 << 63) + np.arange(0, n, 5, dtype=np.uint64)
    words[1::7] = (1 << 32) - 1
    words[2::7] = 1 << 32
    words[3::11] = (1 << 64) - 1
    slab = torch.from_numpy(words.view(np.int64)).to(dev)
    lens = rng.integers(0, 200, 300)
    lens[::4] = 0                               # zero-length verbs
    lens[1::9] = 1
    base = rng.integers(0, n - 200, 300)
    start = np.concatenate([[0], np.cumsum(lens)])
    b_t = torch.tensor(base, dtype=torch.int64, device=dev)
    s_t = torch.tensor(start, dtype=torch.int64, device=dev)
    out_k = fleet_read(slab, b_t, s_t, int(start[-1]))
    out_p = fleet_read_plain(slab, b_t, s_t, int(start[-1]))
    torch.cuda.synchronize()
    check(torch.equal(out_k, out_p),
          "fleet_read differs from its plain version on edge inputs")
    want = np.concatenate([words[b:b + m] for b, m in zip(base, lens)])
    check(np.array_equal(out_k.cpu().numpy().view(np.uint64), want),
          "fleet_read differs from the host gather")
    empty = fleet_read(slab, b_t[:0], s_t[:1], 0)
    check(empty.numel() == 0, "fleet_read on zero verbs")
    log("[kernels] edge checks: race_lookup and fleet_read equal their "
        "plain versions bit for bit")


class Capture:
    """Keeps the largest inputs each kernel's wrapper saw during the main
    path (for the checks and timings at the path's own shapes).  It holds
    references, not copies, so the timed run does no extra device work: the
    port never writes a probe's keys or table, or a sweep's coordinates,
    after the call.  The wrappers themselves still launch and count."""

    def __init__(self):
        import repro_torch.core.api as api
        import repro_torch.core.heap as heap
        self.api, self.heap = api, heap
        self.orig_rl, self.orig_fr = api.race_lookup, heap.fleet_read
        self.rl = None
        self.fr = None
        self.rl_calls = self.fr_calls = 0

        def race_lookup(keys, table):
            self.rl_calls += 1
            if self.rl is None or keys.numel() > self.rl[0].numel():
                self.rl = (keys, table)
            return self.orig_rl(keys, table)

        def fleet_read(slab, base, start, total):
            self.fr_calls += 1
            if self.fr is None or total > self.fr[2]:
                self.fr = (base, start, total)
            return self.orig_fr(slab, base, start, total)

        api.race_lookup, heap.fleet_read = race_lookup, fleet_read

    def close(self):
        self.api.race_lookup = self.orig_rl
        self.heap.fleet_read = self.orig_fr


def phase_fleet(args, device="cuda"):
    import numpy as np
    import torch
    from repro_torch.configs import FuseePaperConfig
    from repro_torch.core import FuseeCluster, Op
    from repro_torch.kernels import KERNELS, reset_launches
    paper = FuseePaperConfig()
    n_keys = args.keys
    n_clients = args.clients
    vw = args.value_words
    opc = args.ops_per_client
    if n_keys != paper.ycsb_keys:
        log(f"[fleet] cut: {n_keys} keys instead of the paper's "
            f"{paper.ycsb_keys}")
    n_ops = n_clients * opc
    objects = n_keys + n_ops                  # preload + every A update
    cfg = fleet_dmconfig(n_clients, n_keys, n_mns=paper.num_mns,
                         replication=paper.replication, objects=objects,
                         obj_words=128)
    cl = FuseeCluster(cfg, num_clients=n_clients, seed=args.seed,
                      device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    pool = cl.pool
    slab_bytes = pool.slab.buf.numel() * pool.slab.buf.element_size()
    log(f"[fleet] {paper.num_mns} MNs, replication {paper.replication}, "
        f"{n_keys} keys, {vw}-word values (1 KiB KV pairs), zipf "
        f"{paper.zipf_theta}, {n_clients} clients; regions_per_mn "
        f"{cfg.regions_per_mn} x {cfg.region_words} words; slab on "
        f"{pool.slab.buf.device}: {slab_bytes} bytes "
        f"({slab_bytes / 2**30:.3f} GiB)")
    fleet = cl.fleet()
    backends = [cl.store(c, max_inflight=0).backend for c in range(n_clients)]
    wl = cl.rng.stream("workload")
    tag = iter(range(1, 1 << 62))
    acked = {}                                # key -> [(inv, resp, value)]

    def write_op(kind, key):
        return Op(kind, key, [next(tag)] + [key] * (vw - 1))

    def record(futs):
        for f in futs:
            r = f.result()
            rec = f.record
            if rec.kind in ("insert", "update"):
                check(r.status == "OK", f"{rec.kind} of {rec.key}: {r.status}")
                acked.setdefault(rec.key, []).append(
                    (rec.inv_tick, rec.resp_tick, rec.value[0]))
            else:
                check(r.status in ("OK", "NOT_FOUND"),
                      f"get of {rec.key}: {r.status}")

    def mix_plans(read_share):
        kinds = wl.random(n_ops) < read_share
        keys = zipf_keys(n_keys, paper.zipf_theta, n_ops, wl)
        plans = [[] for _ in range(n_clients)]
        for i in range(n_ops):
            k = int(keys[i])
            plans[i % n_clients].append(
                Op.get(k) if kinds[i] else write_op("update", k))
        return plans

    capture = Capture()
    reset_launches()
    sched = cl.scheduler
    stats = {}
    try:
        for name, plans in (
                ("preload", [[write_op("insert", k) for k in
                              range(c, n_keys, n_clients)]
                             for c in range(n_clients)]),
                ("ycsb_a", None), ("ycsb_c", None)):
            if plans is None:
                plans = mix_plans(0.5 if name == "ycsb_a" else 1.0)
            t_tick = fleet.stats()["ticks"]
            sync()
            t0 = time.perf_counter()
            futs = drive_waves(fleet, backends, plans)
            sync()
            dt = time.perf_counter() - t0
            record(futs)
            ticks = fleet.stats()["ticks"] - t_tick
            stats[name] = (len(futs), ticks, dt)
            log(f"[fleet] {name}: {len(futs)} ops in {ticks} ticks, "
                f"{dt:.2f} s, {len(futs) / dt:.0f} ops/s")
    finally:
        capture.close()
    launches = {k.__name__: k.launches for k in KERNELS}
    st = fleet.stats()
    log(f"[fleet] ticks {st['ticks']}, fused ticks {st['fused_ticks']}, "
        f"probe invocations {st['probe_invocations']}, probe hits "
        f"{st['probe_hits']}, kernel launches {launches}")
    prof = fleet.tick_phase_profile()
    log("[fleet] host time per tick: " + ", ".join(
        f"{k} {prof[k + '_frac']:.3f}" for k in
        ("coord_build", "sweep", "scatter", "bookkeeping"))
        + f" of {prof['us_per_tick']:.0f} us")
    return cl, fleet, acked, capture, launches, stats


def max_abs_err(a, b) -> int:
    """Largest absolute difference of two integer tensors (0 if empty)."""
    import torch
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def phase_kernel_timings(cl, capture, launches):
    import torch
    from repro_torch.kernels import (fleet_read, fleet_read_plain,
                                     race_lookup, race_lookup_plain)
    from repro_torch.core.shadow import bucket_pair
    rows = []
    # race_lookup at the largest probe the main path made
    q, table = capture.rl
    edge = torch.tensor([0, 1 << 31, (1 << 32) - 1], device=q.device)
    qe = torch.cat([q, edge])
    a, b = race_lookup(qe, table), race_lookup_plain(qe, table)
    torch.cuda.synchronize()
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "race_lookup differs from its plain version on the main path's "
          "inputs")
    ms = time_ms(lambda: race_lookup(q, table))
    dev_ms = device_time_ms(lambda: race_lookup(q, table))
    plain_ms = time_ms(lambda: race_lookup_plain(q, table))
    spb = table.shape[1]
    b1, b2 = bucket_pair(q, table.shape[0])
    rows_touched = int(torch.unique(torch.cat([b1, b2])).numel())
    nbytes = q.numel() * 8 + rows_touched * spb * 4 + q.numel() * (4 + 1)
    rows.append(dict(
        name="race_lookup", route="cuda",
        source="src/repro_torch/csrc/race_lookup.cu",
        replaces="src/repro/kernels/race_lookup/kernel.py:68",
        launches=launches["race_lookup"],
        max_abs_err=max_abs_err(a[0], b[0]),
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / MEM_BW_BYTES_PER_S, bound_by="bytes",
        library_ms=None))
    log(f"[kernels] race_lookup at the main path's largest probe: "
        f"{q.numel()} keys, table {tuple(table.shape)}, {rows_touched} rows "
        f"touched; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the "
        f"device), plain {plain_ms:.4f} ms, byte bound "
        f"{rows[-1]['bound_ms']:.6f} ms ({nbytes} B at 3.35 TB/s)")

    # fleet_read at the largest read sweep the main path made
    slab = cl.pool.slab.buf
    base, start, total = capture.fr
    out_k = fleet_read(slab, base, start, total)
    out_p = fleet_read_plain(slab, base, start, total)
    torch.cuda.synchronize()
    check(torch.equal(out_k, out_p), "fleet_read differs from its plain "
          "version on the main path's inputs")
    ln = start[1:] - start[:-1]
    addrs = (torch.repeat_interleave(base - start[:-1], ln,
                                     output_size=total)
             + torch.arange(total, device=slab.device))
    check(torch.equal(torch.take(slab, addrs), out_k), "torch.take differs")
    ms = time_ms(lambda: fleet_read(slab, base, start, total))
    dev_ms = device_time_ms(lambda: fleet_read(slab, base, start, total))
    plain_ms = time_ms(lambda: fleet_read_plain(slab, base, start, total))
    lib_ms = time_ms(lambda: torch.take(slab, addrs))
    distinct = int(torch.unique(addrs).numel())
    nverbs = base.numel()
    nbytes = nverbs * 8 + (nverbs + 1) * 8 + distinct * 8 + total * 8
    rows.append(dict(
        name="fleet_read", route="cuda",
        source="src/repro_torch/csrc/fleet_read.cu",
        replaces="src/repro/kernels/fleet_tick/kernel.py:38",
        launches=launches["fleet_read"],
        max_abs_err=max_abs_err(out_k, out_p),
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / MEM_BW_BYTES_PER_S, bound_by="bytes",
        library_ms=lib_ms))
    log(f"[kernels] fleet_read at the main path's largest read sweep: "
        f"{nverbs} verbs, {total} words; kernel {ms:.4f} ms per call "
        f"({dev_ms:.4f} ms on the device), plain "
        f"{plain_ms:.4f} ms, torch.take {lib_ms:.4f} ms, byte bound "
        f"{rows[-1]['bound_ms']:.6f} ms ({nbytes} B at 3.35 TB/s)")
    return rows


def phase_audit(cl, fleet, acked):
    import torch
    from repro_torch.core import Op
    n_clients = len(cl.clients)
    keys = sorted(acked)
    backends = [cl.store(c, max_inflight=0).backend for c in range(n_clients)]
    plans = [[Op.get(k) for k in keys[c::n_clients]] for c in range(n_clients)]
    futs = drive_waves(fleet, backends, plans)
    bad = 0
    for f in futs:
        key = f.record.key
        r = f.result()
        ws = acked[key]
        # a write may be last unless another acked write of the key was
        # invoked after it responded
        last_inv = max(inv for inv, _resp, _v in ws)
        legal = {v for inv, resp, v in ws if resp >= last_inv}
        if r.status != "OK" or not r.value or r.value[0] not in legal:
            bad += 1
    check(bad == 0, f"audit: {bad} of {len(futs)} keys lost an acked write")
    pool = cl.pool
    for g in pool.index_regions:
        reps = pool.placement[g]
        copies = [pool.mns[m].regions[g][:pool.cfg.index_words] for m in reps]
        for c in copies[1:]:
            check(torch.equal(copies[0], c),
                  f"index region {g}: replicas {reps} differ")
    reps = [pool.placement[g] for g in pool.index_regions]
    log(f"[audit] {len(futs)} keys read back their last acked write; index "
        f"slots identical on replicas {reps}")


def phase_migration():
    """add_mn under load on the card: every read batch of the dual-write
    windows (and of the bulk copy) launched fleet_read, and the run equals
    the same run on the CPU."""
    from repro_torch.kernels import KERNELS
    t0 = time.perf_counter()
    before = {k.__name__: k.launches for k in KERNELS}
    cl, fleet, watch = add_mn_run("cuda", watch=ReadWatch)
    launches = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    st = fleet.stats()
    check(st["fallback_ticks"] > 0, "add_mn run opened no dual-write window")
    check(watch.calls > 0, "add_mn run: no read batch had a live verb")
    check(watch.bad == 0, f"add_mn run: {watch.bad} read batches did not "
          "launch fleet_read exactly once")
    log(f"[migration] cuda add_mn run: {st['ticks']} ticks, "
        f"{st['fallback_ticks']} in dual-write windows, {watch.calls} read "
        f"batches each one fleet_read launch; launches {launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    a = signature(cl, fleet)
    c_cl, c_fleet, _ = add_mn_run("cpu")
    compare(a, signature(c_cl, c_fleet), "add_mn run")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=100_000)
    ap.add_argument("--clients", type=int, default=1024)
    ap.add_argument("--value-words", type=int, default=123)
    ap.add_argument("--ops-per-client", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found: run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    phase_build()
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    dev = torch.device("cuda")
    phase_edge_checks(dev)
    cl, fleet, acked, capture, launches, _stats = phase_fleet(args)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    check(capture.rl_calls == launches["race_lookup"]
          and capture.fr_calls == launches["fleet_read"],
          "a kernel wrapper was called without launching")
    rows = phase_kernel_timings(cl, capture, launches)
    phase_audit(cl, fleet, acked)
    del cl, fleet, capture
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cl_g, futs = fault_run("cuda")
    h = cl_g.health()
    check(h.mn_recoveries >= 1 and h.client_recoveries >= 1,
          "fault run: expected an MN recovery and a client recovery")
    statuses = [f.result().status for f in futs]
    log(f"[faults] cuda step-mode run: {len(futs)} ops "
        f"({statuses.count('OK')} OK, {statuses.count('CRASHED')} CRASHED), "
        f"{h.mn_recoveries} MN recovery, {h.client_recoveries} client "
        f"recovery, {time.perf_counter() - t0:.1f} s")
    cl_c, _ = fault_run("cpu")
    compare(signature(cl_g), signature(cl_c), "fault run")
    a = signature(*small_fleet_run("cuda"))
    b = signature(*small_fleet_run("cpu"))
    compare(a, b, "small fleet run")
    phase_migration()
    log("[parity] fault run, small fleet run and add_mn run: cuda and cpu "
        "signatures equal (pool bytes, health, history, counters, mn_bytes)")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
