#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and then:

1. prints the card's name and power limit as ``nvidia-smi`` reports them;
2. holds each kernel bit for bit against its plain PyTorch version on edge
   inputs (keys 0, 2^31 and 2^32-1; slab words >= 2^63 and at the 32-bit
   boundary; zero-length and ragged read verbs; for ``leaf_probe`` starts
   and fence lows at 0, 2^31, 2^32-1, 2^32, 2^63-1, 2^63 and 2^64-2,
   duplicate lows, M = 0, 1 and 40 000, N = 1, 1000 and 4097);
3. drives the store at the paper's scale (``configs/fusee_paper.py``: 5 MNs,
   replication 2, 100 000 keys, 1 KiB KV pairs, zipf 0.99) with 1024
   clients through ``FleetEngine.submit_wave``: a preload, then YCSB-A, then
   YCSB-C.  The kernels' launch counts are set to 0 just before and read
   just after; both must be > 0.  Each kernel is then checked and timed on
   the inputs the run gave it;
4. audits the drained store: every acknowledged write reads back through GET
   with a value that may legally be last, and every key's index slot is
   identical on both replicas;
4b. runs YCSB-E over the ordered keydir on a cluster of its own (the same
   testbed with ``ordered_index=True``, sized for 100 000 keys, 1024
   clients): YCSB's load phase (``--e-keys`` keys, 40 000 by default, in
   hashed order, closed loop at 4 in flight per client), then 16 ops per client at depth 4 — 95% SCAN (zipf start,
   length 1..100), 5% INSERT of fresh keys.  The counts are set to 0
   before the load; ``leaf_probe`` and ``fleet_read`` must launch.  The
   audit (``tests/_torch_parity.py::ycsbe_audit``): every OK scan sorted,
   deduplicated and >= its start, and inside the loaded keys exactly the
   keydir's next keys with their values; the keydir holds no unacknowledged
   key and misses exactly as many acknowledged keys as the clients report
   dropped (``ord_full_drops``: the keydir protocol's losses, which
   ``tests/test_torch_ordered.py`` holds to the JAX package's; printed with
   the NOT_FOUND scans); the keydir replicas equal.  ``leaf_probe`` is then
   checked and timed on the run's largest locate wave beside
   ``torch.searchsorted``;
4c. runs ``tests/_torch_parity.py``'s small YCSB-E runs on ``cuda`` and on
   ``cpu``: one with a client crashed inside a leaf split (equal
   signatures, its audit on the card), and 4b's traffic at 64 clients and
   500 keys, where the keydir drops inserts (equal results, audits and
   signatures);
5. runs a small step-mode fault scenario (client crash, MN crash,
   auto-recovery, client recovery) on the card;
6. runs the same small seeded fleet run and fault scenario on ``cuda`` and on
   ``cpu`` and requires equal signatures (pool bytes, health, op history,
   counters, per-MN bytes);
7. fires ``add_mn`` under fleet load on the card, requires every read batch
   of the migration's dual-write windows and bulk copy to launch
   ``fleet_read`` once, and holds that run against the same run on ``cpu``;
8. holds ``flash_attention`` and ``paged_attention`` against their plain
   versions at the edges (bf16 and f32, GQA groups 1 and 4, ragged and
   page-edge lengths; run right after step 2);
9. serves llama3-8b at full width and depth (``configs/llama3_8b.py``, bf16
   weights drawn from ``--seed``) through ``ServeEngine`` over the FUSEE
   prefix-cache pool: 8 requests of a shared 1024-token system prompt plus
   128 tokens of their own, 16 new tokens each, max_batch 4.  The launch
   counts are set to 0 just before and read just after: one
   ``flash_attention`` launch per layer per (re)prefill, one
   ``paged_attention`` launch per layer per decode step, ``race_lookup``
   for the prefix SEARCH (a warm-up prefill and decode step at the run's
   shapes come first, outside the counts and the timed window).  It checks
   tokens, second-wave prefix hits and replica convergence, then holds each
   kernel against its plain version on the largest inputs the run gave it
   (``race_lookup``: equal ptr and found) and times each attention kernel
   there, beside ``scaled_dot_product_attention``; ``list_prefixes(0, 64)``
   must return the sorted block-hash keys that SEARCH finds, through one
   ``leaf_probe`` launch held against the plain version;
10. runs the engine scenario of ``tests/test_serving.py`` at reduced size in
   f32 (as defined in ``tests/_torch_parity.py``) on ``cuda`` and on
   ``cpu`` with the same weights and requires equal tokens, prefix hits,
   per-key SEARCH results and prefix listings.

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
def fleet_dmconfig(n_clients: int, n_keys: int, *, n_mns: int,
                   replication: int, objects: int = 0, obj_words: int = 8,
                   ordered: bool = False):
    """DMConfig sized for a fleet run: index slots >= 4x keys, a meta region
    covering every client's 64 words, >= 4 blocks of headroom per client,
    and with ``ordered`` the keydir region (every region raised until
    4·keys/13 + 4·clients + 64 leaves of 16 words fit) — the JAX package's
    ``benchmarks/common.py::fleet_dmconfig`` rules — and data regions that
    hold at least 1.5x the ``objects`` of ``obj_words`` words the run
    writes."""
    from repro_torch.core import DMConfig
    from repro_torch.core.ordered import LEAF_ENTRIES, LEAF_WORDS
    buckets = 256
    while buckets * 7 < 4 * n_keys:
        buckets *= 2
    region_words = 1 << 14
    while region_words < max(buckets * 7, n_clients * 64):
        region_words <<= 1
    if ordered:
        need_leaves = 4 * n_keys // LEAF_ENTRIES + 4 * n_clients + 64
        while region_words < need_leaves * LEAF_WORDS + 8:
            region_words <<= 1
    block_words = 1 << 9
    bpr = region_words // (block_words + 1)
    regions_per_mn = max(8, -(-4 * n_clients // (bpr * n_mns)) + 1)
    cfg = DMConfig(num_mns=n_mns, replication=replication,
                   region_words=region_words, block_words=block_words,
                   regions_per_mn=regions_per_mn, index_buckets=buckets,
                   ordered_index=ordered)
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
    from _torch_parity import drive_waves
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


LEAF_EDGES = [0, 1 << 31, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
              (1 << 64) - 2]


def phase_leaf_probe_edges(dev):
    """leaf_probe against its plain version, bit for bit, on the card:
    starts and lows at the 32- and 64-bit boundaries, duplicate lows,
    M = 0, 1 and 40 000, N = 1, 1000 and 4097."""
    import numpy as np
    import torch
    from repro_torch.kernels import leaf_probe, leaf_probe_plain
    rng = np.random.default_rng(1)
    edges = np.array(LEAF_EDGES, np.uint64)
    cases = 0
    for m in (0, 1, 40_000):
        lows = np.concatenate([rng.choice(edges, min(m, 7)),
                               rng.integers(0, 1 << 64, max(m - 7, 0),
                                            dtype=np.uint64)])
        if m > 7:
            lows[100:140] = lows[100]                 # a run of duplicates
        lows = np.sort(lows)
        for n in (1, 1000, 4097):
            starts = np.concatenate([edges, edges - np.uint64(1), lows[:64],
                                     rng.integers(0, 1 << 64, n,
                                                  dtype=np.uint64)])[:n]
            st = torch.from_numpy(starts.view(np.int64)).to(dev)
            lw = torch.from_numpy(lows.view(np.int64)).to(dev)
            got = leaf_probe(st, lw)
            want = leaf_probe_plain(st, lw)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"leaf_probe differs from its "
                  f"plain version at N={n}, M={m}")
            host = np.searchsorted(lows, starts, side="right") - 1
            check(np.array_equal(got.cpu().numpy(), host),
                  f"leaf_probe differs from the host searchsorted at N={n}, "
                  f"M={m}")
            if m == 0:
                check(bool((got == -1).all()), "leaf_probe with no lows")
            cases += 1
    log(f"[kernels] edge checks: leaf_probe equals its plain version bit for "
        f"bit in {cases} cases (starts and lows at 0, 2^31, 2^32-1, 2^32, "
        f"2^63-1, 2^63, 2^64-2; duplicate lows; M = 0, 1, 40000; N = 1, "
        f"1000, 4097)")


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
    from _torch_parity import drive_waves, zipf_keys
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
    from _torch_parity import drive_waves
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


# ------------------------------------------------------- YCSB-E (keydir)
class LeafCapture:
    """Keeps the largest ``leaf_probe`` inputs of the YCSB-E run (its
    largest locate wave) by reference — the port builds new starts and lows
    tensors for every call and never writes them afterwards — and counts
    the wrapper's calls."""

    def __init__(self):
        import repro_torch.core.ordered as O
        self.O, self.orig = O, O.leaf_probe
        self.big = None
        self.calls = 0

        def leaf_probe(starts, lows):
            self.calls += 1
            if self.big is None or starts.numel() > self.big[0].numel():
                self.big = (starts, lows)
            return self.orig(starts, lows)

        O.leaf_probe = leaf_probe

    def close(self):
        self.O.leaf_probe = self.orig


def _profile_delta(fleet, before):
    """``tick_phase_profile()`` split of the ticks since ``before``."""
    names = ("coord_build", "sweep", "scatter", "bookkeeping")
    now = fleet.tick_phase_profile()
    d = {k: now[k] - before[k] for k in names}
    total = sum(d.values())
    ticks = now["ticks"] - before["ticks"]
    return (", ".join(f"{k} {d[k] / total:.3f}" for k in names)
            + f" of {1e6 * total / max(ticks, 1):.0f} us per tick")


def phase_ycsbe(args, device="cuda"):
    """YCSB-E over the ordered keydir at the paper's cluster: a preload,
    then 95% SCAN (zipf start, length 1..100) / 5% INSERT of fresh keys.
    Returns the cluster, the leaf_probe capture and the launch counts."""
    import torch
    import repro_torch.core as T
    from _torch_parity import (drive_waves, ycsbe_audit, ycsbe_load_plans,
                               ycsbe_plans)
    from repro_torch.configs import FuseePaperConfig
    from repro_torch.core import FuseeCluster, Op, ordered
    from repro_torch.core.heap import get_word
    from repro_torch.kernels import KERNELS, reset_launches
    paper = FuseePaperConfig()
    n_keys, n_clients = args.e_keys, args.clients
    vw, opc = args.value_words, args.ops_per_client
    if n_keys != paper.ycsb_keys:
        log(f"[ycsbe] cut: a load of {n_keys} keys instead of the paper's "
            f"{paper.ycsb_keys}, on a cluster sized for {paper.ycsb_keys}")
    n_ops = n_clients * opc
    # the deployment is provisioned for the paper's key space whatever the
    # load: the keydir's region size decides how its protocol fails
    cfg = fleet_dmconfig(n_clients, paper.ycsb_keys, n_mns=paper.num_mns,
                         replication=paper.replication,
                         objects=paper.ycsb_keys + n_ops, obj_words=128,
                         ordered=True)
    cl = FuseeCluster(cfg, num_clients=n_clients, seed=args.seed,
                      device=device)
    pool = cl.pool
    g = pool.ordered_regions[0]
    slab_bytes = pool.slab.buf.numel() * pool.slab.buf.element_size()
    log(f"[ycsbe] {paper.num_mns} MNs, replication {paper.replication}, "
        f"{n_keys} keys, {vw}-word values, zipf {paper.zipf_theta}, "
        f"{n_clients} clients, ordered keydir region {g} of "
        f"{cfg.region_words} words ({ordered.max_leaves(cfg.region_words)} "
        f"leaves); regions_per_mn {cfg.regions_per_mn}; slab "
        f"{slab_bytes} bytes ({slab_bytes / 2**30:.3f} GiB)")
    fleet = cl.fleet()
    backends = [cl.store(c, max_inflight=0).backend for c in range(n_clients)]
    tag = iter(range(1, 1 << 62))
    values = {}

    def insert(key):
        v = [next(tag)] + [key] * (vw - 1)
        values[key] = v
        return Op.insert(key, v)

    capture = LeafCapture()
    reset_launches()
    try:
        sync = torch.cuda.synchronize
        sync()
        t0 = time.perf_counter()
        pre = drive_waves(fleet, backends, ycsbe_load_plans(
            n_keys, n_clients, args.seed, insert))
        sync()
        dt = time.perf_counter() - t0
        pre_ticks = fleet.stats()["ticks"]
        pre_drops = sum(c.ord_full_drops for c in cl.clients.values())
        log(f"[ycsbe] preload: {len(pre)} inserts in hashed key order, "
            f"closed loop at 4 in flight per client, {pre_ticks} ticks, "
            f"{dt:.2f} s, {len(pre) / dt:.0f} ops/s; {pre_drops} inserts "
            f"dropped from the keydir (ord_full_drops), "
            f"{get_word(pool.mns[pool.placement[g][0]].regions[g], 0)} leaves "
            f"allocated; host time per tick "
            + _profile_delta(fleet, {k: 0.0 for k in (
                "coord_build", "sweep", "scatter", "bookkeeping", "ticks")}))
        prof0 = fleet.tick_phase_profile()
        plans, n_scans = ycsbe_plans(T, cl.rng.stream("workload"), n_keys,
                                     n_clients, opc, insert,
                                     theta=paper.zipf_theta)
        loc0 = fleet.stats()["scan_locate_invocations"]
        sync()
        t0 = time.perf_counter()
        futs = drive_waves(fleet, backends, plans)
        sync()
        dt = time.perf_counter() - t0
    finally:
        capture.close()
    launches = {k.__name__: k.launches for k in KERNELS}
    st = fleet.stats()
    ticks = st["ticks"] - pre_ticks
    e_drops = sum(c.ord_full_drops for c in cl.clients.values()) - pre_drops
    log(f"[ycsbe] YCSB-E: {len(futs)} ops ({n_scans} scans, "
        f"{n_ops - n_scans} inserts, {e_drops} of them dropped "
        f"from the keydir) in {ticks} ticks, "
        f"{dt:.2f} s, {len(futs) / dt:.0f} ops/s; locate waves "
        f"{st['scan_locate_invocations'] - loc0} ({st['scan_locate_keys']} "
        f"starts), leaf verbs {st['ord_leaf_verbs']}; host "
        f"time per tick " + _profile_delta(fleet, prof0))
    log(f"[ycsbe] kernel launches over preload and run: {launches}")
    for k in ("leaf_probe", "fleet_read"):
        check(launches[k] > 0, f"kernel {k} was not launched on the YCSB-E "
              "path")
    check(capture.calls == launches["leaf_probe"],
          "leaf_probe was called without launching")
    a = ycsbe_audit(T, cl, n_keys, values, pre + futs)
    log(f"[audit] ycsbe: results {a['results']}; {a['scans_ok']} OK scans "
        f"sorted, deduplicated and >= start, {a['scans_exact']} of them "
        f"inside the preloaded keys equal to the keydir's next keys and "
        f"their values; keydir {a['keydir']} keys = {a['acked']} "
        f"acknowledged - {a['dropped']} dropped (ord_full_drops "
        f"{a['drops']}, {100 * a['dropped'] / max(a['acked'], 1):.2f}%); "
        f"{a['not_found']} scans NOT_FOUND; keydir replicas "
        f"{pool.placement[g]} identical")
    return cl, capture, launches


def leaf_probe_row(capture, launches):
    """leaf_probe held against its plain version and timed on the largest
    wave of the YCSB-E run, beside ``torch.searchsorted`` on the
    sign-flipped words (the library yardstick, never used by the port)."""
    import torch
    from repro_torch.kernels import leaf_probe, leaf_probe_plain
    from repro_torch.kernels.leaf_probe.ops import flip_sign
    starts, lows = capture.big
    got = leaf_probe(starts, lows)
    want = leaf_probe_plain(starts, lows)
    fs, fl = flip_sign(starts), flip_sign(lows)

    def library():
        return torch.searchsorted(fl, fs, right=True) - 1

    lib = library()
    torch.cuda.synchronize()
    check(torch.equal(got, want), "leaf_probe differs from its plain "
          "version on the YCSB-E run's largest wave")
    check(torch.equal(got.to(torch.int64), lib), "torch.searchsorted "
          "differs from leaf_probe")
    ms = time_ms(lambda: leaf_probe(starts, lows))
    dev_ms = device_time_ms(lambda: leaf_probe(starts, lows))
    plain_ms = time_ms(lambda: leaf_probe_plain(starts, lows), iters=20)
    lib_ms = time_ms(library)
    n, m = starts.numel(), lows.numel()
    nbytes = 8 * n + 8 * m + 4 * n
    row = dict(
        name="leaf_probe", route="cuda",
        source="src/repro_torch/csrc/leaf_probe.cu",
        replaces="src/repro/kernels/leaf_probe/kernel.py:36",
        launches=launches["leaf_probe"],
        max_abs_err=max_abs_err(got, want),
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / MEM_BW_BYTES_PER_S, bound_by="bytes",
        library_ms=lib_ms)
    log(f"[kernels] leaf_probe at the YCSB-E run's largest wave: {n} starts "
        f"over {m} fence lows; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms "
        f"on the device), plain {plain_ms:.4f} ms, torch.searchsorted "
        f"{lib_ms:.4f} ms, byte bound {row['bound_ms']:.6f} ms ({nbytes} B "
        f"at 3.35 TB/s); equal to the plain version and to searchsorted")
    return row


def phase_ycsbe_parity():
    """tests/_torch_parity.py's small YCSB-E fleet runs on ``cuda`` and on
    ``cpu``: the one with a client crashed inside a leaf split (equal
    signatures, the scenario's own audit on the card), and the YCSB-E
    phase's traffic at 64 clients where the keydir drops inserts (equal
    results, audits and signatures)."""
    import repro_torch.core as T
    from repro_torch.kernels import KERNELS
    from _torch_parity import (ycsbe_crash_audit, ycsbe_crash_scenario,
                               ycsbe_small_run)
    t0 = time.perf_counter()
    before = {k.__name__: k.launches for k in KERNELS}
    cl, fleet, crash, futs = ycsbe_crash_scenario(T, device="cuda")
    launches = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    check(crash is not None, "ycsbe parity run: no client was crashed "
          "inside a split")
    check(launches["leaf_probe"] > 0, "ycsbe parity run launched no "
          "leaf_probe")
    a = signature(cl, fleet)
    audit = ycsbe_crash_audit(T, cl, futs)      # its final scan adds ops
    c_cl, c_fleet, c_crash, _ = ycsbe_crash_scenario(T, device="cpu")
    check(c_crash == crash, "ycsbe parity run: the crash differs")
    compare(a, signature(c_cl, c_fleet), "ycsbe crash run")
    log(f"[parity] YCSB-E run with client {crash[1]} crashed inside a leaf "
        f"split at tick {crash[0]}: cuda and cpu signatures equal; audit "
        f"{audit}; cuda launches {launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    # the YCSB-E phase's traffic where the keydir loses acked inserts
    # (tests/test_torch_ordered.py holds the same run to the JAX package)
    t0 = time.perf_counter()
    cfg = fleet_dmconfig(64, 500, n_mns=5, replication=2, ordered=True)
    runs = [ycsbe_small_run(T, cfg, n_clients=64, n_keys=500,
                            ops_per_client=2, device=d)
            for d in ("cuda", "cpu")]
    (audit, res), cl, fleet = runs[0]
    check(audit["drops"] > 0, "ycsbe drop-regime run dropped no insert")
    check(res == runs[1][0][1] and audit == runs[1][0][0],
          "ycsbe drop-regime run: cuda and cpu results differ")
    compare(signature(cl, fleet), signature(*runs[1][1:]),
            "ycsbe drop-regime run")
    log(f"[parity] YCSB-E drop-regime run (64 clients, 500 keys): cuda and "
        f"cpu results and signatures equal; audit {audit}, "
        f"{time.perf_counter() - t0:.1f} s")


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


# ------------------------------------------------------------ serving path
PEAK_BF16_FLOPS = 989e12            # H100 SXM dense bf16, NVIDIA data sheet
SERVE_POOL = dict(n_pages=2048, n_buckets=512, slots_per_bucket=8,
                  replicas=3)       # examples/serve_fusee.py's pool


def check_close(got, want, bound, what: str):
    """|got - want| <= bound everywhere; returns the largest share of the
    bound used, the max absolute error and the mean |want| (the typical
    output, printed beside the error)."""
    err = (got.float() - want.float()).abs()
    typical = float(want.float().abs().mean().item())
    worst = int((err - bound).argmax().item())
    check(bool((err <= bound).all()),
          f"{what}: kernel and plain version differ by "
          f"{err.flatten()[worst].item():.3g} where the bound is "
          f"{bound.flatten()[worst].item():.3g} (max abs err "
          f"{err.max().item():.3g}, mean |ref| {typical:.3g})")
    used = float((err / bound).nan_to_num(0.0).max().item())
    return used, float(err.max().item()), typical


def check_attn(kernel, plain, q, k, v, *rest, what: str, **kw):
    """``kernel`` against ``plain`` on (q, k, v, *rest) within
    ``attn_bound`` (tests/_torch_parity.py: 2e-5 in f32; in bf16 one
    rounding of the output and of each attention weight)."""
    from _torch_parity import attn_bound
    want = plain(q, k, v, *rest, **kw)
    out = kernel(q, k, v, *rest, **kw)
    bound = attn_bound(want, plain(q, k, v.abs(), *rest, **kw))
    return (out,) + check_close(out, want, bound, what)


def phase_serve_edge_checks(dev):
    """(a) both attention kernels against their plain versions on the card
    at the edges: bf16 and f32, GQA groups 1 and 4, ragged and page-edge
    lengths; and the bf16 flash kernel on inputs whose attention weights
    are exact, where one key too many or too few in a row would show."""
    import torch
    from _torch_parity import uniform_attn_inputs
    from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                     paged_attention, paged_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s, dt: torch.randn(s, generator=gen, device=dev).to(dt)
    worst = {}

    def note(name, dt, res):
        used, err, typical = res[-3:]
        key = f"{name} {str(dt).split('.')[-1]}"
        w = worst.get(key, (0.0, 0.0, float("inf")))
        worst[key] = (max(w[0], used), max(w[1], err), min(w[2], typical))
    for dt in (torch.bfloat16, torch.float32):
        for kv in (4, 1):                          # G = 1 and G = 4
            cases = [(s, s, c) for s in (1, 63, 65, 1152)
                     for c in (True, False)] + [(65, 300, False),
                                                (300, 65, False)]
            for sq, skv, causal in cases:
                q = rnd(1, 4, sq, 128, dt=dt)
                k, v = rnd(1, kv, skv, 128, dt=dt), rnd(1, kv, skv, 128, dt=dt)
                what = (f"flash_attention {dt} G={4 // kv} Sq={sq} "
                        f"Skv={skv} causal={causal}")
                note("flash_attention", dt, check_attn(
                    flash_attention, flash_attention_plain, q, k, v,
                    causal=causal, what=what))
                if dt == torch.bfloat16:
                    qu, vu = uniform_attn_inputs(q, v)
                    want = flash_attention_plain(qu, k, vu, causal=causal)
                    note("flash_attention uniform", dt, check_close(
                        flash_attention(qu, k, vu, causal=causal), want,
                        1e-4 + 2 ** -7 * want.float().abs(),
                        what + " (uniform weights)"))
        nb, tb = 2, 1024
        for H in (8, 32):                          # G = 1 and G = 4
            q = rnd(4, H, 128, dt=dt)
            kc, vc = (rnd(nb, tb, 4, 8, 128, dt=dt) for _ in range(2))
            for vl in (1, tb - 1, tb, tb + 1, nb * tb):
                note("paged_attention", dt, check_attn(
                    paged_attention, paged_attention_plain, q, kc, vc, vl,
                    what=f"paged_attention {dt} G={H // 8} valid_len={vl}"))
    torch.cuda.synchronize()
    log(f"[serve] edge checks: flash_attention (bf16/f32, G 1/4, Sq=Skv in "
        f"1/63/65/1152 causal and not, Sq != Skv) and paged_attention "
        f"(bf16/f32, G 1/4, valid_len 1/1023/1024/1025/2048) within "
        f"tolerance of their plain versions (f32: 2e-5 + 2e-5 x |ref|; "
        f"bf16: 2^-7 x |ref| + 2^-8 x the weighted mean of |v|, and 1e-4 + "
        f"2^-7 x |ref| with exact weights); largest share of the bound, max "
        f"abs err, smallest mean |ref| of a case: " + "; ".join(
            f"{k} {u:.3f}, {e:.3g}, {t:.3g}"
            for k, (u, e, t) in worst.items()))


class ServeCapture:
    """Keeps the inputs of the largest launch of each attention kernel and
    of every SEARCH during the serve run (for the checks and timings at the
    path's own shapes) and counts the wrappers' calls.  For attention it
    holds references: the port never writes a prefill's q/k/v after the
    call, and a captured cache page (layer 0 at the longest decode step) is
    not written again.  A SEARCH's table is a view of the pool's index,
    which later epochs write, so each (512 x 8 int32, one per admit wave)
    is copied."""

    def __init__(self):
        import repro_torch.models.attention as A
        import repro_torch.serving.kvpool as P
        self.A, self.P = A, P
        self.orig = (A.flash_attention, A.paged_attention, P.race_lookup)
        self.flash = self.paged = None
        self.races = []
        self.calls = {"flash_attention": 0, "paged_attention": 0,
                      "race_lookup": 0}

        def flash_attention(q, k, v, *, causal=True):
            self.calls["flash_attention"] += 1
            if self.flash is None or q.numel() > self.flash[0].numel():
                self.flash = (q, k, v, causal)
            return self.orig[0](q, k, v, causal=causal)

        def paged_attention(q, kc, vc, valid_len):
            self.calls["paged_attention"] += 1
            if self.paged is None or valid_len > self.paged[3]:
                self.paged = (q, kc, vc, valid_len)
            return self.orig[1](q, kc, vc, valid_len)

        def race_lookup(keys, table):
            self.calls["race_lookup"] += 1
            self.races.append((keys, table.clone()))
            return self.orig[2](keys, table)

        A.flash_attention, A.paged_attention = flash_attention, paged_attention
        P.race_lookup = race_lookup

    def close(self):
        self.A.flash_attention, self.A.paged_attention = self.orig[:2]
        self.P.race_lookup = self.orig[2]


def serve_prompts(rng, vocab: int, n: int = 8, shared: int = 1024,
                  tail: int = 128):
    """n prompts: one shared system prompt of ``shared`` tokens, then each
    request's own ``tail`` tokens."""
    import numpy as np
    sys_prompt = rng.integers(0, vocab, shared).astype(np.int32)
    return [np.concatenate([sys_prompt, rng.integers(0, vocab, tail)
                            .astype(np.int32)]) for _ in range(n)]


def phase_serve(args):
    """(b) llama3-8b at full width and depth serves 8 requests through the
    FUSEE prefix-cache pool on the card."""
    import dataclasses
    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.models import build
    from repro_torch.serving import PoolConfig, Request, ServeEngine
    cfg = get("llama3-8b")
    model = build(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(seed=args.seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    padded = dataclasses.replace(cfg, vocab=model.vocab_p)   # = cfg here
    check(n_params == padded.n_params(), "llama3-8b parameter count")
    log(f"[serve] llama3-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads, head_dim "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} "
        f"parameters, {n_bytes} bytes of {model.dtype}, drawn from seed "
        f"{args.seed} in {time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(model, params, max_batch=4, max_len=2048,
                      pool_cfg=PoolConfig(**SERVE_POOL), seed=args.seed)
    prompts = serve_prompts(np.random.default_rng(args.seed), cfg.vocab)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=16))
    # warm-up at the run's own shapes (a 4 x 1152 prefill and one decode
    # step) so that cuBLAS's and the kernels' first-call costs stay out of
    # the timed window; the counts are set to 0 after it
    t0 = time.perf_counter()
    toks = torch.as_tensor(np.stack(prompts[:4]), dtype=torch.int64,
                           device=model.device)
    _, cache = model.prefill(params, toks, max_len=2048)
    model.decode_step(params, cache, toks[:, -1:])
    torch.cuda.synchronize()
    del cache
    log(f"[serve] warm-up (one 4 x 1152 prefill, one decode step): "
        f"{time.perf_counter() - t0:.3f} s")
    timing = {"prefill": [], "decode": []}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timing[name].append(1e3 * (time.perf_counter() - t))
            return out
        return run

    model.prefill = timed("prefill", model.prefill)
    model.decode_step = timed("decode", model.decode_step)
    capture = ServeCapture()
    reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(max_ticks=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        capture.close()
    launches = {k.__name__: k.launches for k in KERNELS}
    n_pre, n_dec = len(timing["prefill"]), len(timing["decode"])
    tokens = sum(len(q.out) for q in done)
    check(len(done) == 8 and all(len(q.out) == 16 for q in done),
          "serve: not every request finished with 16 tokens")
    hits = {q.rid: q.prefix_hits for q in done}
    check(all(hits[r] == 16 for r in range(4, 8)),
          f"serve: second wave did not hit the 16 shared blocks: {hits}")
    check(eng.pool.check_replicas_converged(), "serve: replicas diverged")
    check((n_pre, n_dec) == (2, 30), f"serve: {n_pre} prefills and {n_dec} "
          "decode steps, expected 2 and 30 with this traffic")
    check(launches["flash_attention"] == cfg.n_layers * n_pre,
          f"serve: flash_attention launched {launches['flash_attention']} "
          f"times for {n_pre} prefills of {cfg.n_layers} layers")
    check(launches["paged_attention"] == cfg.n_layers * n_dec,
          f"serve: paged_attention launched {launches['paged_attention']} "
          f"times for {n_dec} decode steps of {cfg.n_layers} layers")
    check(launches["race_lookup"] > 0, "serve: no race_lookup launch")
    check(all(capture.calls[k] == launches[k] for k in capture.calls),
          f"serve: a kernel wrapper was called without launching: "
          f"{capture.calls} calls, {launches} launches")
    st = eng.pool.stats
    log(f"[serve] 8 requests (1024 shared + 128 own tokens, 16 new each), "
        f"max_batch 4, max_len 2048, pool {SERVE_POOL}: {tokens} tokens in "
        f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; {n_pre} prefills "
        f"({', '.join(f'{t:.1f}' for t in timing['prefill'])} ms), {n_dec} "
        f"decode steps ({np.mean(timing['decode']):.2f} ms mean, "
        f"{np.min(timing['decode']):.2f} min, {np.max(timing['decode']):.2f}"
        f" max); prefix hits {[hits[r] for r in range(8)]}; pool "
        f"{st['search_batches']} search batches, {st['epochs']} SNAPSHOT "
        f"epochs; launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    cache = eng.cache["layers"][0][0]
    log(f"[serve] KV cache pages {tuple(cache.shape)} x2, "
        f"{2 * cache.numel() * cache.element_size()} bytes")
    serve_listing(eng, prompts)
    profile_serve(model, params, prompts[4:])
    return capture, launches


def serve_listing(eng, prompts):
    """``list_prefixes(0, 64)`` after the serve run: the sorted block-hash
    keys that SEARCH finds, each with its page, through one ``leaf_probe``
    launch, which is held against the plain version on the same inputs."""
    import numpy as np
    import torch
    import repro_torch.serving.backend as B
    from repro_torch.kernels import leaf_probe, leaf_probe_plain
    from repro_torch.serving.engine import _block_hashes
    keys = sorted({B._key32(int(h)) for p in prompts
                   for h in _block_hashes(p)})
    ptr, found = eng.pool.search(np.array(keys, np.int32))
    want = [(k, int(p)) for k, p, f in zip(keys, ptr, found) if f][:64]
    seen = []
    orig = B.leaf_probe

    def probe(starts, lows):
        seen.append((starts, lows))
        return orig(starts, lows)

    B.leaf_probe = probe
    before = leaf_probe.launches
    try:
        got = eng.list_prefixes(0, 64)
    finally:
        B.leaf_probe = orig
    n = leaf_probe.launches - before
    check(n == len(seen) == 1, f"list_prefixes: {n} leaf_probe launches "
          f"for {len(seen)} calls, expected 1")
    check(got == want, f"list_prefixes(0, 64) gave {len(got)} entries that "
          f"differ from the {len(want)} block hashes SEARCH finds")
    a, b = leaf_probe(*seen[0]), leaf_probe_plain(*seen[0])
    torch.cuda.synchronize()
    check(torch.equal(a, b), "leaf_probe differs from its plain version on "
          "list_prefixes' inputs")
    log(f"[serve] list_prefixes(0, 64): {len(got)} of {len(keys)} block-hash "
        f"keys (the {int(found.sum())} that SEARCH finds, sorted), one "
        f"leaf_probe launch over a keydir of {seen[0][1].numel()}, equal to "
        f"the plain version")


def profile_serve(model, params, prompts, steps: int = 4):
    """One prefill of the served batch and ``steps`` decode steps under
    ``torch.profiler`` (after the counted run): the device's busy share of
    each window and its top kernels by device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    toks = torch.as_tensor(np.stack(prompts), dtype=torch.int64,
                           device=model.device)
    last = toks[:, -1:]

    def window(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kern)
        kern.sort(key=lambda e: -e.self_device_time_total)
        top = "; ".join(f"{e.key[:60]} x{e.count} "
                        f"{e.self_device_time_total / 1e3:.3f} ms"
                        for e in kern[:6])
        launches = sum(e.count for e in kern)
        if not kern:
            log(f"[profile] {name}: wall {wall_us / 1e3:.2f} ms; the profiler"
                " recorded no device activity (device busy share not "
                "measured)")
            return out
        log(f"[profile] {name}: wall {wall_us / 1e3:.2f} ms, device busy "
            f"{busy_us / 1e3:.2f} ms (share {busy_us / wall_us:.3f}, idle "
            f"{1 - busy_us / wall_us:.3f}), {launches} kernels; top: {top}")
        return out

    _, cache = window("prefill (4 x 1152 tokens)",
                      lambda: model.prefill(params, toks, max_len=2048))

    def decode():
        for _ in range(steps):
            model.decode_step(params, cache, last)

    window(f"{steps} decode steps", decode)


def sdpa(q, k, v, causal):
    """One PyTorch call computing the same attention (the yardstick)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def phase_serve_kernels(capture, launches):
    """Each kernel held against its plain version on the inputs the serve
    run gave it (every SEARCH; each attention kernel's largest launch),
    and each attention kernel timed there beside its byte/FLOP bound and
    ``scaled_dot_product_attention`` (race_lookup's row is the fleet
    path's)."""
    import torch
    from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                     paged_attention, paged_attention_plain,
                                     race_lookup, race_lookup_plain)
    found = []
    for keys, table in capture.races:
        a, b = race_lookup(keys, table), race_lookup_plain(keys, table)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              "race_lookup differs from its plain version on the serve "
              "run's inputs")
        found.append(f"{int(a[1].sum())} of {keys.numel()} keys")
    check(len(found) == launches["race_lookup"],
          "serve: a SEARCH was not captured")
    log(f"[kernels] race_lookup on each of the serve run's "
        f"{len(found)} SEARCHes (table {tuple(table.shape)}): "
        f"{', '.join(found)} found; ptr and found equal to the plain "
        f"version's")
    rows = []
    q, k, v, causal = capture.flash
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    out, used, err, typical = check_attn(
        flash_attention, flash_attention_plain, q, k, v, causal=causal,
        what="flash_attention on the serve run's inputs")
    ms = time_ms(lambda: flash_attention(q, k, v, causal=causal), iters=20)
    dev_ms = device_time_ms(lambda: flash_attention(q, k, v, causal=causal),
                            iters=20)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                       iters=10)
    lib_err = float((sdpa(q, k, v, causal).float() - out.float()).abs().max())
    lib_ms = time_ms(lambda: sdpa(q, k, v, causal), iters=20)
    off = Skv - Sq
    pairs = (sum(min(Skv, max(0, i + off + 1)) for i in range(Sq))
             if causal else Sq * Skv)
    flops = 4 * B * H * hd * pairs
    nbytes = q.element_size() * (2 * B * H * Sq * hd + 2 * B * KV * Skv * hd)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / MEM_BW_BYTES_PER_S
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:70",
        launches=launches["flash_attention"], max_abs_err=err,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=lib_ms))
    log(f"[kernels] flash_attention at the serve run's largest prefill: q "
        f"{tuple(q.shape)}, k/v {tuple(k.shape)}, {q.dtype}, causal "
        f"{causal}; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the "
        f"device), plain {plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{lib_ms:.4f} ms (max abs diff {lib_err:.3g}); bound "
        f"{rows[-1]['bound_ms']:.6f} ms ({flops} FLOP at 989 TFLOP/s bf16, "
        f"{nbytes} B at 3.35 TB/s); max abs err {err:.3g} (mean |ref| "
        f"{typical:.3g}, at most {used:.3f} of the bound)")

    q, kc, vc, vl = capture.paged
    nb, tb, B, KV, hd = kc.shape
    H = q.shape[1]
    out, used, err, typical = check_attn(
        paged_attention, paged_attention_plain, q, kc, vc, vl,
        what="paged_attention on the serve run's inputs")
    # a decode step's 32 layers each read their own pages, so every call
    # finds its pages cold in L2: time over copies that overflow its 50 MB
    pages = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(5)]
    views = [tuple(x.view(nb * tb, B, KV, hd)[:vl].permute(1, 2, 0, 3)
                   for x in kv) for kv in pages]
    turn = iter(range(1 << 62))

    def cold(fn, sets):
        return lambda: fn(*sets[next(turn) % len(sets)])

    kernel = cold(lambda a, b: paged_attention(q, a, b, vl), pages)
    ms = time_ms(kernel)
    dev_ms = device_time_ms(kernel)
    plain_ms = time_ms(cold(lambda a, b: paged_attention_plain(q, a, b, vl),
                            pages), iters=20)
    qs = q[:, :, None]
    lib_err = float((sdpa(qs, *views[0], False)[:, :, 0].float()
                     - out.float()).abs().max())
    lib_ms = time_ms(cold(lambda a, b: sdpa(qs, a, b, False), views))
    nbytes = q.element_size() * (2 * B * H * hd + 2 * B * KV * vl * hd)
    flops = 4 * B * H * hd * vl
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / MEM_BW_BYTES_PER_S
    rows.append(dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:58",
        launches=launches["paged_attention"], max_abs_err=err,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=lib_ms))
    log(f"[kernels] paged_attention at the serve run's longest decode step: "
        f"q {tuple(q.shape)}, pages {tuple(kc.shape)}, {q.dtype}, valid_len "
        f"{vl}; pages cold in L2 (6 copies in turn): kernel {ms:.4f} ms per "
        f"call ({dev_ms:.4f} ms on the device), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention "
        f"{lib_ms:.4f} ms (max abs diff {lib_err:.3g}); byte bound "
        f"{rows[-1]['bound_ms']:.6f} ms ({nbytes} B at 3.35 TB/s); max abs "
        f"err {err:.3g} (mean |ref| {typical:.3g}, at most {used:.3f} of the "
        f"bound)")
    return rows


def phase_serve_parity(seed: int):
    """(c) tests/test_serving.py's engine scenario at reduced size in f32
    (the tests' own definition, ``tests/_torch_parity.py``) on ``cuda`` and
    on ``cpu`` with the same weights: tokens and prefix hits per request,
    every prompt block's SEARCH result, replica convergence."""
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get, reduced
    from repro_torch.kernels import KERNELS
    from repro_torch.models import build
    from _torch_parity import port_serve_run
    cfg = reduced(get("llama3-8b"))
    model = build(cfg, device="cuda")
    params = model.init(seed=seed)
    before = {k.__name__: k.launches for k in KERNELS}
    gpu = port_serve_run(model, params)
    launches = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    check(all(launches[k] > 0 for k in ("flash_attention", "paged_attention",
                                        "race_lookup")),
          f"reduced serve run on cuda skipped a kernel: {launches}")
    check(gpu["converged"], "reduced serve run on cuda: replicas diverged")
    cpu = port_serve_run(build(cfg, device="cpu"),
                         tree_map(lambda t: t.cpu(), params))
    compare(gpu, cpu, "reduced serve run")
    log(f"[parity] reduced serve run (f32, same weights): cuda and cpu give "
        f"equal tokens, prefix hits and per-key SEARCH results "
        f"{gpu['requests']}; cuda launches {launches}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=100_000)
    ap.add_argument("--clients", type=int, default=1024)
    ap.add_argument("--value-words", type=int, default=123)
    ap.add_argument("--ops-per-client", type=int, default=16)
    # cut from the paper's 100 000: on an H100 that load alone took 425.5 s
    # (9 162 ticks) and the whole script 839.7 s
    ap.add_argument("--e-keys", type=int, default=40_000,
                    help="keys loaded for the YCSB-E phase")
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
    sys.path.insert(0, str(ROOT / "tests"))      # the tests' shared helpers
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
    phase_leaf_probe_edges(dev)
    phase_serve_edge_checks(dev)
    cl, fleet, acked, capture, launches, _stats = phase_fleet(args)
    for k in ("race_lookup", "fleet_read"):
        check(launches[k] > 0, f"kernel {k} was not launched on the fleet "
              "path")
    check(capture.rl_calls == launches["race_lookup"]
          and capture.fr_calls == launches["fleet_read"],
          "a kernel wrapper was called without launching")
    rows = phase_kernel_timings(cl, capture, launches)
    phase_audit(cl, fleet, acked)
    del cl, fleet, capture
    torch.cuda.empty_cache()
    cl, capture, e_launches = phase_ycsbe(args)
    rows.append(leaf_probe_row(capture, e_launches))
    del cl, capture
    torch.cuda.empty_cache()
    phase_ycsbe_parity()

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
    capture, serve_launches = phase_serve(args)
    rows += phase_serve_kernels(capture, serve_launches)
    del capture
    torch.cuda.empty_cache()
    phase_serve_parity(args.seed)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
