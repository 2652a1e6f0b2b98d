#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (printing
ptxas's registers, shared memory, spills and warnings for every library)
and then:

1. prints the card's name and power limit as ``nvidia-smi`` reports them,
   and beside them ``launch.device.device_spec()``, which must be the
   port's table entry for the H100 SXM5 (``[launch]``);
2. holds each kernel bit for bit against its plain PyTorch version on edge
   inputs (keys 0, 2^31 and 2^32-1; slab words >= 2^63 and at the 32-bit
   boundary; zero-length and ragged read verbs; ``race_lookup`` through its
   public wrapper and the probe path's packed entry at spb 8, 1, 7 and 16;
   for ``leaf_probe`` starts and fence lows at 0, 2^31, 2^32-1, 2^32,
   2^63-1, 2^63 and 2^64-2, duplicate lows, M = 0, 1 and 40 000, N = 1,
   1000 and 4097);
3. drives the store at the paper's scale (``configs/fusee_paper.py``: 5 MNs,
   replication 2, 100 000 keys, 1 KiB KV pairs, zipf 0.99) with 1024
   clients through ``FleetEngine.submit_wave``: a preload, then YCSB-A, then
   YCSB-C.  The kernels' launch counts are set to 0 just before and read
   just after; both must be > 0.  The ``[fleet]`` lines give the shadow
   rebuilds and the host ms per ``probe_wave``, split into shadow, probe
   and hit resolution, and from the obs hub (attached, as on every
   cluster) the op latency in ticks per op kind (p50 / p99 / p999) and the
   flight ring's event and drop counts.  Each kernel is then checked and timed on the inputs
   the run gave it (``race_lookup`` through the probe path's packed entry
   beside its public wrapper, on the device at N = 1, 64, the probe's N and
   65 536 and at spb 16, beside the launch floor: ``torch.cuda._sleep(0)``,
   one empty spin kernel; ``fleet_read`` through the pool's own entry,
   ``fleet_read_tick``, beside its public wrapper and ``torch.take``);
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
   the NOT_FOUND scans); the keydir replicas equal.  Every
   ``locate_leaves`` call and every locate wave is timed on the host
   clock.  ``leaf_probe`` is then checked and timed on the run's largest
   locate wave beside ``torch.searchsorted``, and at one start against the
   run's median fence count, each both on device tensors and as the locate
   path launches it (starts and answers in pinned host memory);
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
7b. runs step 6's two runs with the default obs hub, with the hot-key
   monitor and with a recording verb tracer on ``cuda`` and on ``cpu`` and
   requires an equal obs surface (``[obs]`` lines: deterministic metrics,
   flight ring, hotspot block, verb ring, span trees, profile); the traced
   fleet run must have left the fused tick, and its flight ring and span
   trees are written as Perfetto JSON and loaded back;
7c. times the obs hub's and the verb tracer's cost per fleet tick on the
   card in the modes of the JAX package's ``obs_overhead`` and
   ``trace_overhead`` benchmarks (``[obs] overhead`` line; reported, not
   gated);
7d. runs the sanitizers on ``cuda`` and on ``cpu`` and requires equal
   results (``[sanitize]`` lines): the race detector and heap auditor after
   ``repro_torch.analysis.races._storm_run`` for churn seeds 0 and 4 (no
   finding, a clean audit), the ``UNSAFE_ACK_LOST_EMPTY_CAS`` regression
   (its ``lost_cas_ack`` finding) and its safe twin (no finding), and
   ROADMAP C1's two crash-during-commit draws through the port's
   linearizability checker (linearizable).  The heap auditor also runs on
   the drained clusters of steps 4 and 4b (wall time and counts printed,
   not gated), and step 4 prints the sha1 of the fleet run's signature
   beside its ticks, probe hits and launch counts;
7e. runs the port's DPOR model checker on ``cuda`` and on ``cpu`` and
   requires equal results (``[explore]`` lines, with each device's seconds
   and a total): the ``no_fault``, ``crash`` and ``insert_race`` scopes at
   full depth and bounded prefixes of ``stale_epoch`` (300 states),
   ``cutover`` (150) and ``loser_reset`` (300), all without a violation;
   the ``lost_ack``, ``stale_epoch`` (2000 states) and ``loser_reset``
   rediscoveries with their ``UNSAFE_*`` flag, each minimized to at most
   25 choices, saved as an ``.npz`` under ``build/explore/`` and replayed
   on the card;
8. holds ``flash_attention`` and ``paged_attention`` against their plain
   versions at the edges (bf16 and f32, GQA groups 1 and 4, ragged, tile-
   edge, split-edge and page-edge lengths; run right after step 2);
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
   per-key SEARCH results and prefix listings;
11. ``[models]``: serves smollm-360m at full width and depth (head dim 64,
   15 heads over 5 kv heads) with step 9's traffic and checks (tied
   parameter count, one ``flash_attention`` launch per layer per prefill
   and one ``paged_attention`` launch per layer per decode step, second-
   wave prefix hits); runs qwen3-32b, chameleon-34b (family ``vlm``) and
   mistral-large-123b (G 12) at full width with ``MODELS_CUT`` layers
   through one 4 x 1152 prefill and 4 decode steps of ``Model``
   (``model_run``, as step 11b); holds both attention kernels against
   their plain versions on each run's inputs and times them beside SDPA;
   and runs each of the four configs at reduced size in f32 on ``cuda``
   and on ``cpu`` (``reduced_parity``, as step 11b: equal prefill logits
   and decode tokens, one train step);
11b. ``[families]``: the other model families at full width with bf16
   weights from ``--seed`` (``family_cuts``: xlstm-350m and
   whisper-medium whole, kimi-k2-1t-a32b and arctic-480b cut to 1 layer,
   jamba-1.5-large-398b to 2, each cut printed with its reason), each
   through one 4 x 1152 prefill (whisper: 4 x 128 tokens over 4 x 1500
   frames) and 4 decode steps of ``Model``, jamba first behind
   ``ServeEngine`` with step 9's traffic; the launch counts set to 0
   before each run and read after (``model_launches``); every distinct
   ``flash_attention`` input shape and the longest ``paged_attention``
   step held to their plain versions and timed beside SDPA; the sLSTM
   backward (``SLSTMScan``) against plain autograd at xlstm's width; the
   five configs at reduced size in f32 on ``cuda`` and on ``cpu``
   (logits, tokens, one train step, the MoE kept sets);
12. ``[train]``: trains smollm-360m at full width and depth for 30 steps
   (bf16, AdamW, remat per layer, batch 8 x seq 1024; the mean loss of the
   last 5 steps at least 0.2 below the first 5's; ms per step, tokens/s,
   peak memory, one profiled step), 3 steps with int8 moments, a gradient
   check at full width and depth in f32 (autograd against a difference
   quotient of the loss along a random direction in every leaf of four
   layers, the final norm and the used embedding rows), and at reduced
   size in f32 on the card one step with 1 and with 4 microbatches, each
   against cpu, and the fault drill.  No hand-
   written kernel launches on the training path.

``[launch]`` lines (the phase's parts run inside ``[serve]`` and
``[train]``, so that no model is loaded twice): llama3-8b's 4 x 1152
prefill and one decode step after the serve run, and the smollm-360m
train step after its 30 steps, each counted on ``meta`` at the run's
shapes (``launch.dryrun.count_step``) and timed on the card
(``launch.roofline.measure``): FLOPs, HBM bytes, the bound at the data
sheet's peaks, the step's time, ``share_of_bound`` (which must lie in
(0, 1.05]) and ``mfu``, and the counted argument bytes beside the peak
device memory (which must not be below them).  The measurement's profiled
call gives each step's ``[profile]`` (serve) or ``[train] profiled step``
line: wall time, the device's busy share and the top kernels.  Then one
dry-run cell,
``dryrun.run_cell("llama3-8b", "decode_32k")``, and the phase's time.
The kernel rows' bounds take their HBM rate and bf16 peak from the same
table (``launch/device.py``).

``--only models`` / ``families`` / ``train`` is a development aid for
iterating on those phases: it builds the kernels, runs just those phases
and prints
neither the kernels line nor the result line; the check is the run with no
arguments.  Each kernel is timed per call (``time_ms``) and on the device
(``device_time_ms``), and so is its library yardstick where one PyTorch call
computes the same function (``library_ms``, ``library_device_ms``).  It
prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as its
last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the last line.  It needs no network and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the card's data-sheet HBM rate and dense bf16 peak, from the port's table
# (src/repro_torch/launch/device.py), set by ``load_spec`` in ``main``
MEM_BW_BYTES_PER_S = PEAK_BF16_FLOPS = None


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
def small_fleet_run(device: str, seed: int = 3, prep=None):
    """24 clients, 64 keys: preload, then YCSB-A through submit_wave.
    ``prep(cluster)``, when given, runs right after construction."""
    import numpy as np
    from _torch_parity import drive_waves
    from repro_torch.core import FuseeCluster, Op
    n_clients, n_keys = 24, 64
    cfg = fleet_dmconfig(n_clients, n_keys, n_mns=4, replication=2)
    cl = FuseeCluster(cfg, num_clients=n_clients, seed=seed, device=device)
    if prep is not None:
        prep(cl)
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


def fault_run(device: str, seed: int = 1, prep=None):
    """Step-mode ops with a client crash + recovery and an MN crash with
    auto-recovery; the master's direct region access runs on ``device``.
    ``prep(cluster)``, when given, runs right after construction."""
    from repro_torch.core import (ClientCrashed, DMConfig, FaultPlan,
                                  FuseeCluster, Op)
    n_clients = 6
    cl = FuseeCluster(DMConfig(num_mns=5, replication=2),
                      num_clients=n_clients, seed=seed, device=device)
    if prep is not None:
        prep(cl)
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
    for name in ("race_lookup", "flash_attention", "paged_attention",
                 "leaf_probe", "fleet_read"):
        for kernel, info in ptxas_report(build.build_log(name)):
            log(f"[build] ptxas {name}: {kernel}: {info}")


def ptxas_report(text: str):
    """(kernel, registers / spills / warnings) for each entry function in
    an ``nvcc -Xptxas -v`` log."""
    import re
    out, name, notes = [], None, []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_fwd_wgmma|flash_fwd_f32|paged_split_mma|"
                          r"paged_split_f32|paged_combine)_kernelI(\w*?)Li"
                          r"(\d+)E(?:Li(\d+)E)?", m.group(1))
            dtype = ("bf16 " if "bfloat16" in k.group(2) else
                     "f32 " if k.group(2) == "f" else "") if k else ""
            group = f" G<={k.group(4)}" if k and k.group(4) else ""
            plain = re.search(r"\d+([a-z][a-z_]*_(?:kernel|thread))"
                              r"(?:ILi(\d+)E)?E", m.group(1))
            name = (f"{k.group(1)} {dtype}hd {k.group(3)}{group}" if k else
                    plain.group(1) + (f"<{plain.group(2)}>"
                                      if plain.group(2) else "")
                    if plain else m.group(1))
        elif name and ("spill" in line or "Used" in line):
            notes.append(line.split("ptxas info    :")[-1].strip())
            if "Used" in line:
                out.append((name, "; ".join(notes)))
                name, notes = None, []
        elif "C75" in line:
            out.append(("warning", line.split(":", 1)[-1].strip()[:160]))
    return out


def phase_edge_checks(dev):
    import numpy as np
    import torch
    from repro_torch.core.api import probe_to_host
    from repro_torch.core.shadow import build_shadow
    from repro_torch.kernels import (fleet_read, fleet_read_plain,
                                     race_lookup, race_lookup_plain)
    from repro_torch.kernels.race_lookup.ops import race_lookup_packed_plain
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
    q_np = q.cpu().numpy()
    for spb in (8, 1, 7, 16):          # the path's width; then tiny tables
        t = table if spb == 8 else build_shadow(
            torch.tensor(stored[:40], device=dev), spb=spb, min_buckets=2)
        a, b = race_lookup(q, t), race_lookup_plain(q, t)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"race_lookup differs at spb={spb}")
        check(np.array_equal(probe_to_host(q_np, t),
                             race_lookup_packed_plain(q, t).cpu().numpy()),
              f"race_lookup's packed entry differs at spb={spb}")

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
    log("[kernels] edge checks: race_lookup (its public wrapper and the "
        "probe path's packed entry) and fleet_read equal their plain "
        "versions bit for bit")


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
    """Keeps the largest inputs each kernel's entry saw during the main
    path (for the checks and timings at the path's own shapes).  A
    probe's keys are copied out of the staging buffer, its table held by
    reference (the port never writes a shadow table after building it); a
    sweep's coordinates are cloned when they are the largest so far, since
    the pool reuses its upload and staging buffers.  The entries
    themselves still launch and count."""

    def __init__(self):
        import repro_torch.core.api as api
        import repro_torch.core.heap as heap
        self.api, self.heap = api, heap
        self.orig_rl, self.orig_fr = (api.race_lookup_probe,
                                      heap.fleet_read_tick)
        self.rl = None
        self.fr = None
        self.rl_calls = self.fr_calls = 0

        def race_lookup_probe(h_keys, d_keys, table, n, *rest):
            self.rl_calls += 1
            if self.rl is None or n > self.rl[0].size:
                self.rl = (h_keys[:n].numpy().copy(), table)
            return self.orig_rl(h_keys, d_keys, table, n, *rest)

        def fleet_read_tick(slab, buf, base, start, total, *rest):
            self.fr_calls += 1
            if self.fr is None or total > self.fr[2]:
                self.fr = (buf[base].clone(), buf[start].clone(), total)
            return self.orig_fr(slab, buf, base, start, total, *rest)

        api.race_lookup_probe = race_lookup_probe
        heap.fleet_read_tick = fleet_read_tick

    def close(self):
        self.api.race_lookup_probe = self.orig_rl
        self.heap.fleet_read_tick = self.orig_fr


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
        f"{st['probe_hits']}, shadow rebuilds {st['shadow_rebuilds']}, "
        f"kernel launches {launches}")
    pw = fleet.probe_wave_profile()
    calls = max(pw["calls"], 1)
    log(f"[fleet] host ms per probe_wave ({pw['calls']:.0f} calls): "
        f"{pw['ms_per_call']:.4f}: shadow {1e3 * pw['shadow_s'] / calls:.4f}"
        f", probe {1e3 * pw['probe_s'] / calls:.4f}, resolve "
        f"{1e3 * pw['resolve_s'] / calls:.4f}")
    prof = fleet.tick_phase_profile()
    log("[fleet] host time per tick: " + ", ".join(
        f"{k} {prof[k + '_frac']:.3f}" for k in
        ("coord_build", "sweep", "scatter", "bookkeeping"))
        + f" of {prof['us_per_tick']:.0f} us")
    if getattr(cl, "obs", None) is not None:
        obs_summary(cl)
    return cl, fleet, acked, capture, launches, stats


def obs_summary(cl):
    """The obs hub's view of the fleet phase: op latency in ticks per op
    kind (p50 / p99 / p999, bucket upper edges) and the flight ring's
    event and drop counts."""
    m = cl.metrics()
    lat = ", ".join(
        f"{name.rsplit('.', 1)[1]} {p['p50']}/{p['p99']}/{p['p999']} "
        f"({p['count']} ops)"
        for name, p in sorted(m["percentiles"].items())
        if name.startswith("op.lat_ticks.kind."))
    fl = cl.obs.flight
    log(f"[fleet] obs hub: op latency in ticks p50/p99/p999 by kind: {lat}; "
        f"flight ring {fl.n} events, {fl.dropped} dropped (capacity "
        f"{fl.capacity}); {len(m['series']['mn.load']['rows'])} mn.load "
        "rows")


def max_abs_err(a, b) -> int:
    """Largest absolute difference of two integer tensors (0 if empty)."""
    import torch
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def probe_keys_like(q_np, n: int, rng):
    """``n`` keys drawn half from the probe ``q_np`` and half at random."""
    import numpy as np
    return np.where(rng.random(n) < 0.5, rng.choice(q_np, n),
                    rng.integers(0, 1 << 32, n)).astype(np.int64)


def race_lookup_row(capture, launches):
    """race_lookup held bit for bit against its plain version on the main
    path's largest probe (its own shadow table, plus the edge keys),
    through the public wrapper and the probe path's packed entry, and
    timed: on the device at N = 1, 64, the probe's N and 65 536 against
    the path's table (spb 8) and at the probe's N against a table of spb
    16; the packed entry per call (keys from a numpy array to a numpy
    answer) beside the public wrapper; the launch floor."""
    import numpy as np
    import torch
    from repro_torch.core import api
    from repro_torch.core.shadow import bucket_pair, build_shadow
    from repro_torch.kernels import race_lookup, race_lookup_plain
    from repro_torch.kernels.race_lookup.ops import race_lookup_packed_plain
    q_np, table = capture.rl
    rng = np.random.default_rng(17)
    edge = np.array([0, 1 << 31, (1 << 32) - 1], np.int64)
    qe_np = np.concatenate([q_np, edge])
    qe = torch.from_numpy(qe_np).cuda()
    a, b = race_lookup(qe, table), race_lookup_plain(qe, table)
    want = race_lookup_packed_plain(qe, table).cpu().numpy()
    lean = api.probe_to_host(qe_np, table)
    torch.cuda.synchronize()
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "race_lookup differs from its plain version on the main path's "
          "inputs")
    check(np.array_equal(lean, want), "race_lookup's packed entry differs "
          "from the plain version on the main path's inputs")
    q = qe[:q_np.size]
    sizes = {1: q[:1], 64: q[:64], q_np.size: q,
             65536: torch.from_numpy(probe_keys_like(q_np, 65536, rng))
             .cuda()}
    dev_by_n = {}
    for nk, keys in sizes.items():
        check(all(torch.equal(x, y) for x, y in
                  zip(race_lookup(keys, table),
                      race_lookup_plain(keys, table))),
              f"race_lookup differs from its plain version at N={nk}")
        dev_by_n[nk] = device_time_ms(lambda: race_lookup(keys, table))
    stored = torch.from_numpy(rng.integers(0, 1 << 32, 100_000)).cuda()
    t16 = build_shadow(stored, spb=16)
    k16 = torch.cat([stored[:q_np.size // 2], torch.from_numpy(
        rng.integers(0, 1 << 32, q_np.size - q_np.size // 2)).cuda()])
    check(all(torch.equal(x, y) for x, y in
              zip(race_lookup(k16, t16), race_lookup_plain(k16, t16))),
          "race_lookup differs from its plain version at spb 16")
    dev16 = device_time_ms(lambda: race_lookup(k16, t16))
    floor = device_time_ms(lambda: torch.cuda._sleep(0))
    n = q_np.size
    ms = time_ms(lambda: api.probe_to_host(q_np, table))
    wrapper_ms = time_ms(lambda: race_lookup(q, table))
    plain_ms = time_ms(lambda: race_lookup_plain(q, table))
    spb = table.shape[1]
    b1, b2 = bucket_pair(q, table.shape[0])
    rows_touched = int(torch.unique(torch.cat([b1, b2])).numel())
    nbytes = n * 8 + rows_touched * spb * 4 + n * (4 + 1)
    row = dict(
        name="race_lookup", route="cuda",
        source="src/repro_torch/csrc/race_lookup.cu",
        replaces="src/repro/kernels/race_lookup/kernel.py:68",
        launches=launches["race_lookup"],
        max_abs_err=max_abs_err(a[0], b[0]),
        ms=ms, device_ms=dev_by_n[n], plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / MEM_BW_BYTES_PER_S, bound_by="bytes",
        library_ms=None, library_device_ms=None, wrapper_ms=wrapper_ms,
        launch_floor_ms=floor,
        device_ms_by_n={str(k): v for k, v in dev_by_n.items()},
        device_ms_spb16=dev16)
    log(f"[kernels] race_lookup at the main path's largest probe: {n} "
        f"keys, table {tuple(table.shape)}, {rows_touched} rows touched; "
        f"the packed entry {ms:.5f} ms per call from numpy keys to the numpy "
        f"answer, the public wrapper {wrapper_ms:.5f} ms, plain {plain_ms:.4f} ms; "
        f"device ms at spb {spb}: " + ", ".join(
            f"N={k} {v:.6f}" for k, v in dev_by_n.items())
        + f"; N={k16.numel()} at spb 16 (table {tuple(t16.shape)}) "
        f"{dev16:.6f}; launch floor (torch.cuda._sleep(0)) {floor:.6f} ms; "
        f"byte bound {row['bound_ms']:.7f} ms ({nbytes} B at 3.35 TB/s)")
    return row


def phase_kernel_timings(cl, capture, launches):
    import torch
    from repro_torch.kernels import fleet_read, fleet_read_plain
    rows = [race_lookup_row(capture, launches)]
    # fleet_read at the largest read sweep the main path made, through the
    # pool's own entry (coordinates in one upload buffer, words into a
    # staging buffer), beside the public wrapper
    import repro_torch.kernels.fleet_tick.ops as fr_ops
    slab = cl.pool.slab.buf
    base, start, total = capture.fr
    nverbs = base.numel()
    buf = torch.cat([base, start])
    stage = torch.empty(total, dtype=torch.int64, device=slab.device)

    def tick():
        fr_ops.fleet_read_tick(slab, buf, slice(0, nverbs),
                               slice(nverbs, 2 * nverbs + 1), total, stage,
                               0, slab.device)

    tick()
    out_k = stage.clone()
    out_p = fleet_read_plain(slab, base, start, total)
    torch.cuda.synchronize()
    check(torch.equal(out_k, out_p), "fleet_read differs from its plain "
          "version on the main path's inputs")
    check(torch.equal(fleet_read(slab, base, start, total), out_p),
          "fleet_read's public wrapper differs from its plain version")
    ln = start[1:] - start[:-1]
    addrs = (torch.repeat_interleave(base - start[:-1], ln,
                                     output_size=total)
             + torch.arange(total, device=slab.device))
    check(torch.equal(torch.take(slab, addrs), out_k), "torch.take differs")
    ms = time_ms(tick)
    dev_ms = device_time_ms(tick)
    wrapper_ms = time_ms(lambda: fleet_read(slab, base, start, total))
    plain_ms = time_ms(lambda: fleet_read_plain(slab, base, start, total))
    lib_ms = time_ms(lambda: torch.take(slab, addrs))
    lib_dev_ms = device_time_ms(lambda: torch.take(slab, addrs))
    distinct = int(torch.unique(addrs).numel())
    nbytes = nverbs * 8 + (nverbs + 1) * 8 + distinct * 8 + total * 8
    rows.append(dict(
        name="fleet_read", route="cuda",
        source="src/repro_torch/csrc/fleet_read.cu",
        replaces="src/repro/kernels/fleet_tick/kernel.py:38",
        launches=launches["fleet_read"],
        max_abs_err=max_abs_err(out_k, out_p),
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / MEM_BW_BYTES_PER_S, bound_by="bytes",
        library_ms=lib_ms, library_device_ms=lib_dev_ms,
        wrapper_ms=wrapper_ms))
    log(f"[kernels] fleet_read at the main path's largest read sweep: "
        f"{nverbs} verbs, {total} words; the pool's entry {ms:.4f} ms per "
        f"call ({dev_ms:.4f} ms on the device), the public wrapper "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.take {lib_ms:.4f} ms ({lib_dev_ms:.4f} ms on the device; its "
        f"addresses are built outside), byte bound "
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
    """Over the YCSB-E run: counts the ``leaf_probe`` wrapper's calls and
    the fences M of each; keeps clones of the largest wave's inputs and of
    the widest fence table (the port's starts go through a reused staging
    buffer, and a client's device lows are refreshed in place); and times
    every ``locate_leaves`` call and every locate wave on the host clock."""

    def __init__(self, fleet):
        import repro_torch.core.ordered as O
        self.O, self.fleet = O, fleet
        self.orig, self.orig_locate = O.leaf_probe, O.locate_leaves
        self.big = self.widest = None
        self.calls = self.locates = self.waves = 0
        self.m = []
        self.locate_s = self.wave_s = 0.0

        def leaf_probe(starts, lows, out=None):
            self.calls += 1
            self.m.append(lows.numel())
            if self.big is None or starts.numel() > self.big[0].numel():
                # the starts may sit in pinned host memory: keep a device copy
                self.big = (starts.clone().to(lows.device), lows.clone())
            if self.widest is None or lows.numel() > self.widest.numel():
                self.widest = lows.clone()
            return self.orig(starts, lows, out=out)

        def locate_leaves(client, starts):
            t0 = time.perf_counter()
            out = self.orig_locate(client, starts)
            self.locate_s += time.perf_counter() - t0
            self.locates += 1
            return out

        orig_wave = fleet.locate_wave

        def locate_wave(wave):
            t0 = time.perf_counter()
            out = orig_wave(wave)
            self.wave_s += time.perf_counter() - t0
            self.waves += 1
            return out

        O.leaf_probe, O.locate_leaves = leaf_probe, locate_leaves
        fleet.locate_wave = locate_wave

    def close(self):
        self.O.leaf_probe = self.orig
        self.O.locate_leaves = self.orig_locate
        del self.fleet.locate_wave


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

    capture = LeafCapture(fleet)
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
    log(f"[ycsbe] host time over preload and run: {capture.locates} "
        f"locate_leaves calls, {capture.locate_s:.3f} s "
        f"({1e3 * capture.locate_s / max(capture.locates, 1):.4f} ms each); "
        f"{capture.waves} locate waves, {capture.wave_s:.3f} s "
        f"({1e3 * capture.wave_s / max(capture.waves, 1):.4f} ms each)")
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
    sign-flipped words (the library yardstick, never used by the port);
    then at one start against the run's median fence count (the
    ``_locate`` case), and the run's host time per ``locate_leaves``.  Both
    shapes are timed on device tensors and as the locate path launches
    them: starts and answers in pinned host memory, which the kernel reads
    and writes over the bus, beside the lows on the device."""
    import statistics
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
    lib_dev_ms = device_time_ms(library)
    m_med = int(statistics.median(capture.m))
    m_max = max(capture.m)
    one, lows1 = starts[:1].clone(), capture.widest[:m_med].clone()
    got1 = leaf_probe(one, lows1)
    torch.cuda.synchronize()
    check(torch.equal(got1, leaf_probe_plain(one, lows1)), "leaf_probe "
          "differs from its plain version at one start")
    n1_ms = time_ms(lambda: leaf_probe(one, lows1))
    n1_dev_ms = device_time_ms(lambda: leaf_probe(one, lows1))
    # as the locate path launches it: pinned host starts and answers
    h_st, h_one = starts.cpu().pin_memory(), one.cpu().pin_memory()
    h_out = torch.empty(starts.numel(), dtype=torch.int32).pin_memory()
    h_out1 = torch.empty(1, dtype=torch.int32).pin_memory()
    leaf_probe(h_st, lows, out=h_out)
    leaf_probe(h_one, lows1, out=h_out1)
    torch.cuda.synchronize()
    check(torch.equal(h_out, want.cpu()) and torch.equal(h_out1, got1.cpu()),
          "leaf_probe on pinned host starts and answers differs from its "
          "plain version")
    pinned_dev_ms = device_time_ms(lambda: leaf_probe(h_st, lows, out=h_out))
    n1_pinned_ms = time_ms(lambda: leaf_probe(h_one, lows1, out=h_out1))
    n1_pinned_dev_ms = device_time_ms(
        lambda: leaf_probe(h_one, lows1, out=h_out1))
    locate_ms = 1e3 * capture.locate_s / max(capture.locates, 1)
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
        library_ms=lib_ms, library_device_ms=lib_dev_ms,
        pinned_device_ms=pinned_dev_ms, n1_ms=n1_ms,
        n1_device_ms=n1_dev_ms, n1_pinned_ms=n1_pinned_ms,
        n1_pinned_device_ms=n1_pinned_dev_ms, m_median=m_med, m_max=m_max,
        locate_host_ms=locate_ms, locate_host_s=capture.locate_s,
        locates=capture.locates)
    log(f"[kernels] leaf_probe at the YCSB-E run's largest wave: {n} starts "
        f"over {m} fence lows; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms "
        f"on the device; {pinned_dev_ms:.4f} with pinned host starts and "
        f"answers, as the path launches it), plain "
        f"{plain_ms:.4f} ms, torch.searchsorted {lib_ms:.4f} ms "
        f"({lib_dev_ms:.4f} ms on the device), byte bound "
        f"{row['bound_ms']:.6f} ms ({nbytes} B at 3.35 TB/s); equal to the "
        f"plain version and to searchsorted")
    log(f"[kernels] leaf_probe at one start over the run's median {m_med} "
        f"fence lows (largest {m_max}, {len(capture.m)} calls): "
        f"{n1_ms:.4f} ms per call, {n1_dev_ms:.6f} ms on the device; as the "
        f"path launches it (pinned host start and answer) {n1_pinned_ms:.4f} "
        f"ms per call, {n1_pinned_dev_ms:.6f} ms on the device; one "
        f"whole locate_leaves call {locate_ms:.4f} ms of host time "
        f"({capture.locates} calls, {capture.locate_s:.3f} s)")
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


# ------------------------------------------------------------ observability
OBS_MODES = ("default hub", "hot-key monitor", "recording tracer")


def _obs_prep(mode: str):
    if mode == "hot-key monitor":
        return lambda cl: cl.enable_hotspot()
    if mode == "recording tracer":
        return lambda cl: cl.attach_tracer()
    return None


def phase_obs_parity():
    """The small fleet run and the fault run with the default obs hub, with
    the hot-key monitor and with a recording verb tracer, on ``cuda`` and
    on ``cpu``: deterministic metrics, flight ring, hotspot block, verb
    ring, span trees and profile must be equal (``_torch_parity.
    obs_signature``); the traced fleet run's flight ring and span trees
    are exported to Perfetto JSON and loaded back."""
    import repro_torch.obs as O
    from _torch_parity import obs_signature
    out_dir = ROOT / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    for mode in OBS_MODES:
        prep = _obs_prep(mode)
        for name, run in (("small fleet run", small_fleet_run),
                          ("fault run", fault_run)):
            t0 = time.perf_counter()
            cl = run("cuda", prep=prep)[0]
            a = obs_signature(O, cl)
            b = obs_signature(O, run("cpu", prep=prep)[0])
            for k in a:
                check(a[k] == b[k], f"[obs] {name}, {mode}: cuda and cpu "
                      f"differ in {k}")
            m = json.loads(a["metrics"])
            extra = ""
            if mode == "hot-key monitor":
                check("hotspot" in m, f"[obs] {name}: no hotspot block")
                hs = m["hotspot"]
                extra = (f"; hotspot theta_milli {hs['theta_milli']}, "
                         f"regime {hs['regime']}, keys seen "
                         f"{hs['keys_seen']}")
            if mode == "recording tracer":
                check(a["trace.seq"], f"[obs] {name}: no verb recorded")
                prof = json.loads(a["profile"])
                check(prof["conservation"]["ok"],
                      f"[obs] {name}: RTT conservation violated")
                extra = (f"; {len(a['trace.seq'])} verb rows, "
                         f"{len(a['spans.cid'])} spans, conservation "
                         f"{prof['conservation']['attributed_rtts']} + "
                         f"{prof['conservation']['untraced_rtts']} = "
                         f"{prof['conservation']['total_rtts']} rtts")
                if cl._fleet is not None:
                    st = cl._fleet.stats()
                    check(st["fallback_ticks"] > 0 and st["fused_ticks"] == 0,
                          "[obs] a recording tracer left fusion on")
                    extra += (f", {st['fallback_ticks']} ticks on the "
                              "per-kind path")
                    extra += "; " + perfetto_roundtrip(O, cl, out_dir)
            log(f"[obs] {name}, {mode}: cuda and cpu equal (metrics JSON "
                f"{len(a['metrics'])} bytes, {len(a['flight.seq'])} flight "
                f"events){extra}, {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- sanitizers
def heap_audit_line(cl, what: str):
    """The heap auditor on a phase's drained cluster: wall time, error and
    warning counts.  Printed, not gated (the keydir's acknowledged-insert
    drops, ROADMAP C, show as lenient keydir warnings)."""
    t0 = time.perf_counter()
    rep = cl.heap_audit()
    dt = time.perf_counter() - t0
    log(f"[sanitize] heap audit of the {what} cluster: {dt:.3f} s, "
        f"{len(rep.errors)} errors, {len(rep.warnings)} warnings; "
        + ", ".join(f"{k} {rep.stats[k]}" for k in (
            "index_slots_used", "blocks_allocated", "objects_live",
            "leaks", "lenient") if k in rep.stats)
        + (f"; first error: {rep.errors[0]}" if rep.errors else ""))


def _sanitize_storm(seed: int, device: str) -> dict:
    from _torch_parity import finding_rows, heap_rows
    from repro_torch.analysis.races import _storm_run
    cl, tr = _storm_run(seed, churn=True, device=device)
    return {"trace": {f: c.tolist() for f, c in tr.events().items()},
            "findings": finding_rows(cl.race_findings(on_truncated="fail")),
            "heap": heap_rows(cl.heap_audit())}


def _sanitize_lost_write(unsafe: bool, device: str) -> dict:
    import repro_torch.core as T
    import repro_torch.core.client as client_mod
    from _torch_parity import finding_rows, lost_write_run
    client_mod.UNSAFE_ACK_LOST_EMPTY_CAS = unsafe
    try:
        _cl, findings, values = lost_write_run(T, device=device)
    finally:
        client_mod.UNSAFE_ACK_LOST_EMPTY_CAS = False
    return {"findings": finding_rows(findings), "values": values}


def _sanitize_c1(seed: int, steps: int, device: str) -> dict:
    import repro_torch.core as T
    from repro_torch.core import linearize
    from _torch_parity import crash_during_commit, linearizes
    sched, crashed = crash_during_commit(T, seed, steps, device=device)
    return {"history": [(r.cid, r.op_id, r.kind, r.key, r.value, r.inv_tick,
                         r.resp_tick, r.result.status, repr(r.result.value))
                        for r in sched.history if r.result is not None],
            "linearizable": linearizes(linearize, sched.history, 9, crashed)}


def phase_sanitize():
    """The port's race detector, heap auditor and linearizability checker,
    each run on ``cuda`` and on ``cpu`` (a mismatch exits non-zero):
    ``_storm_run`` for churn seeds 0 and 4 (equal verb rings, no race
    finding, a clean audit); ``UNSAFE_ACK_LOST_EMPTY_CAS``'s regression
    (the ``lost_cas_ack`` finding present) and its safe twin (no finding);
    ROADMAP C1's two draws through ``crash_during_commit`` (equal
    histories, linearizable)."""
    runs = [(f"storm seed {s} churn", _sanitize_storm, (s,)) for s in (0, 4)]
    runs += [(f"lost-write regression, UNSAFE_ACK_LOST_EMPTY_CAS={u}",
              _sanitize_lost_write, (u,)) for u in (True, False)]
    runs += [(f"C1 draw seed {s} steps {n}", _sanitize_c1, (s, n))
             for s, n in ((51, 43), (88854, 39))]
    for name, fn, a in runs:
        t0 = time.perf_counter()
        got = fn(*a, device="cuda")
        t1 = time.perf_counter()
        want = fn(*a, device="cpu")
        for k in want:
            check(got[k] == want[k], f"[sanitize] {name}: cuda and cpu "
                  f"differ in {k}")
        if fn is _sanitize_storm:
            errors, warnings, stats = got["heap"]
            check(not got["findings"] and not errors,
                  f"[sanitize] {name}: findings {got['findings']}, heap "
                  f"errors {errors}")
            what = (f"{len(got['trace']['seq'])} verb rows, 0 race "
                    f"findings, heap audit clean ({len(warnings)} warnings,"
                    f" {stats['index_slots_used']} index slots)")
        elif fn is _sanitize_lost_write:
            rules = [f[0] for f in got["findings"]]
            check(rules == (["lost_cas_ack"] if a[0] else []),
                  f"[sanitize] {name}: findings {rules}")
            what = f"findings {rules}, values read back {got['values']}"
        else:
            check(got["linearizable"], f"[sanitize] {name}: the port's "
                  "history does not linearize")
            what = (f"{len(got['history'])} ops, linearizable under "
                    "repro_torch.core.linearize")
        log(f"[sanitize] {name}: cuda and cpu equal; {what}; cuda "
            f"{t1 - t0:.2f} s, cpu {time.perf_counter() - t1:.2f} s")


# (label, scope, flag re-enabled or None, max_states, cut note)
EXPLORE_ITEMS = (
    [("clean", s, None, 200_000, "full depth")
     for s in ("no_fault", "crash", "insert_race")]
    + [("bounded", s, None, n, f"max_states {n}")
       for s, n in (("stale_epoch", 300), ("cutover", 150),
                    ("loser_reset", 300))]
    + [("rediscovery", "lost_ack", "client.UNSAFE_ACK_LOST_EMPTY_CAS",
        200_000, "full depth"),
       ("rediscovery", "stale_epoch", "sim.UNSAFE_EXEC_STALE_EPOCH", 2000,
        "max_states 2000"),
       ("rediscovery", "loser_reset", "master.UNSAFE_REDO_NO_CONVERGE",
        200_000, "cold start, full depth")])


def phase_explore():
    """The port's DPOR model checker (``repro_torch.analysis.explore``),
    each item on ``cuda`` and on ``cpu`` (a mismatch exits non-zero):
    the clean scopes at full depth and the bounded prefixes must find no
    violation; the three rediscoveries must find one, minimize it to at
    most 25 choices, save it as an ``.npz`` on the card and reproduce it
    on the card from that file.  States, executions, visit digest,
    ``complete``, violation kinds and minimized schedules must be equal
    on both devices.  The seed-7 ``cutover`` cold start does not run here
    (several minutes on the CPU alone)."""
    from _torch_parity import explore_signature
    from repro_torch.analysis import explore as E
    out_dir = ROOT / "build" / "explore"
    out_dir.mkdir(parents=True, exist_ok=True)
    totals = {"cuda": 0.0, "cpu": 0.0}
    for label, scope, flag, bound, cut in EXPLORE_ITEMS:
        flags = {flag: True} if flag else None
        got, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res = E.explore(scope, flags=flags, max_states=bound,
                            minimize=flag is not None, device=dev)
            secs[dev] = time.perf_counter() - t0
            totals[dev] += secs[dev]
            got[dev] = (res, explore_signature(res))
        res, sig = got["cuda"]
        name = f"{label} {scope}" + (f" under {flag}" if flag else "")
        compare(sig, got["cpu"][1], f"[explore] {name}")
        what = (f"{sig['states']} states, {sig['executions']} executions, "
                f"digest {sig['visit_digest']}, "
                + ("complete" if sig["complete"] else "budget-capped"))
        if flag is None:
            check(not sig["violations"], f"[explore] {name}: violations "
                  f"{sig['violations']}")
            check(sig["complete"] or label == "bounded",
                  f"[explore] {name}: budget-capped at full depth")
            what += ", no violation"
        else:
            check(sig["violations"], f"[explore] {name}: no violation found")
            kind, minimized = sig["violations"][0]
            check(0 < len(minimized) <= 25, f"[explore] {name}: minimized "
                  f"to {len(minimized)} choices")
            path = str(out_dir / f"{scope}.npz")
            E.save_counterexample(path, scope, res.violations[0], flags)
            lines = []
            check(E.replay(path, out=lines.append, device="cuda")
                  and any(f"VIOLATION {kind}" in ln for ln in lines),
                  f"[explore] {name}: the saved .npz did not reproduce "
                  f"{kind} on the card")
            what += (f"; {kind} minimized to {len(minimized)} choices, "
                     "saved and replayed on the card")
        log(f"[explore] {name} ({cut}): cuda and cpu equal; {what}; cuda "
            f"{secs['cuda']:.2f} s, cpu {secs['cpu']:.2f} s")
    log(f"[explore] total: {len(EXPLORE_ITEMS)} items, cuda "
        f"{totals['cuda']:.2f} s, cpu {totals['cpu']:.2f} s")


def perfetto_roundtrip(O, cl, out_dir) -> str:
    """Write the cluster's flight ring with its span trees nested as
    Perfetto JSON, load it back, and check every phase span landed."""
    ss = O.spans_from_cluster(cl)
    obs = cl.obs
    path = out_dir / "fleet_trace.json"
    trace = O.flight_to_perfetto({"labels": obs.labels(),
                                  **obs.flight_events(),
                                  "dropped": obs.flight.dropped},
                                 str(path), spans=ss)
    check(O.load_perfetto(str(path)) == trace,
          "[obs] the Perfetto trace did not load back equal")
    phases = O.spans_to_perfetto(ss)
    got = sum(e.get("cat") == "phase" for e in trace["traceEvents"])
    check(got == len(phases) > 0,
          f"[obs] the Perfetto trace holds {got} of {len(phases)} phase "
          "events")
    return (f"Perfetto trace of {len(trace['traceEvents'])} events "
            f"({len(phases)} phase events) written and loaded back")


def _overhead_run(mode: str, seed: int) -> list:
    """One cluster of the JAX package's overhead benchmarks
    (``benchmarks/run.py``: 64 clients, 256 keys, 8-word values): a
    preload, then three YCSB-A batches of 512 ops; µs of host time per
    fleet tick of each batch, on the card."""
    import gc
    import torch
    from repro_torch.core import FuseeCluster
    n_clients, n_keys, value_words = 64, 256, 8
    cl = FuseeCluster(fleet_dmconfig(n_clients, n_keys, n_mns=4,
                                     replication=2),
                      num_clients=n_clients, seed=seed, device="cuda")
    if mode == "detached":
        cl.detach_obs()
    elif mode == "profiled":
        cl.enable_hotspot()
    elif mode in ("paused", "recording"):
        tr = cl.attach_tracer()
        if mode == "paused":
            tr.pause()
    sched, fleet = cl.scheduler, cl.fleet()
    for k in range(n_keys):
        sched.submit(k % n_clients, "insert", k, [k] * value_words)
    fleet.run()
    wl = cl.rng.stream("workload")
    kinds, weights = ("search", "update"), (0.5, 0.5)
    samples = []
    for _ in range(3):
        for i in range(n_clients * 8):
            kind = kinds[int(wl.choice(2, p=weights))]
            key = int(wl.integers(n_keys))
            sched.submit(i % n_clients, kind, key,
                         [i] * value_words if kind == "update" else None)
        gc.collect()
        gc.disable()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ticks0 = sched.tick
            fleet.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            gc.enable()
        samples.append(dt * 1e6 / max(1, sched.tick - ticks0))
    return samples


def phase_obs_overhead():
    """The obs hub's and the verb tracer's cost on the fleet tick, on the
    card, in the modes of the JAX package's ``obs_overhead`` (detached,
    attached, profiled; seed 23) and ``trace_overhead`` (off, paused,
    recording; seed 21) benchmarks: one warm-up run, then five repeats
    with the modes interleaved.  µs of host time per tick, min and median
    over the repeats' batches, and the min's overhead over the first
    mode's.  Reported, not gated."""
    import statistics
    t0 = time.perf_counter()
    out = []
    for bench, modes, seed in (
            ("obs_overhead", ("detached", "attached", "profiled"), 23),
            ("trace_overhead", ("off", "paused", "recording"), 21)):
        _overhead_run(modes[0], seed)           # warm-up
        times = {m: [] for m in modes}
        for _ in range(5):
            for m in modes:
                times[m].extend(_overhead_run(m, seed))
        best = {m: min(times[m]) for m in modes}
        out.append(f"{bench}: " + ", ".join(
            f"{m} {best[m]:.1f} us/tick min, "
            f"{statistics.median(times[m]):.1f} median, "
            f"{100.0 * (best[m] / best[modes[0]] - 1.0):+.1f}%"
            for m in modes))
    log(f"[obs] overhead (64 clients, 256 keys, YCSB-A, 3 batches of 512 "
        f"ops, 5 interleaved repeats): {'; '.join(out)}; "
        f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ serving path
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
            cases = [(s, s, c) for s in (1, 63, 65, 127, 129, 257, 1152)
                     for c in (True, False)] + [(65, 300, False),
                                                (300, 65, False),
                                                (129, 300, True),
                                                (300, 129, True)]
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
            for vl in (1, 63, 64, 65, 1167, tb - 1, tb, tb + 1, nb * tb):
                note("paged_attention", dt, check_attn(
                    paged_attention, paged_attention_plain, q, kc, vc, vl,
                    what=f"paged_attention {dt} G={H // 8} valid_len={vl}"))
    torch.cuda.synchronize()
    log(f"[serve] edge checks: flash_attention (bf16/f32, G 1/4, Sq=Skv in "
        f"1/63/65/127/129/257/1152 causal and not, Sq != Skv both ways) and "
        f"paged_attention (bf16/f32, G 1/4, valid_len 1/63/64/65/1167/1023/"
        f"1024/1025/2048, splits of 64) within "
        f"tolerance of their plain versions (f32: 2e-5 + 2e-5 x |ref|; "
        f"bf16: 2^-7 x |ref| + 2^-8 x the weighted mean of |v|, and 1e-4 + "
        f"2^-7 x |ref| with exact weights); largest share of the bound, max "
        f"abs err, smallest mean |ref| of a case: " + "; ".join(
            f"{k} {u:.3f}, {e:.3g}, {t:.3g}"
            for k, (u, e, t) in worst.items()))


class ServeCapture:
    """Keeps the inputs of the largest launch of each attention kernel and
    of every SEARCH during a run (for the checks and timings at the path's
    own shapes) and counts the wrappers' calls made outside a CUDA graph's
    capture (a call inside one launches nothing).  For attention it holds
    references: the port never writes a prefill's q/k/v after the call,
    and a decode step writes its pages only at and past its own length.
    A decode step that replays a graph calls no wrapper: of each captured
    graph the capture's first paged call (layer 0) is kept, whose q the
    graph rewrites at every replay, and ``_DecodeGraph.replay`` is watched
    for the last replay; on ``close`` that replay's layer-0 inputs at its
    length are the paged input unless an eager call was longer.  A
    SEARCH's table is a view of the pool's index, which later epochs
    write, so each (512 x 8 int32, one per admit wave) is copied."""

    def __init__(self):
        import torch
        import repro_torch.models.attention as A
        import repro_torch.models.model as M
        import repro_torch.serving.kvpool as P
        self.A, self.M, self.P = A, M, P
        self.orig = (A.flash_attention, A.paged_attention, P.race_lookup,
                     M._DecodeGraph.replay)
        self.graphed = {}       # id of a graph's device length: its layer 0
        self.reset()
        capturing = torch.cuda.is_current_stream_capturing

        def flash_attention(q, k, v, *, causal=True):
            if capturing():
                return self.orig[0](q, k, v, causal=causal)
            self.calls["flash_attention"] += 1
            if self.flash is None or q.numel() > self.flash[0].numel():
                self.flash = (q, k, v, causal)
            self.flash_shapes.setdefault(
                (tuple(q.shape), tuple(k.shape), causal), (q, k, v, causal))
            return self.orig[0](q, k, v, causal=causal)

        def paged_attention(q, kc, vc, valid_len, count_len=None):
            if capturing():
                self.graphed.setdefault(id(valid_len), (q, kc, vc, valid_len))
                return self.orig[1](q, kc, vc, valid_len, count_len)
            self.calls["paged_attention"] += 1
            vl = count_len if isinstance(valid_len, torch.Tensor) \
                else valid_len          # a device-held length's host value
            if self.paged is None or vl > self.paged[3]:
                self.paged = (q, kc, vc, vl)
            return self.orig[1](q, kc, vc, valid_len, count_len)

        def race_lookup(keys, table):
            self.calls["race_lookup"] += 1
            self.races.append((keys, table.clone()))
            return self.orig[2](keys, table)

        def replay(graph, token, pos):
            self.last = (graph, pos)
            return self.orig[3](graph, token, pos)

        A.flash_attention, A.paged_attention = flash_attention, paged_attention
        P.race_lookup = race_lookup
        M._DecodeGraph.replay = replay

    def reset(self):
        """Forget the calls and inputs so far, but not the graphs' inputs
        (a warm-up's capture serves the run after it)."""
        self.flash = self.paged = None
        self.flash_shapes = {}      # (q shape, k shape, causal): inputs
        self.races = []
        self.calls = {"flash_attention": 0, "paged_attention": 0,
                      "race_lookup": 0}
        self.last = None        # (graph, position) of the last replay

    def close(self):
        self.A.flash_attention, self.A.paged_attention = self.orig[:2]
        self.P.race_lookup = self.orig[2]
        self.M._DecodeGraph.replay = self.orig[3]
        if self.last is None:
            return
        graph, pos = self.last
        kept = self.graphed.get(id(graph.pos.valid))
        if kept is not None and (self.paged is None
                                 or pos + 1 > self.paged[3]):
            self.paged = kept[:3] + (pos + 1,)


TRACED = ("flash_fwd", "paged_split", "paged_combine")


def traced_launches(prof) -> dict:
    """The attention kernels' launches in a ``torch.profiler`` trace, from
    its device records, which the kernels of a replayed CUDA graph emit
    too: ``flash_fwd*`` kernels for ``flash_attention`` and
    ``paged_combine*`` for ``paged_attention`` (each paged call launches
    one split and one combine kernel, and the two counts must agree)."""
    import torch
    n = dict.fromkeys(TRACED, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            for k in TRACED:
                n[k] += k in e.name()
    check(n["paged_split"] == n["paged_combine"],
          f"the profiler traced {n['paged_split']} paged split and "
          f"{n['paged_combine']} combine kernels")
    return {"flash_attention": n["flash_fwd"],
            "paged_attention": n["paged_combine"]}


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
    eng, model, params, prompts, capture, launches = serve_arch(
        args, "llama3-8b", "[serve]")
    cache = eng.cache["layers"][0][0]
    log(f"[serve] KV cache pages {tuple(cache.shape)} x2, "
        f"{2 * cache.numel() * cache.element_size()} bytes")
    serve_listing(eng, prompts)
    launch_serve(model, params, prompts[:4])
    return capture, launches


def serve_arch(args, arch, tag: str, n_expected=None):
    """``arch`` (an id: full width and depth; or a config), bf16 weights
    drawn from ``--seed``, serves 8 requests (a shared 1024-token system
    prompt plus 128 tokens each, 16 new each, max_batch 4) through
    ``ServeEngine`` over the FUSEE prefix-cache pool, with the launch
    counts set to 0 just before the run and read just after, and the
    engine's recorder on (``enable_trace``: the model calls' host times
    and CUDA-event times, the prefix hits and SNAPSHOT epochs).  The tree's
    parameter count must equal ``n_expected`` (default: the config's
    formula at the padded vocabulary)."""
    import dataclasses
    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.models import build
    from repro_torch.obs.serve import DECODE_KINDS
    from repro_torch.serving import PoolConfig, Request, ServeEngine
    cfg = get(arch) if isinstance(arch, str) else arch
    arch = cfg.arch_id
    model = build(cfg, device="cuda")
    n_attn = model.n_super * sum(s.mixer == "attn" for s in model.specs)
    t0 = time.perf_counter()
    params = model.init(seed=args.seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    padded = dataclasses.replace(cfg, vocab=model.vocab_p)   # = cfg here
    check(n_params == (n_expected or padded.n_params()),
          f"{arch} parameter count")
    log(f"{tag} {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
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
    # step, which captures a dense model's decode graph) so that cuBLAS's
    # and the kernels' first-call costs stay out of the timed window; the
    # engine is handed its pages, which its prefill refills in place, so
    # its decode steps replay that graph; the counts are set to 0 after it
    t0 = time.perf_counter()
    capture = ServeCapture()
    try:
        toks = torch.as_tensor(np.stack(prompts[:4]), dtype=torch.int64,
                               device=model.device)
        _, cache = model.prefill(params, toks, max_len=2048)
        model.decode_step(params, cache, toks[:, -1:])
        torch.cuda.synchronize()
    except BaseException:
        capture.close()
        raise
    capture.reset()
    eng.cache = cache
    del cache
    log(f"{tag} warm-up (one 4 x 1152 prefill, one decode step): "
        f"{time.perf_counter() - t0:.3f} s")
    tr = eng.enable_trace()
    reset_launches()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = eng.run(max_ticks=100)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        capture.close()
        eng.trace = model.trace = None      # the calls after it untraced
    launches = {k.__name__: k.launches for k in KERNELS}
    traced = traced_launches(prof)
    del prof
    pre, dec = tr.of("serve.prefill"), tr.of("serve.decode")
    n_pre, n_dec = len(pre), len(dec)
    tokens = sum(len(q.out) for q in done)
    check(len(done) == 8 and all(len(q.out) == 16 for q in done),
          "serve: not every request finished with 16 tokens")
    hits = {q.rid: q.prefix_hits for q in done}
    check(all(hits[r] == 16 for r in range(4, 8)),
          f"serve: second wave did not hit the 16 shared blocks: {hits}")
    check(eng.pool.check_replicas_converged(), "serve: replicas diverged")
    check((n_pre, n_dec) == (2, 30), f"serve: {n_pre} prefills and {n_dec} "
          "decode steps, expected 2 and 30 with this traffic")
    check(launches["flash_attention"] == n_attn * n_pre,
          f"serve: flash_attention launched {launches['flash_attention']} "
          f"times for {n_pre} prefills of {n_attn} attention layers")
    check(launches["paged_attention"] == n_attn * n_dec,
          f"serve: paged_attention launched {launches['paged_attention']} "
          f"times for {n_dec} decode steps of {n_attn} attention layers")
    check(launches["race_lookup"] > 0, "serve: no race_lookup launch")
    check(all(traced[k] == launches[k] for k in traced),
          f"serve: the kernels' counters {launches} differ from the "
          f"launches the profiler traced, {traced}")
    check(all(capture.calls[k] == launches[k]
              for k in ("flash_attention", "race_lookup"))
          and capture.calls["paged_attention"] <= launches["paged_attention"],
          f"serve: a kernel wrapper was called without launching: "
          f"{capture.calls} calls, {launches} launches")
    c = tr.counters()
    kinds = {k: c["serve.decode." + k] for k in DECODE_KINDS}
    check(c["serve.prefix.hits"] == sum(hits.values()),
          f"serve: the recorder counted {c['serve.prefix.hits']} prefix hits"
          f" for the requests' {sum(hits.values())}")
    dev = [s.device_ms for s in dec]
    log(f"{tag} 8 requests (1024 shared + 128 own tokens, 16 new each), "
        f"max_batch 4, max_len 2048, pool {SERVE_POOL}: {tokens} tokens in "
        f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; {n_pre} prefills "
        f"(host {', '.join(f'{s.ms:.1f}' for s in pre)} ms, device "
        f"{', '.join(f'{s.device_ms:.1f}' for s in pre)} ms), {n_dec} "
        f"decode steps (host ms mean {np.mean([s.ms for s in dec]):.2f}; "
        f"device ms mean {np.mean(dev):.2f}, min {np.min(dev):.2f}, max "
        f"{np.max(dev):.2f}); prefix hits {[hits[r] for r in range(8)]}; "
        f"pool {eng.pool.stats['search_batches']} search batches, "
        f"{c['serve.snapshot.epochs']} SNAPSHOT epochs over "
        f"{c['serve.insert.waves']} insert waves; decode steps {kinds}; "
        f"launches {launches}, and the attention kernels' as the profiler "
        f"traced them {traced} (the run under torch.profiler, CUDA activity "
        f"only; on a replayed step the counters add what the captured graph "
        f"holds, worked out, and the trace measures them); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return eng, model, params, prompts, capture, launches


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
    from repro_torch.kernels import race_lookup, race_lookup_plain
    from repro_torch.kernels.paged_attention.ops import split_plan
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
    check(split_plan(capture.paged[3])[0] * capture.paged[2].shape[2]
          * capture.paged[2].shape[3] >= 264, "paged_attention: fewer than "
          "2 CTAs per SM at the serve shape")
    return attn_rows(capture, launches, "[kernels]", "the serve run")


def attn_rows(capture, launches, tag: str, run: str):
    """Both attention kernels held against their plain versions on the
    largest inputs a serve run gave them (``capture``) and timed there
    beside their byte/FLOP bound and ``scaled_dot_product_attention``:
    their rows of the kernels line."""
    return [flash_row(capture.flash, launches, tag, f"{run}'s largest "
                      "prefill", run),
            paged_row(capture.paged, launches, tag, run)]


def flash_row(inputs, launches, tag: str, where: str, run: str):
    """``flash_attention`` on ``inputs`` = (q, k, v, causal): held against
    its plain version, timed beside its bound and SDPA; its kernels-line
    row."""
    from repro_torch.kernels import flash_attention, flash_attention_plain
    q, k, v, causal = inputs
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    out, used, err, typical = check_attn(
        flash_attention, flash_attention_plain, q, k, v, causal=causal,
        what=f"flash_attention on {run}'s inputs")
    ms = time_ms(lambda: flash_attention(q, k, v, causal=causal), iters=20)
    dev_ms = device_time_ms(lambda: flash_attention(q, k, v, causal=causal),
                            iters=20)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                       iters=10)
    lib_err = float((sdpa(q, k, v, causal).float() - out.float()).abs().max())
    lib_ms = time_ms(lambda: sdpa(q, k, v, causal), iters=20)
    lib_dev_ms = device_time_ms(lambda: sdpa(q, k, v, causal), iters=20)
    off = Skv - Sq
    pairs = (sum(min(Skv, max(0, i + off + 1)) for i in range(Sq))
             if causal else Sq * Skv)
    flops = 4 * B * H * hd * pairs
    nbytes = q.element_size() * (2 * B * H * Sq * hd + 2 * B * KV * Skv * hd)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / MEM_BW_BYTES_PER_S
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:70",
        launches=launches["flash_attention"], max_abs_err=err,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=lib_ms, library_device_ms=lib_dev_ms)
    log(f"{tag} flash_attention at {where}: q "
        f"{tuple(q.shape)}, k/v {tuple(k.shape)}, {q.dtype}, causal "
        f"{causal}; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the "
        f"device), plain {plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{lib_ms:.4f} ms ({lib_dev_ms:.4f} ms on the device; max abs diff "
        f"{lib_err:.3g}); bound "
        f"{row['bound_ms']:.6f} ms ({flops} FLOP at 989 TFLOP/s bf16, "
        f"{nbytes} B at 3.35 TB/s); max abs err {err:.3g} (mean |ref| "
        f"{typical:.3g}, at most {used:.3f} of the bound)")
    return row


def paged_row(inputs, launches, tag: str, run: str):
    """``paged_attention`` on ``inputs`` = (q, kc, vc, valid_len), the
    longest decode step of a run, through the entry the decode step runs
    (``valid_len`` a one-element int32 on the card, the grid sized for the
    pages): held against its plain version, timed with its pages cold in
    L2 beside its bound and SDPA, and on the device beside the host-int
    entry; its kernels-line row."""
    import torch
    from repro_torch.kernels import paged_attention, paged_attention_plain
    from repro_torch.kernels.paged_attention.ops import split_plan
    q, kc, vc, vl = inputs
    nb, tb, B, KV, hd = kc.shape
    H = q.shape[1]
    dl = torch.tensor([vl], dtype=torch.int32, device=q.device)

    def paged(q, a, b, n):          # the decode step's call
        return paged_attention(q, a, b, dl, count_len=n)
    out, used, err, typical = check_attn(
        paged, paged_attention_plain, q, kc, vc, vl,
        what=f"paged_attention on {run}'s inputs")
    # a decode step's layers each read their own pages, so every call
    # finds its pages cold in L2: time over copies that overflow its 50 MB
    pages = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(5)]
    views = [tuple(x.view(nb * tb, B, KV, hd)[:vl].permute(1, 2, 0, 3)
                   for x in kv) for kv in pages]
    turn = iter(range(1 << 62))

    def cold(fn, sets):
        return lambda: fn(*sets[next(turn) % len(sets)])

    kernel = cold(lambda a, b: paged(q, a, b, vl), pages)
    ms = time_ms(kernel)
    dev_ms = device_time_ms(kernel)
    host_dev_ms = device_time_ms(cold(
        lambda a, b: paged_attention(q, a, b, vl), pages))
    plain_ms = time_ms(cold(lambda a, b: paged_attention_plain(q, a, b, vl),
                            pages), iters=20)
    qs = q[:, :, None]
    lib_err = float((sdpa(qs, *views[0], False)[:, :, 0].float()
                     - out.float()).abs().max())
    lib_ms = time_ms(cold(lambda a, b: sdpa(qs, a, b, False), views))
    lib_dev_ms = device_time_ms(cold(lambda a, b: sdpa(qs, a, b, False),
                                     views))
    nbytes = q.element_size() * (2 * B * H * hd + 2 * B * KV * vl * hd)
    flops = 4 * B * H * hd * vl
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / MEM_BW_BYTES_PER_S
    row = dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:58",
        launches=launches["paged_attention"], max_abs_err=err,
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=lib_ms, library_device_ms=lib_dev_ms)
    splits, chunk = split_plan(vl)
    grid = split_plan(nb * tb)[0]
    log(f"{tag} paged_attention at {run}'s longest decode step: "
        f"q {tuple(q.shape)}, pages {tuple(kc.shape)}, {q.dtype}, valid_len "
        f"{vl} held on the device ({grid} splits of {chunk} positions "
        f"launched for the pages, {splits} below valid_len: "
        f"{splits * B * KV} CTAs that work); pages cold in L2 (6 copies in "
        f"turn): kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the "
        f"device; the host-int entry, {splits} splits launched, "
        f"{host_dev_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {lib_ms:.4f} ms ({lib_dev_ms:.4f} ms "
        f"on the device; max abs diff {lib_err:.3g}); byte bound "
        f"{row['bound_ms']:.6f} ms ({nbytes} B at 3.35 TB/s); max abs "
        f"err {err:.3g} (mean |ref| {typical:.3g}, at most {used:.3f} of the "
        f"bound)")
    return row


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


# ----------------------------------- full-width model runs, reduced parity
def model_params(args, cfg, tag: str, cut: str, why: str):
    """The model of ``cfg`` on the card with bf16 weights from ``--seed``;
    its tree's parameter count against the formula (dense and MoE) or
    ``param_stats`` (mamba, xlstm and the encoder-decoder, whose trees the
    reference's formula does not count)."""
    import dataclasses
    import torch
    from torch.utils._pytree import tree_leaves
    from repro_torch.models import build, param_stats
    model = build(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    formula = dataclasses.replace(cfg, vocab=model.vocab_p).n_params()
    by_tree = cfg.family in ("ssm", "hybrid") or cfg.enc_dec
    want = param_stats(model)["total"] if by_tree else formula
    check(n == want, f"{cfg.arch_id}: {n} parameters, expected {want}")
    log(f"{tag} {cfg.arch_id}: d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, family {cfg.family}, qk_norm {cfg.qk_norm}, moe "
        f"{cfg.moe}, ssm {cfg.ssm}, enc_dec {cfg.enc_dec} ("
        f"{cfg.n_enc_layers} encoder layers, enc_seq {cfg.enc_seq}); "
        f"superblock {[(s.mixer, s.ffn) for s in model.specs]} x "
        f"{model.n_super}; depth cut: {cut} ({why}); {n} parameters = "
        f"{'param_stats' if by_tree else 'the formula'} (formula {formula})"
        f", {n_bytes} bytes of {model.dtype}, drawn from seed {args.seed} "
        f"in {init_s:.1f} s (peak device memory while drawn "
        f"{init_peak / 2**30:.2f} GiB)")
    return model, params


def model_launches(model, steps: int):
    """The attention launches one prefill and ``steps`` decode steps of
    ``model`` make: ``flash_attention`` once a causal attention layer, an
    encoder layer and a cross-attention a prefill, and once a
    cross-attention a step; ``paged_attention`` once an attention layer a
    step.  Returns them with the counts of attention and cross layers."""
    n_attn = model.n_super * sum(s.mixer == "attn" for s in model.specs)
    n_cross = model.n_super * sum(s.cross for s in model.specs)
    flash = n_attn + n_cross + (model.cfg.n_enc_layers
                                if model.cfg.enc_dec else 0)
    return ({"flash_attention": flash + steps * n_cross,
             "paged_attention": steps * n_attn}, n_attn, n_cross)


def model_run(args, model, params, tag: str, prompt_len: int = 1152):
    """One 4 x ``prompt_len`` prefill and 4 greedy decode steps through
    ``Model``, after a warm-up prefill and decode step whose pages the
    prefill refills in place (a dense model's steps then replay the graph
    the warm-up captured), an encoder-decoder's frames (4 x enc_seq x
    d_model, bf16, from ``--seed``) encoded in the prefill; the launch
    counts set to 0 just before and read just after, and the attention
    kernels' launches traced by ``torch.profiler``.  Checks each kernel's
    count, finite logits and the cache length.  Returns the capture and
    the counts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import KERNELS, reset_launches
    cfg = model.cfg
    rng = np.random.default_rng(args.seed)
    toks = torch.as_tensor(np.stack(serve_prompts(rng, cfg.vocab)[:4])
                           [:, :prompt_len], dtype=torch.int64, device="cuda")
    frames = None
    if cfg.enc_dec:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        frames = torch.randn(4, cfg.enc_seq, cfg.d_model, generator=gen,
                             device="cuda").to(model.dtype)
    want, n_attn, n_cross = model_launches(model, steps=4)
    capture = ServeCapture()
    try:
        _, cache = model.prefill(params, toks, frames=frames, max_len=2048)
        model.decode_step(params, cache, toks[:, -1:])
        capture.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            logits, cache = model.prefill(params, toks, frames=frames,
                                          max_len=2048, cache=cache)
            torch.cuda.synchronize()
            pre_ms = 1e3 * (time.perf_counter() - t1)
            out, dec_ms = [], []
            for _ in range(4):
                tok = logits[:, -1].argmax(-1, keepdim=True)
                out.append(tok)
                t1 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, tok)
                torch.cuda.synchronize()
                dec_ms.append(1e3 * (time.perf_counter() - t1))
    finally:
        capture.close()
    launches = {k.__name__: k.launches for k in KERNELS}
    traced = traced_launches(prof)
    del prof
    flash = want["flash_attention"] - 4 * n_cross
    check(all(launches[k] == v for k, v in want.items()),
          f"{cfg.arch_id}: launches {launches}, expected {want} for one "
          f"prefill and 4 decode steps")
    check(all(traced[k] == want[k] for k in traced),
          f"{cfg.arch_id}: the profiler traced {traced} attention "
          f"launches, expected {want}")
    check(capture.calls["flash_attention"] == launches["flash_attention"]
          and capture.calls["paged_attention"] <= launches["paged_attention"],
          f"{cfg.arch_id}: a kernel wrapper was called without launching")
    check(bool(torch.isfinite(logits).all()) and
          int(cache["length"]) == toks.shape[1] + 4,
          f"{cfg.arch_id}: non-finite logits or a wrong cache length")
    tokens = 4 * (toks.shape[1] + 4)
    how = ("replay the graph the warm-up captured"
           if capture.last is not None else "run eagerly")
    log(f"{tag} {cfg.arch_id}: one 4 x {toks.shape[1]} prefill "
        f"{pre_ms:.2f} ms, 4 decode steps {', '.join(f'{t:.2f}' for t in dec_ms)}"
        f" ms (mean {np.mean(dec_ms):.2f}); {tokens} tokens; greedy tokens "
        f"{torch.cat(out, 1).tolist()}; launches {launches} (flash: "
        f"{flash} a prefill = {n_attn} causal"
        + (f" + {cfg.n_enc_layers} encoder + {n_cross} cross" if cfg.enc_dec
           else "") + f", {n_cross} a step; paged: {n_attn} a step), equal "
        f"to the launches the profiler traced ({traced}; the prefill and the "
        f"steps under torch.profiler, CUDA activity only; the steps "
        f"{how}); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return capture, launches


def model_attn_checks(capture, launches, tag: str, run: str):
    """Every distinct flash_attention input shape of the run and its
    longest paged_attention step held to ``attn_bound`` and timed beside
    SDPA."""
    for (qs, ks, causal), inputs in sorted(capture.flash_shapes.items(),
                                           key=lambda x: str(x[0])):
        flash_row(inputs, launches, tag, f"{run}'s q {qs} over k/v {ks}, "
                  f"causal {causal}", run)
    if capture.paged is not None:
        paged_row(capture.paged, launches, tag, run)


def reduced_parity(arch: str, seed: int, tag: str):
    """``arch`` at reduced size in f32 on cuda and on cpu from the same
    weights: prefill logits and 4 greedy decode steps within 2e-5 + 2e-5 x
    |cpu| (reduced jamba: ``JAMBA_BOUND``) with equal tokens; one
    ``make_train_step`` step's loss and gradient norm within 2e-5
    (jamba: ``JAMBA_BOUND``) relative and its new parameters within 1e-4 x
    max|p| + 1e-6; every MoE layer's kept (token, slot) set equal on both
    devices."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map
    import repro_torch.models.ffn as F
    from repro_torch.configs import get, reduced
    from repro_torch.kernels import KERNELS
    from repro_torch.models import build
    from repro_torch.optim import OptConfig, Optimizer, tree_leaves
    from repro_torch.train import make_train_step
    cfg = reduced(get(arch))
    bound = JAMBA_BOUND if cfg.family == "hybrid" else 2e-5
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 80)))
    frames = (torch.as_tensor(rng.standard_normal(
        (2, cfg.enc_seq, cfg.d_model)), dtype=torch.float32)
        if cfg.enc_dec else None)
    params = build(cfg, device="cpu").init(seed=seed)
    opt = Optimizer(OptConfig(lr=1e-3))
    route, runs = F.moe_route, {}

    def spy(ctx, router, xt):
        r = route(ctx, router, xt)
        kept[-1].append(tuple(x.cpu() for x in (r.idx, r.pos, r.keep)))
        return r

    before = {k.__name__: k.launches for k in KERNELS}
    F.moe_route = spy
    try:
        for dev in ("cuda", "cpu"):
            kept = [[]]
            model = build(cfg, device=dev)
            p = tree_map(lambda t: t.to(dev), params)
            fr = None if frames is None else frames.to(dev)
            logits, cache = model.prefill(p, toks.to(dev), frames=fr,
                                          max_len=128)
            seq, out = [logits.cpu()], []
            for _ in range(4):
                tok = logits[:, -1].argmax(-1, keepdim=True)
                out.append(tok.cpu())
                logits, cache = model.decode_step(p, cache, tok)
                seq.append(logits.cpu())
            if dev == "cuda":
                launches = {k.__name__: k.launches - before[k.__name__]
                            for k in KERNELS}
                want = model_launches(model, steps=4)[0]
                check(all(launches[k] == v for k, v in want.items()),
                      f"reduced {arch} on cuda: launches {launches}, "
                      f"expected {want}")
            batch = {"tokens": toks.to(dev), "labels": toks.to(dev)}
            if fr is not None:
                batch["frames"] = fr
            state, met = make_train_step(model, opt)(
                {"params": p, "opt": opt.init(p)}, batch)
            runs[dev] = (seq, torch.cat(out, 1), kept[0],
                         {k: float(met[k]) for k in ("loss", "grad_norm")},
                         [t.cpu() for t in tree_leaves(state["params"])])
    finally:
        F.moe_route = route
    (sa, ta, ka, ma, pa), (sb, tb, kb, mb, pb) = runs["cuda"], runs["cpu"]
    check(torch.equal(ta, tb), f"reduced {arch}: tokens differ between cuda "
          f"and cpu")
    worst = 0.0
    for a, b in zip(sa, sb):
        used, _, _ = check_close(a, b, bound + bound * b.abs(),
                                 f"reduced {arch} logits, cuda vs cpu")
        worst = max(worst, used)
    check(len(ka) == len(kb) and all(
        all(torch.equal(x, y) for x, y in zip(u, v)) for u, v in zip(ka, kb)),
        f"reduced {arch}: MoE routing (expert, slot place, kept) differs "
        f"between cuda and cpu")
    m_used = max(abs(ma[k] - mb[k]) / (bound * abs(mb[k])) for k in ma)
    check(m_used <= 1.0, f"reduced {arch}: train step {ma} vs {mb}")
    p_used = max(float((a - b).abs().max()) / (1e-4 * float(b.abs().max())
                                               + 1e-6)
                 for a, b in zip(pa, pb))
    check(p_used <= 1.0, f"reduced {arch}: new parameters cuda vs cpu "
          f"{p_used:.3f} of the bound")
    dropped = sum(int((~k[2]).sum()) for k in ka)
    log(f"{tag} reduced {arch} (f32, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv heads, "
        f"head_dim {cfg.hd}): prefill logits and 4 decode steps equal on cuda "
        f"and cpu within {bound} + {bound} x |cpu| (at most {worst:.3f} of "
        f"the bound), tokens {ta.tolist()}; "
        + (f"{len(ka)} MoE routings equal ({dropped} (token, slot) pairs "
           f"dropped by capacity), " if ka else "")
        + f"train step loss {ma['loss']:.7f} / {mb['loss']:.7f}, grad norm "
        f"{ma['grad_norm']:.7f} / {mb['grad_norm']:.7f} (at most "
        f"{m_used:.3f} of {bound} relative), new parameters at most "
        f"{p_used:.4f} of 1e-4 x max|p| + 1e-6; cuda launches {launches}")


# ------------------------------------------------- the other dense decoders
MODELS_CUT = 2          # layers of qwen3-32b, chameleon-34b, mistral-large


def phase_models(args):
    """[models] (a) smollm-360m at full width and depth serves the llama3-8b
    phase's traffic through ``ServeEngine`` (head dim 64, G = 3); (b)
    qwen3-32b, chameleon-34b and mistral-large-123b at full width and
    ``MODELS_CUT`` layers run a 4 x 1152 prefill and 4 decode steps through
    ``Model`` (``model_run``); (c) the four configs at reduced size in f32
    on cuda and on cpu from the same weights (``reduced_parity``).  Both
    attention kernels are held against their plain versions on the inputs
    of each run and timed beside SDPA."""
    import dataclasses
    import torch
    from repro_torch.configs import get
    t_phase = time.perf_counter()
    eng, model, params, prompts, capture, launches = serve_arch(
        args, "smollm-360m", "[models]")
    check(model.cfg.tie_embeddings and "lm_head" not in params,
          "smollm-360m: the tied tree has an lm_head")
    attn_rows(capture, launches, "[models] smollm-360m:", "the smollm run")
    del eng, model, params, capture
    torch.cuda.empty_cache()

    for arch in ("qwen3-32b", "chameleon-34b", "mistral-large-123b"):
        t0 = time.perf_counter()
        full = get(arch)
        model, params = model_params(
            args, dataclasses.replace(full, n_layers=MODELS_CUT), "[models]",
            f"{full.n_layers} -> {MODELS_CUT} layers",
            f"the full model's bf16 weights, {2 * full.n_params() / 1e9:.1f} "
            f"GB, would not leave room on the card; layers repeat, so "
            f"{MODELS_CUT} cross every code path")
        capture, launches = model_run(args, model, params, "[models]")
        model_attn_checks(capture, launches, "[models]", f"the {arch} run")
        del model, params, capture
        torch.cuda.empty_cache()
        log(f"[models] {arch}: {time.perf_counter() - t0:.1f} s")

    for arch in ("smollm-360m", "qwen3-32b", "mistral-large-123b",
                 "chameleon-34b"):
        reduced_parity(arch, args.seed, "[models]")
    log(f"[models] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------ the other model families
JAMBA_CUT = dict(n_layers=2, attn_every=2, attn_phase=0)
JAMBA_WHY = ("the pattern of its layers 4 and 5 (attention + dense FFN, "
             "then mamba + MoE); its 8-layer period holds 4 MoE FFNs, "
             "77.3 GB of bf16 experts, which do not fit the card beside "
             "the rest")
JAMBA_BOUND = 1e-4      # tests/test_torch_ssm.py's JAMBA and its reason


def family_cuts():
    """(config, cut, why) of the five runs: full width, bf16, depth cut
    only where the card forces it."""
    import dataclasses
    from repro_torch.configs import get
    out = []
    for arch in ("xlstm-350m", "whisper-medium"):
        out.append((get(arch), "none", "the whole model fits"))
    for arch in ("kimi-k2-1t-a32b", "arctic-480b"):
        full = get(arch)
        m = full.moe
        experts = 2 * 3 * m.n_experts * full.d_model * m.d_ff_expert
        out.append((dataclasses.replace(full, n_layers=1),
                    f"{full.n_layers} -> 1 layer",
                    f"the full model's bf16 weights are "
                    f"{2 * full.n_params() / 1e12:.2f} TB; one layer's "
                    f"{m.n_experts} experts are {experts / 1e9:.1f} GB, and "
                    f"the largest leaf is drawn in f32 first "
                    f"({2 * experts / 3 / 1e9:.1f} GB more while it is "
                    f"drawn)"))
    full = get("jamba-1.5-large-398b")
    out.append((dataclasses.replace(full, **JAMBA_CUT),
                f"{full.n_layers} -> 2 layers ({JAMBA_CUT})", JAMBA_WHY))
    return out


def phase_families(args):
    """[families] xlstm-350m, whisper-medium, kimi-k2-1t-a32b, arctic-480b
    and jamba-1.5-large-398b at full width (``family_cuts``), jamba also
    behind ``ServeEngine`` with the serve phase's traffic; the attention
    kernels held to their plain versions at every new shape; the sLSTM
    backward against autograd at full width; the five at reduced size in
    f32 on cuda and on cpu."""
    import torch
    from repro_torch.models import param_stats
    t_phase = time.perf_counter()
    tag = "[families]"
    for cfg, cut, why in family_cuts():
        t0 = time.perf_counter()
        if cfg.family == "hybrid":
            from repro_torch.models import build
            n = param_stats(build(cfg, device="cuda"))["total"]
            log(f"{tag} {cfg.arch_id}: depth cut {cut} ({why})")
            eng, model, params, _p, capture, launches = serve_arch(
                args, cfg, tag, n_expected=n)
            model_attn_checks(capture, launches, tag,
                              f"the {cfg.arch_id} serve run")
            del eng, capture
            torch.cuda.empty_cache()
        else:
            model, params = model_params(args, cfg, tag, cut, why)
        capture, launches = model_run(
            args, model, params, tag, 128 if cfg.enc_dec else 1152)
        model_attn_checks(capture, launches, tag, f"the {cfg.arch_id} run")
        del model, params, capture
        torch.cuda.empty_cache()
        log(f"{tag} {cfg.arch_id}: {time.perf_counter() - t0:.1f} s")
    slstm_grad_check(args.seed)
    for arch in ("kimi-k2-1t-a32b", "arctic-480b", "jamba-1.5-large-398b",
                 "xlstm-350m", "whisper-medium"):
        reduced_parity(arch, args.seed, tag)
    log(f"{tag} phase {time.perf_counter() - t_phase:.1f} s")


def slstm_grad_check(seed: int):
    """One sLSTM layer of xlstm-350m (D 1024) in f32 on the card, B 2 x S
    256: ``SLSTMScan``'s gradients of every parameter and of the input
    against plain autograd through the loop, each within 1e-4 x max|ref| +
    1e-6 (the [train] bound), for a random cotangent of the output."""
    import torch
    from repro_torch.configs import get
    from repro_torch.models import xlstm as X
    from repro_torch.models.common import ParamInit
    cfg = get("xlstm-350m")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pi = ParamInit(gen, torch.float32, torch.device("cuda"))
    p0 = {k: v[0] for k, v in
          X.make_slstm_params(pi, 1, cfg.d_model, cfg.n_heads).items()}
    x0 = torch.randn(2, 256, cfg.d_model, generator=gen, device="cuda")
    ct = torch.randn(2, 256, cfg.d_model, generator=gen, device="cuda")

    def grads(plain: bool):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        x = x0.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if plain:
            st = X.init_slstm_state(2, cfg.d_model, x.device)
            xin = x @ p["w_in"]
            hs = []
            for t in range(x.shape[1]):
                st = X._slstm_cell(p, xin[:, t], st)
                hs.append(st.h)
            y = X._slstm_ffn(p, torch.stack(hs, 1), x)
        else:
            y = X.slstm_seq(p, x)[0]
        (y * ct).sum().backward()
        torch.cuda.synchronize()
        return ({**{k: v.grad for k, v in p.items()}, "x": x.grad},
                time.perf_counter() - t0)

    grads(False), grads(True)                   # first-call costs
    (fn, fn_s), (ag, ag_s) = grads(False), grads(True)
    worst = 0.0
    for k in ag:
        used = float((fn[k] - ag[k]).abs().max()) / (
            1e-4 * float(ag[k].abs().max()) + 1e-6)
        check(used <= 1.0, f"sLSTM gradient of {k}: {used:.3f} of the bound")
        worst = max(worst, used)
    log(f"[families] sLSTM backward (xlstm-350m's width, D {cfg.d_model}, "
        f"f32, B 2 x S 256): SLSTMScan's gradients of {sorted(ag)} equal "
        f"plain autograd through the loop within 1e-4 x max|ref| + 1e-6, at "
        f"most {worst:.4f} of the bound; forward + backward {fn_s:.3f} s "
        f"(autograd through the loop {ag_s:.3f} s; each the second run)")


# ------------------------------------------------------------ training
# The [train] run's token stream draws over the first 512 ids (the data
# vocabulary of examples/train_smollm.py's reduced run); the model keeps
# its whole 49 152-way head.  Over all 49 152 ids the planted classes
# have 768 ids each, every id occurs about 5 times in 30 steps, and the
# port's loss does not fall in 30 steps (tools/train_curve.py on the card;
# tests/test_torch_train_vocab.py holds the two packages' curves equal on
# such a stream at a small width).  Over 512 ids the loss falls from
# ln 49 152 to about ln 512 = 6.24, the ids' support, and stays there for
# 120 steps: the fall shows that the head learns which ids occur, not that
# the blocks' gradients are right.  ``train_gradient_check`` holds those.
TRAIN_DATA_VOCAB = 512


def phase_train(args):
    """[train] smollm-360m at full width and depth trains 30 steps (bf16
    parameters, AdamW with f32 moments, lr 3e-3 with 5 warmup steps, remat
    per layer, SyntheticLM batch 8 x seq 1024 over ``TRAIN_DATA_VOCAB``
    ids, one microbatch) and its mean loss over the last 5 steps must be
    at least 0.2 below the first 5's; one more step runs under
    ``torch.profiler``;
    then 3 steps with int8 moments; then ``train_gradient_check`` at full
    width and depth in f32; then, at reduced size in f32 on the card,
    ``train_reduced_checks``: one step with 1 and with 4 microbatches, each
    against cpu, and the fault drill (a crash at step 12 of 16, a restore
    from a checkpoint in a temporary directory, the run finished at 16)."""
    import tempfile
    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves as leaves_of
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import KERNELS
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, Trainer
    t_phase = time.perf_counter()
    cfg = get("smollm-360m")
    data = DataConfig(vocab=TRAIN_DATA_VOCAB, seq_len=1024, global_batch=8,
                      seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        for moments, steps in (("fp32", 30), ("int8", 3)):
            model = build(cfg, device="cuda")
            tr = Trainer(model, OptConfig(lr=3e-3, warmup_steps=5,
                                          total_steps=60, moments=moments),
                         TrainConfig(ckpt_every=10 ** 9, ckpt_dir=tmp),
                         SyntheticLM(data))
            tr.init_state(args.seed)
            n_params = sum(t.numel() for t in leaves_of(tr.state["params"]))
            check(n_params == cfg.n_params(), "smollm-360m parameter count")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = {k.__name__: k.launches for k in KERNELS}
            t0 = time.perf_counter()
            losses = tr.run(steps)
            wall = time.perf_counter() - t0
            check(all(k.launches == before[k.__name__] for k in KERNELS),
                  "train: a hand-written kernel launched on the training "
                  "path")
            check(all(np.isfinite(losses)), f"train: loss {losses}")
            dts = [h["dt"] for h in tr.history]
            med = float(np.median(dts))
            peak = torch.cuda.max_memory_allocated()
            tag = (f"[train] smollm-360m full width and depth ({n_params} "
                   f"parameters, bf16, remat {cfg.remat}), AdamW {moments} "
                   f"moments, lr 3e-3 warmup 5, batch 8 x seq 1024 over "
                   f"{TRAIN_DATA_VOCAB} token ids, {steps} steps")
            if moments == "fp32":
                first, last = np.mean(losses[:5]), np.mean(losses[-5:])
                check(last < first - 0.2, f"train: mean loss of the last 5 "
                      f"steps {last:.4f} not 0.2 below the first 5's "
                      f"{first:.4f}")
                log(f"{tag}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean "
                    f"of the first 5 {first:.4f}, of the last 5 {last:.4f}); "
                    f"{wall:.2f} s with the final checkpoint's save; "
                    f"median {1e3 * med:.2f} ms per step (min "
                    f"{1e3 * min(dts):.2f}, max {1e3 * max(dts):.2f}, first "
                    f"{1e3 * dts[0]:.2f}) = {8 * 1024 / med:.0f} tokens/s; "
                    f"peak device memory {peak} bytes "
                    f"({peak / 2 ** 30:.2f} GiB); stragglers "
                    f"{tr.watchdog.summary()['stragglers']}; losses "
                    f"{' '.join(f'{x:.4f}' for x in losses)}")
                launch_train(tr)
            else:
                log(f"{tag}: losses {[round(x, 4) for x in losses]}; median "
                    f"{1e3 * med:.2f} ms per step; peak device memory {peak} "
                    f"bytes ({peak / 2 ** 30:.2f} GiB)")
            del tr, model
            torch.cuda.empty_cache()
    train_gradient_check(args.seed)
    torch.cuda.empty_cache()
    train_reduced_checks(args.seed)
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ [launch]
SPEC = []               # the card's launch.device.DeviceSpec, read once
LAUNCH_S = [0.0]        # the [launch] phase's seconds, over its parts
SHARE_MAX = 1.05        # a step faster than its bound means a wrong count


def load_spec():
    """The kernel rows' data-sheet rates, from the port's device table."""
    global MEM_BW_BYTES_PER_S, PEAK_BF16_FLOPS
    from repro_torch.launch.device import H100_SXM5_80GB
    MEM_BW_BYTES_PER_S = H100_SXM5_80GB.hbm_bw
    PEAK_BF16_FLOPS = H100_SXM5_80GB.peak_bf16_flops


def launch_device(smi: str):
    """[launch] (a): ``device_spec()`` on the card, which must be the
    table's H100 SXM5 entry, beside the nvidia-smi line."""
    t0 = time.perf_counter()
    from repro_torch.launch.device import device_spec
    spec = device_spec()
    check(spec.name == "H100-SXM5-80GB", f"launch: device_spec() gave "
          f"{spec.name}, not the table's H100-SXM5-80GB")
    SPEC.append(spec)
    LAUNCH_S[0] += time.perf_counter() - t0
    log(f"[launch] device_spec(): {spec.name} (the card: {spec.card}, "
        f"{spec.sm_count} SMs, {spec.hbm_bytes:.0f} bytes, power limit "
        f"{spec.power_limit}); data-sheet peaks {spec.peak_bf16_flops:.4g} "
        f"dense bf16 FLOP/s, {spec.hbm_bw:.4g} HBM bytes/s, "
        f"{spec.link_bw:.4g} NVLink bytes/s a direction; nvidia-smi: {smi}")


def launch_measure(tag: str, profile_tag: str, step, res):
    """[launch] (b): ``step`` timed on the card beside its count on meta
    (``res``, from ``dryrun.count_step`` at the run's shapes): the share of
    its bound and its MFU, and the counted argument bytes beside the peak
    device memory of the timed calls; and, as ``profile_tag``, the
    profiled call's wall time, device busy share and top kernels."""
    import torch
    from repro_torch.launch.roofline import measure
    spec = SPEC[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = measure(step, costs=res["costs"], model_flops=res["model_flops"],
                spec=spec)
    peak = torch.cuda.max_memory_allocated()
    args = res["memory"]["argument_bytes"]
    log_profile(profile_tag, m)
    busy = (f"{1e3 * m['t_busy']:.3f} ms" if m["t_busy"] is not None
            else "not measured (no device activity in the profiler)")
    log(f"[launch] {tag}: counted {m['flops']:.6e} FLOPs, "
        f"{m['hbm_bytes']:.6e} HBM bytes ({m['hbm_bytes_raw']:.6e} with "
        f"the attention kernels' plain versions), {res['count_s']:.2f} s on "
        f"meta; t_compute "
        f"{1e3 * m['t_compute']:.3f} ms, t_memory {1e3 * m['t_memory']:.3f}"
        f" ms at the data sheet's peaks: bound {1e3 * m['t_bound']:.3f} ms "
        f"({m['bottleneck']}); step {1e3 * m['t_step']:.3f} ms (median of "
        f"{', '.join(f'{1e3 * t:.3f}' for t in m['t_steps'])} between CUDA "
        f"events), device busy {busy}; share_of_bound "
        f"{m['share_of_bound']:.4f}, mfu {m['mfu']:.4f} (model FLOPs "
        f"{res['model_flops']:.6e}); argument bytes {args}, peak allocated "
        f"{peak}; {spec.card}, {spec.power_limit}")
    check(0 < m["share_of_bound"] <= SHARE_MAX,
          f"launch: {tag}: share_of_bound {m['share_of_bound']:.4f} outside "
          f"(0, {SHARE_MAX}]")
    check(peak >= args, f"launch: {tag}: peak device memory {peak} below "
          f"the counted argument bytes {args}")


def log_profile(name: str, m):
    """``measure``'s profiled call: its wall time, the device's busy share,
    its kernels, the attention kernels and the top ones by device time."""
    wall = m["t_profiled"]
    if m["t_busy"] is None:
        log(f"{name}: wall {1e3 * wall:.2f} ms; the profiler recorded no "
            f"device activity (device busy share not measured)")
        return
    busy = m["t_busy"]
    ours = "; ".join(
        f"{key.split('<')[0].split('::')[-1]} x{n} {1e3 * t:.3f} ms"
        for key, n, t in m["top"]
        if any(a in key for a in ("flash_fwd", "paged_split",
                                  "paged_combine")))
    top = "; ".join(f"{key[:60]} x{n} {1e3 * t:.3f} ms"
                    for key, n, t in m["top"][:8])
    log(f"{name}: wall {1e3 * wall:.2f} ms, device busy {1e3 * busy:.2f} ms "
        f"(share {busy / wall:.3f}, idle {1 - busy / wall:.3f}), "
        f"{m['n_kernels']} kernels; attention kernels: {ours or 'none'}; "
        f"top: {top}")


def launch_serve(model, params, prompts):
    """[launch] (b) in [serve]: llama3-8b's 4 x 1152 prefill and one
    decode step, each counted on meta at the run's shapes and measured
    (the decode step's five calls advance the cache from position 1152 to
    1156; the count is at 1152)."""
    import numpy as np
    import torch
    from repro_torch.launch.dryrun import count_step
    t0 = time.perf_counter()
    toks = torch.as_tensor(np.stack(prompts), dtype=torch.int64,
                           device=model.device)
    B, S = toks.shape
    prefill = type(model).prefill.__get__(model)      # not the timed one
    decode = type(model).decode_step.__get__(model)
    res = count_step(model.cfg, "prefill", B, S, max_len=2048,
                     spec=SPEC[0])
    launch_measure(f"llama3-8b prefill {B} x {S} (max_len 2048)",
                   f"[profile] prefill ({B} x {S} tokens)",
                   lambda: prefill(params, toks, max_len=2048), res)
    _, cache = prefill(params, toks, max_len=2048)
    res = count_step(model.cfg, "decode", B, S + 1, max_len=2048,
                     spec=SPEC[0])
    launch_measure(f"llama3-8b decode step {B} x 1 at position {S} of "
                   f"2048", "[profile] decode step",
                   lambda: decode(params, cache, toks[:, -1:]), res)
    del cache
    LAUNCH_S[0] += time.perf_counter() - t0


def launch_train(tr):
    """[launch] (b) in [train]: the smollm-360m step counted on meta and
    measured; (c) one dry-run cell through ``dryrun.run_cell``."""
    from repro_torch.launch.dryrun import count_step, run_cell
    t0 = time.perf_counter()
    batch = tr._batch(tr.step)
    B, S = batch["tokens"].shape
    res = count_step(tr.model.cfg, "train", B, S, n_micro=tr.tcfg.n_micro,
                     spec=SPEC[0])

    def step():
        tr.state, _ = tr.step_fn(tr.state, batch)

    launch_measure(f"smollm-360m train step {B} x {S} (AdamW fp32, remat "
                   f"{tr.model.cfg.remat}, {tr.tcfg.n_micro} microbatch)",
                   "[train] profiled step", step, res)
    t1 = time.perf_counter()
    cell = run_cell("llama3-8b", "decode_32k", spec=SPEC[0])
    r, mem = cell["roofline"], cell["memory"]
    check(r["flops"] > 0 and r["hbm_bytes"] > 0 and cell["n_chips"] == 1
          and cell["step"] == "serve_step", "launch: run_cell gave "
          f"{cell['roofline']}")
    log(f"[launch] dryrun.run_cell('llama3-8b', 'decode_32k'): "
        f"{r['flops']:.6e} FLOPs, {r['hbm_bytes']:.6e} HBM bytes, t_compute "
        f"{1e3 * r['t_compute']:.3f} ms, t_memory {1e3 * r['t_memory']:.3f} "
        f"ms ({r['bottleneck']}), resident {mem['resident_bytes']} bytes, "
        f"fits_h100_80g {mem['fits_h100_80g']}; "
        f"{time.perf_counter() - t1:.2f} s")
    LAUNCH_S[0] += time.perf_counter() - t0
    log(f"[launch] phase {LAUNCH_S[0]:.1f} s (device_spec, the serve and "
        f"train measurements, one dry-run cell)")


GRAD_CHECK_LAYERS = (0, 10, 21, 31)     # of smollm-360m's 32 layers
GRAD_CHECK_STEP = 0.02                  # of a slice's rms, an element
GRAD_CHECK_TOL = 0.02                   # relative, plus GRAD_CHECK_FLOOR
GRAD_CHECK_FLOOR = 5e-8                 # f32 rounding in the forward


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _loss_f64(model, params, batch) -> float:
    """``model.loss`` with its cross-entropy summed in f64, so that a
    difference of two losses is not rounded to the f32 ulp of the loss."""
    import torch
    with torch.no_grad():
        logits = model.forward(params, batch["tokens"])
    logits = logits[..., :model.cfg.vocab].double()
    labels = batch["labels"]
    valid = labels >= 0
    picked = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return float(((torch.logsumexp(logits, -1) - picked) * valid).sum()
                 / valid.sum())


def directional_grad_check(model, params, batch, picks, seed: int):
    """Autograd's gradient g, taken as the trainer takes it, against a
    difference quotient of the loss.  For each (name, leaf name, index) of
    ``picks``, the slice ``leaf[index]`` (a contiguous view into
    ``params``) moves along a random normal direction d drawn from
    ``seed``, ``GRAD_CHECK_STEP`` x the slice's rms an element.  With D(t) =
    (L(p + t d) - L(p - t d)) / 2, Richardson's (8 D(1) - D(2)) / 6, whose
    error is fifth order in d, must equal g . d within ``GRAD_CHECK_TOL``
    x |g . d| + ``GRAD_CHECK_FLOOR``.  Returns (name, g . d, the
    difference, the share of the bound used) per pick."""
    import torch
    from repro_torch.train.trainer import _value_and_grad
    _, grads = _value_and_grad(model, params, batch)
    grad_of, param_of = dict(_named_leaves(grads)), dict(_named_leaves(params))
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for name, leaf_name, index in picks:
        ps, gs = param_of[leaf_name], grad_of[leaf_name]
        if index is not None:
            ps, gs = ps[index], gs[index]
        rms = max(float(ps.float().pow(2).mean().sqrt()), 1e-3)
        d = (GRAD_CHECK_STEP * rms * torch.randn(ps.shape, generator=gen,
                                                 dtype=torch.float64))
        lin = float((gs.double().cpu() * d).sum())
        d = d.to(ps.device, ps.dtype)
        orig = ps.clone()
        loss_at = {}
        for t in (1, 2, -1, -2):
            ps.copy_(orig).add_(d, alpha=t)
            loss_at[t] = _loss_f64(model, params, batch)
        ps.copy_(orig)
        fd = (8 * (loss_at[1] - loss_at[-1]) - (loss_at[2] - loss_at[-2])) / 12
        rows.append((name, lin, fd, abs(fd - lin)
                     / (GRAD_CHECK_TOL * abs(lin) + GRAD_CHECK_FLOOR)))
    return rows


def train_gradient_check(seed: int):
    """smollm-360m at full width and depth in f32 (batch 2 x seq 1024 over
    ``TRAIN_DATA_VOCAB`` ids, remat per layer): every leaf of layers
    ``GRAD_CHECK_LAYERS``, the final norm and the used rows of the tied
    embedding through ``directional_grad_check``.  A gradient that is
    wrong, missing or scaled in any of them fails, which the loss curve
    alone cannot show."""
    import dataclasses
    import torch
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get("smollm-360m"), dtype="float32")
    model = build(cfg, device="cuda")
    params = model.init(seed)
    vocab, seq, layers = TRAIN_DATA_VOCAB, 1024, GRAD_CHECK_LAYERS
    batch = {k: torch.from_numpy(v).to("cuda", torch.int64)
             for k, v in SyntheticLM(DataConfig(
                 vocab=vocab, seq_len=seq, global_batch=2,
                 seed=seed)).batch_at(0).items()}
    picks = [(f"embed[:{vocab}]", "/embed", slice(0, vocab)),
             ("final_norm", "/final_norm", None)]
    for i in layers:
        picks += [(f"layer {i}{name[9:]}", name, i) for name, _ in
                  _named_leaves(params["layers"][0], "/layers/0")]
    rows = directional_grad_check(model, params, batch, picks, seed)
    worst = max(rows, key=lambda r: r[3])
    for name, lin, fd, used in rows:
        check(used <= 1.0, f"train: gradient of {name}: g . d {lin:.6e}, "
              f"difference quotient {fd:.6e} ({used:.3f} of the bound)")
    log(f"[train] gradient check, smollm-360m ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, f32, remat {cfg.remat}, batch 2 x seq "
        f"{seq}): {len(rows)} slices (every leaf of layers "
        f"{', '.join(map(str, layers))}, final_norm, embed rows < {vocab}) "
        f"agree with a difference quotient of the loss (step "
        f"{GRAD_CHECK_STEP} x rms an element) within {GRAD_CHECK_TOL} x "
        f"|g . d| + {GRAD_CHECK_FLOOR}, at most {worst[3]:.3f} of the "
        f"bound ({worst[0]}: g . d {worst[1]:.6e}, difference "
        f"{worst[2]:.6e}); |g . d| from "
        f"{min(abs(r[1]) for r in rows):.3e} to "
        f"{max(abs(r[1]) for r in rows):.3e}; "
        f"{time.perf_counter() - t0:.1f} s")


def train_reduced_checks(seed: int):
    """Reduced smollm-360m in f32 on the card: one step with 1 and with 4
    microbatches, each against the same step on cpu and the 4-microbatch
    step against the 1-microbatch step, all within the CPU tests' bounds
    (the loss within 2e-5 relative, each new parameter within
    1e-4 x max|p| + 1e-6), and the fault drill."""
    import tempfile
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get, reduced
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build
    from repro_torch.optim import OptConfig, Optimizer, tree_leaves
    from repro_torch.train import TrainConfig, Trainer, make_train_step
    cfg = reduced(get("smollm-360m"))
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (4, 32)))
    params = build(cfg, device="cpu").init(seed=seed)
    opt = Optimizer(OptConfig(lr=1e-3))
    out = {}
    for dev in ("cuda", "cpu"):
        for n_micro in (1, 4):
            p = tree_map(lambda t: t.to(dev), params)
            batch = {"tokens": toks.to(dev), "labels": toks.to(dev)}
            state, metrics = make_train_step(build(cfg, device=dev), opt,
                                             n_micro=n_micro)(
                {"params": p, "opt": opt.init(p)}, batch)
            out[dev, n_micro] = (float(metrics["loss"]), [
                t.cpu() for t in tree_leaves(state["params"])])
    used = {}
    for what, x, y in (("cuda vs cpu, 1 microbatch", ("cuda", 1), ("cpu", 1)),
                       ("cuda vs cpu, 4 microbatches", ("cuda", 4),
                        ("cpu", 4)),
                       ("4 vs 1 microbatches on cuda", ("cuda", 4),
                        ("cuda", 1))):
        (la, pa), (lb, pb) = out[x], out[y]
        check(abs(la - lb) <= 2e-5 * abs(lb),
              f"train: loss {what}: {la} vs {lb}")
        used[what] = max(float((a - b).abs().max())
                         / (1e-4 * float(b.abs().max()) + 1e-6)
                         for a, b in zip(pa, pb))
        check(used[what] <= 1.0, f"train: new parameters {what} past the "
              f"bound ({used[what]:.3f} of it)")
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(build(cfg, device="cuda"),
                     OptConfig(lr=3e-3, warmup_steps=5, total_steps=60),
                     TrainConfig(ckpt_every=5, ckpt_dir=tmp),
                     SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                            global_batch=4, seed=seed)))
        tr.init_state(seed)
        losses, recovered = tr.run_with_recovery(16, fail_at=12)
        check(recovered and tr.step == 16 and len(losses) == 6 and
              tr.ckpt.latest().endswith("step_00000016"),
              f"train: fault drill (recovered {recovered}, step {tr.step}, "
              f"{len(losses)} losses after the restore)")
    log(f"[train] reduced smollm-360m (f32) on the card: losses cuda "
        f"{out['cuda', 1][0]:.7f} / {out['cuda', 4][0]:.7f} and cpu "
        f"{out['cpu', 1][0]:.7f} / {out['cpu', 4][0]:.7f} with 1 / 4 "
        f"microbatches; new parameters at most " + ", ".join(
            f"{u:.3f} ({w})" for w, u in used.items()) + " of the bound "
        f"1e-4 x max|p| + 1e-6; fault drill: crash "
        f"at step 12 of 16, restored from step 10's checkpoint, finished at "
        f"16 (losses after the restore {[round(x, 4) for x in losses]})")


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
    ap.add_argument("--only", choices=("models", "families", "train"),
                    action="append",
                    help="development aid: build the kernels and run only "
                    "these phases (repeatable); prints no kernels line and "
                    "no final result line")
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
    load_spec()
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
    launch_device(smi)
    dev = torch.device("cuda")
    if args.only:
        for name in args.only:
            {"models": phase_models, "families": phase_families,
             "train": phase_train}[name](args)
        log(f"[done] {time.perf_counter() - t_start:.1f} s (only "
            f"{', '.join(args.only)})")
        return 0
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
    st = fleet.stats()
    rows = phase_kernel_timings(cl, capture, launches)
    phase_audit(cl, fleet, acked)
    log(f"[fleet] signature sha1 "
        f"{hashlib.sha1(repr(signature(cl, fleet)).encode()).hexdigest()} "
        f"(after the audit, as tools/time_probes.py takes it); the fleet "
        f"phase's ticks {st['ticks']}, probe hits {st['probe_hits']}, "
        f"kernel launches {launches}")
    heap_audit_line(cl, "paper-scale fleet")
    del cl, fleet, capture
    torch.cuda.empty_cache()
    cl, capture, e_launches = phase_ycsbe(args)
    rows.append(leaf_probe_row(capture, e_launches))
    heap_audit_line(cl, "YCSB-E")
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
    phase_obs_parity()
    phase_obs_overhead()
    phase_sanitize()
    phase_explore()
    capture, serve_launches = phase_serve(args)
    rows += phase_serve_kernels(capture, serve_launches)
    del capture
    torch.cuda.empty_cache()
    phase_serve_parity(args.seed)
    phase_models(args)
    phase_families(args)
    phase_train(args)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
