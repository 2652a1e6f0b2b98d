"""The port on the card: each CUDA kernel against its plain torch version
(``race_lookup`` through its public wrapper and the probe path's packed
entry, ``fleet_read`` through its public wrapper and the pool's entry,
``leaf_probe`` on device and pinned host memory), the staging buffers, a
fleet tick's rows kept across the next tick, and a seeded fleet run,
fault run, YCSB-E run (with a client crashed inside a leaf split) and
serving run on ``cuda`` against the same runs on ``cpu`` — the fleet and
fault runs also with their obs surface (metrics, flight ring, hot-key
monitor, verb ring and profile) held to the CPU's.  Every test is
marked ``cuda`` and skips without a GPU.

This file imports neither ``jax`` nor the JAX package, so it also runs on
a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.obs as TO
from repro_torch.core import api as port_api
from repro_torch.core.shadow import build_shadow
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 fleet_read, fleet_read_plain, leaf_probe,
                                 leaf_probe_plain, paged_attention,
                                 paged_attention_plain, race_lookup,
                                 race_lookup_plain)
from repro_torch.kernels.race_lookup.ops import race_lookup_packed_plain

from _torch_parity import (assert_same_run, attn_bound, obs_signature,
                           port_serve_run, require_cuda, signature,
                           uniform_attn_inputs, ycsbe_crash_audit,
                           ycsbe_crash_scenario)

pytestmark = pytest.mark.cuda

EDGE_KEYS = [0, 1 << 31, (1 << 32) - 1, (1 << 31) - 1, 1]


@pytest.mark.parametrize("spb", [1, 8, 16])
def test_race_lookup_kernel_matches_plain(spb):
    require_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(spb)
    stored = torch.tensor(EDGE_KEYS[:3] + rng.integers(0, 1 << 32, 3000)
                          .tolist(), device=dev)
    table = build_shadow(stored, spb=spb)
    q = torch.cat([torch.tensor(EDGE_KEYS, device=dev), stored[:1000],
                   torch.tensor(rng.integers(0, 1 << 32, 1000), device=dev)])
    before = race_lookup.launches
    p_k, f_k = race_lookup(q, table)
    p_p, f_p = race_lookup_plain(q, table)
    torch.cuda.synchronize()
    assert race_lookup.launches == before + 1
    assert torch.equal(p_k, p_p) and torch.equal(f_k, f_p)
    assert bool(f_k[:3].all())


def _probe_case(spb, n, seed):
    """Keys (n,) and a shadow table of 3 000 seeded keys at ``spb`` (13 ·
    2^k buckets, not a power of two, for odd widths): the edge keys,
    stored keys and absent ones."""
    rng = np.random.default_rng(seed)
    stored = np.concatenate([EDGE_KEYS[:3], rng.integers(0, 1 << 32, 3000)])
    dev = torch.device("cuda")
    table = build_shadow(torch.tensor(stored, device=dev), spb=spb,
                         min_buckets=13 if spb % 2 else 16)
    q = np.concatenate([EDGE_KEYS, stored[rng.integers(0, stored.size, n)],
                        rng.integers(0, 1 << 32, n)])
    return q[rng.permutation(q.size)][:n], table


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 4096, 65536])
@pytest.mark.parametrize("spb", [1, 2, 7, 8, 16, 17, 33])
def test_race_lookup_kernel_matches_plain_at_every_width(spb, n):
    """The kernel (lane groups of 2, 4, 16 and 32, one and more slots a
    lane) against the plain version, bit for bit, through the public
    wrapper and the probe path's packed entry; each launch adds one to
    the count, and N = 0 launches nothing."""
    require_cuda()
    q, table = _probe_case(spb, n, seed=spb * 100 + n)
    keys = torch.from_numpy(q.astype(np.int64)).cuda()
    want_p, want_f = race_lookup_plain(keys, table)
    before = race_lookup.launches
    p_k, f_k = race_lookup(keys, table)
    torch.cuda.synchronize()
    assert race_lookup.launches == before + (n > 0)
    assert torch.equal(p_k, want_p) and torch.equal(f_k, want_f)
    packed = port_api.probe_to_host(q, table)
    assert race_lookup.launches == before + 2 * (n > 0)
    want = race_lookup_packed_plain(keys, table).cpu().numpy()
    assert packed.dtype == np.int32 and np.array_equal(packed, want)
    if n >= 16:
        assert 0 < int(want_f.sum()) < n        # hits and misses both


def test_back_to_back_probes_keep_their_answers():
    """Probes through the packed entry reuse one pinned mirror and one
    device buffer: each answer is a fresh array that the next probes
    (larger, smaller, and through the public wrapper between them) leave
    as it was."""
    require_cuda()
    q, table = _probe_case(8, 4096, seed=11)
    want = race_lookup_packed_plain(torch.from_numpy(q).cuda(), table)
    want = want.cpu().numpy()
    answers = [port_api.probe_to_host(q, table),
               port_api.probe_to_host(q[:17], table)]
    race_lookup(torch.from_numpy(q[::-1].copy()).cuda(), table)
    answers.append(port_api.probe_to_host(q[::-1].copy(), table))
    answers.append(port_api.probe_to_host(q[5:9], table))
    torch.cuda.synchronize()
    assert np.array_equal(answers[0], want)
    assert np.array_equal(answers[1], want[:17])
    assert np.array_equal(answers[2], want[::-1])
    assert np.array_equal(answers[3], want[5:9])


def test_fleet_read_kernel_matches_plain():
    require_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    words = rng.integers(0, 1 << 64, 8 * 1024, dtype=np.uint64)
    words[::13] = (1 << 63) + np.arange(0, words.size, 13, dtype=np.uint64)
    words[::7] = (1 << 32) - 1
    slab = torch.from_numpy(words.view(np.int64)).to(dev)
    lens = rng.integers(0, 200, 500)
    lens[::3] = 0                                   # zero-length verbs
    base = torch.tensor(rng.integers(0, slab.numel() - 200, 500), device=dev)
    start = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), device=dev)
    total = int(lens.sum())
    before = fleet_read.launches
    got = fleet_read(slab, base, start, total)
    want = fleet_read_plain(slab, base, start, total)
    torch.cuda.synchronize()
    assert fleet_read.launches == before + 1
    assert torch.equal(got, want)
    assert fleet_read(slab, base[:0], start[:1], 0).numel() == 0
    assert fleet_read.launches == before + 1        # nothing to launch


LEAF_EDGES = [0, 1 << 31, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
              (1 << 64) - 2]


@pytest.mark.parametrize("n", [1, 1000, 4097])
@pytest.mark.parametrize("m", [0, 1, 40_000])
def test_leaf_probe_kernel_matches_plain(n, m):
    """Bit for bit against the plain version: starts and lows at the 32-
    and 64-bit boundaries, a run of duplicate lows, no lows at all."""
    require_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(n + m)
    edges = np.array(LEAF_EDGES, np.uint64)
    lows = np.concatenate([rng.choice(edges, min(m, 7)),
                           rng.integers(0, 1 << 64, max(m - 7, 0),
                                        dtype=np.uint64)])
    if m > 7:
        lows[10:50] = lows[10]
    lows = np.sort(lows)
    starts = np.concatenate([edges, edges - np.uint64(1), lows[:50],
                             rng.integers(0, 1 << 64, n, dtype=np.uint64)])[:n]
    st = torch.from_numpy(starts.view(np.int64)).to(dev)
    lw = torch.from_numpy(lows.view(np.int64)).to(dev)
    before = leaf_probe.launches
    got = leaf_probe(st, lw)
    want = leaf_probe_plain(st, lw)
    torch.cuda.synchronize()
    assert leaf_probe.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(),
                          np.searchsorted(lows, starts, side="right") - 1)
    assert leaf_probe(st[:0], lw).numel() == 0
    assert leaf_probe.launches == before + 1        # nothing to launch


FENCE_EDGES = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4096])
@pytest.mark.parametrize("m", [0, 1, 31, 32, 33, 1024, 1025, 35_000])
def test_leaf_probe_search_matches_plain(n, m):
    """The 32-ary warp search bit for bit against the plain version at
    every step count: runs of equal lows, lows and starts at 2^63 - 1, 2^63
    and 2^64 - 1, starts below every low."""
    require_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(7 * n + m)
    edges = np.array(FENCE_EDGES, np.uint64)
    lows = np.concatenate([rng.choice(edges, min(m, 5)),
                           rng.integers(1, 1 << 64, max(m - 5, 0),
                                        dtype=np.uint64)])
    if m > 8:
        lows[m // 4:m // 4 + min(m // 3, 70)] = lows[m // 4]   # equal lows
    lows = np.sort(lows)
    starts = np.concatenate([edges, edges - np.uint64(1), lows[::97],
                             lows[::89] - np.uint64(1),
                             rng.integers(0, 1 << 64, n, dtype=np.uint64)])
    starts = rng.permutation(starts)[:n]
    st = torch.from_numpy(starts.view(np.int64)).to(dev)
    lw = torch.from_numpy(lows.view(np.int64)).to(dev)
    out = torch.full((n,), -7, dtype=torch.int32, device=dev)
    before = leaf_probe.launches
    got = leaf_probe(st, lw, out=out)
    want = leaf_probe_plain(st, lw)
    torch.cuda.synchronize()
    assert leaf_probe.launches == before + 1 and got is out
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(),
                          np.searchsorted(lows, starts, side="right") - 1)


@pytest.mark.parametrize("n", [1, 33, 4096])
def test_leaf_probe_reads_and_writes_pinned_host_memory(n):
    """Beside device lows, pinned host starts and out are read and written
    in place by the kernel (the locate path's staging); unpinned host
    memory is refused."""
    require_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(n)
    lows = np.sort(rng.integers(0, 1 << 64, 3312, dtype=np.uint64))
    lows[100:140] = lows[100]
    lw = torch.from_numpy(lows.view(np.int64)).to(dev)
    starts = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    st = torch.from_numpy(starts.view(np.int64)).pin_memory()
    out = torch.full((n,), -7, dtype=torch.int32).pin_memory()
    before = leaf_probe.launches
    assert leaf_probe(st, lw, out=out) is out
    torch.cuda.synchronize()
    assert leaf_probe.launches == before + 1
    assert torch.equal(out, leaf_probe_plain(st.to(dev), lw).cpu())
    assert np.array_equal(out.numpy(),
                          np.searchsorted(lows, starts, side="right") - 1)
    with pytest.raises(ValueError):
        leaf_probe(st.clone(), lw)                  # pageable host memory


def test_fleet_read_tick_writes_at_an_offset():
    """The pool's entry reads base and start at offsets of one upload
    buffer and writes 0-, 1- and 128-word verbs (and a run of 2 000
    zero-length verbs) at an offset of a larger staging
    buffer, leaving every other word of it untouched; the public wrapper
    gives the plain version's words."""
    require_cuda()
    from repro_torch.kernels.fleet_tick import ops as fr_ops
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 64, 1 << 14, dtype=np.uint64)
    slab = torch.from_numpy(words.view(np.int64)).to(dev)
    lens = np.array([0, 1, 128, 0, 1, 128] * 40 + [0] * 2000 + [128, 1, 0]
                    + list(rng.integers(0, 130, 300)), np.int64)
    base = rng.integers(0, slab.numel() - 130, lens.size)
    start = np.concatenate([[0], np.cumsum(lens)])
    total = int(start[-1])
    junk = rng.integers(-9, 9, 11)
    buf = torch.from_numpy(np.concatenate([junk, base, junk, start])).to(dev)
    b0, s0 = junk.size, 2 * junk.size + base.size
    stage = torch.full((total + 300,), -5, dtype=torch.int64, device=dev)
    before = fleet_read.launches
    fr_ops.fleet_read_tick(slab, buf, slice(b0, b0 + base.size),
                           slice(s0, s0 + start.size), total, stage, 137,
                           dev)
    b_t, s_t = (torch.from_numpy(x).to(dev) for x in (base, start))
    want = fleet_read_plain(slab, b_t, s_t, total)
    public = fleet_read(slab, b_t, s_t, total)
    torch.cuda.synchronize()
    assert fleet_read.launches == before + 2
    assert torch.equal(stage[137:137 + total], want)
    assert bool((stage[:137] == -5).all()) and \
        bool((stage[137 + total:] == -5).all())
    assert torch.equal(public, want)
    host = np.concatenate([words[b:b + k] for b, k in zip(base, lens)])
    assert np.array_equal(want.cpu().numpy().view(np.uint64), host)


def test_staging_uploads_and_downloads_on_cuda():
    """``Staging`` on the card: uploads land on the device (the second one
    waits for the first to leave the pinned mirror), the buffers grow, and
    a download is a fresh host array that a later upload or kernel write
    does not change."""
    require_cuda()
    from repro_torch.core.staging import Staging
    stage = Staging(torch.device("cuda"))
    a = np.arange(100, dtype=np.int64) - 50
    d = stage.upload(a)
    assert d.is_cuda and d.numel() == 100
    assert np.array_equal(d.cpu().numpy(), a)
    b = np.arange(5000, dtype=np.int64) * 3
    d = stage.upload(b)
    assert np.array_equal(d.cpu().numpy(), b)
    got = stage.download(5000)
    stage.buffer(5000)[:10] = -1
    stage.upload(a)
    torch.cuda.synchronize()
    assert np.array_equal(got, b)
    h, h_np = stage.host(7)
    assert h.is_pinned() and h.numel() == 7 and h_np.size == 7


def _kept_rows_run(device):
    """Two fused ticks on one pool; the first tick's rows are kept across
    the second, which reads the same words after they were rewritten."""
    pool = T.DMPool(T.DMConfig(num_mns=4, replication=2,
                               region_words=1 << 12), device=device)
    rng = np.random.default_rng(9)
    for g in sorted(pool.placement):
        pool.write(g, 0, 0, [g * 1000 + i for i in range(64)])
    regions = [int(rng.choice(sorted(pool.placement))) for _ in range(24)]
    reads = (regions, [0] * 24, [int(o) for o in rng.integers(0, 48, 24)],
             [int(k) for k in rng.integers(1, 16, 24)])
    kept = pool.exec_fused_tick(reads)[0]
    first = [r.copy() for r in kept]
    for g in sorted(pool.placement):
        pool.write(g, 0, 0, [(1 << 63) + i for i in range(64)])
    second = pool.exec_fused_tick(
        reads, None, (regions, [0] * 24, [1] * 24, [0] * 24, [7] * 24),
        (regions, [0] * 24, [0] * 24, [1] * 24))
    assert all(np.array_equal(a, b) for a, b in zip(kept, first))
    return [r.tolist() for r in kept], [
        [None if x is None else np.asarray(x).tolist() for x in res]
        for res in second]


def test_fleet_tick_rows_outlive_the_next_tick_on_cuda():
    """A fleet tick's rows on the card are fresh host arrays: kept across
    the next tick (which reuses the pool's staging buffer and its pinned
    mirror) they do not change, and both ticks equal the CPU pool's."""
    require_cuda()
    before = fleet_read.launches
    gpu = _kept_rows_run("cuda")
    assert fleet_read.launches == before + 2
    assert gpu == _kept_rows_run("cpu")


def test_ycsbe_crash_run_on_cuda_matches_cpu():
    """The small YCSB-E run with a client crashed inside a leaf split: its
    locates launch leaf_probe on the card, its audit holds, and it equals
    the same run on the CPU."""
    require_cuda()
    before = leaf_probe.launches
    cl, fleet, crash, futs = ycsbe_crash_scenario(T, device="cuda")
    assert crash is not None and leaf_probe.launches > before
    gpu = signature(cl, fleet)
    ycsbe_crash_audit(T, cl, futs)          # its final scan adds ops
    c_cl, c_fleet, c_crash, _ = ycsbe_crash_scenario(T, device="cpu")
    assert c_crash == crash
    assert_same_run(signature(c_cl, c_fleet), gpu)


def _fleet_run(device, prep=None):
    n_clients, n_keys = 24, 64
    cl = T.FuseeCluster(T.DMConfig(num_mns=4, replication=2),
                        num_clients=n_clients, seed=3, device=device)
    if prep is not None:
        prep(cl)
    fleet = cl.fleet()
    for k in range(n_keys):
        cl.scheduler.submit(k % n_clients, "insert", k, [k, 1 << 63])
    fleet.run()
    backends = [cl.store(c, max_inflight=0).backend for c in range(n_clients)]
    wl = cl.rng.stream("workload")
    plans = [[] for _ in range(n_clients)]
    for i in range(n_clients * 8):
        key = int(wl.integers(n_keys))
        plans[i % n_clients].append(
            T.Op.update(key, [i, i]) if wl.random() < 0.5 else T.Op.get(key))
    cursor = [0] * n_clients
    while True:
        wave = []
        for c in range(n_clients):
            room = 4 - cl.scheduler.inflight(c)
            if room > 0 and cursor[c] < len(plans[c]):
                ops = plans[c][cursor[c]:cursor[c] + room]
                cursor[c] += len(ops)
                wave.append((backends[c], ops))
        if wave:
            fleet.submit_wave(wave)
        if not cl.scheduler.has_work():
            break
        fleet.tick()
    return cl, fleet


def test_fleet_run_on_cuda_matches_cpu():
    require_cuda()
    before = (race_lookup.launches, fleet_read.launches)
    gpu = signature(*_fleet_run("cuda"))
    assert race_lookup.launches > before[0]
    assert fleet_read.launches > before[1]
    assert_same_run(signature(*_fleet_run("cpu")), gpu)


def _probe_run(device):
    """16 clients GET 32 keys in six waves of four GETs each: most GETs of
    the later waves hit the clients' index caches through probe_wave."""
    n_clients, n_keys = 16, 32
    cl = T.FuseeCluster(T.DMConfig(num_mns=4, replication=2),
                        num_clients=n_clients, seed=5, device=device)
    fleet = cl.fleet()
    for k in range(n_keys):
        cl.scheduler.submit(k % n_clients, "insert", k, [k, 1 << 63])
    fleet.run()
    backends = [cl.store(c, max_inflight=0).backend for c in range(n_clients)]
    wl = cl.rng.stream("workload")
    for _ in range(6):
        fleet.submit_wave([(be, [T.Op.get(int(k)) for k in
                                 wl.integers(n_keys, size=4)])
                           for be in backends])
        fleet.run()
    return cl, fleet


def test_fleet_probe_hits_on_cuda_match_cpu():
    """probe_wave on the card: one race_lookup launch per wave, the same
    probe hits and the same run as on the CPU."""
    require_cuda()
    before = race_lookup.launches
    cl, fleet = _probe_run("cuda")
    st = fleet.stats()
    assert race_lookup.launches - before == st["probe_invocations"] == 6
    c_cl, c_fleet = _probe_run("cpu")
    c_st = c_fleet.stats()
    assert st["probe_hits"] == c_st["probe_hits"] > 0
    assert st["shadow_rebuilds"] == c_st["shadow_rebuilds"]
    assert_same_run(signature(c_cl, c_fleet), signature(cl, fleet))


def _add_mn_run(device):
    """Index shards migrate under fleet load (an MN joins at tick 6)."""
    n_clients, n_keys = 12, 64
    cl = T.FuseeCluster(T.DMConfig(num_mns=3, replication=2, index_shards=8,
                                   index_buckets=512),
                        num_clients=n_clients, seed=5, device=device)
    fleet = cl.fleet()
    for k in range(n_keys):
        cl.scheduler.submit(k % n_clients, "insert", k, [k])
    fleet.run()
    backends = [cl.store(c, max_inflight=0).backend for c in range(n_clients)]
    window_launches = tick = 0
    while tick < 40 or cl.scheduler.has_work() or cl.migrator.busy:
        if tick < 40:
            fleet.submit_wave([(be, [T.Op.get((tick + c) % n_keys),
                                     T.Op.update((tick * c) % n_keys,
                                                 [tick])])
                               for c, be in enumerate(backends)
                               if cl.scheduler.inflight(c) < 4])
        if tick == 6:
            cl.add_mn(wait=False)
        before = fleet_read.launches
        in_window = bool(cl.pool.migrations)
        fleet.tick()
        if in_window or cl.pool.migrations:
            window_launches += fleet_read.launches - before
        tick += 1
    fleet.run()
    return cl, fleet, window_launches


def test_add_mn_on_cuda_matches_cpu():
    """The dual-write windows' READs launch fleet_read on the card, and the
    migration run equals the same run on the CPU."""
    require_cuda()
    cl, fleet, window_launches = _add_mn_run("cuda")
    assert len(cl.pool.mns) == 4 and fleet.stats()["fallback_ticks"] > 0
    assert window_launches > 0
    c_cl, c_fleet, _ = _add_mn_run("cpu")
    assert_same_run(signature(c_cl, c_fleet), signature(cl, fleet))


def _fault_run(device, prep=None):
    cl = T.FuseeCluster(T.DMConfig(num_mns=5, replication=2), num_clients=6,
                        seed=1, device=device)
    if prep is not None:
        prep(cl)
    plan = T.FaultPlan()
    plan.crash_client(2, after_ops=25)
    plan.recover_client(2, reassign_to=3, after_ops=45)
    plan.crash_mn(1, after_ops=60)
    cl.inject(plan)
    stores = {c: cl.store(c) for c in range(6)}
    wl = cl.rng.stream("workload")
    steps = cl.rng.stream("steps")
    for rnd in range(12):
        for c in range(6):
            ops = [T.Op.put(int(wl.integers(40)), [rnd, c, j])
                   if wl.random() < 0.5 else T.Op.get(int(wl.integers(40)))
                   for j in range(4)]
            try:
                stores[c].submit_batch(ops)
            except T.ClientCrashed:
                pass
        for _ in range(40):
            cids = cl.scheduler.eligible_cids()
            if not cids:
                break
            cl.scheduler.step(cids[int(steps.integers(len(cids)))],
                              pick=int(steps.integers(4)))
    cl.drain()
    return cl


def test_fault_run_on_cuda_matches_cpu():
    """Client crash and recovery, MN crash with Alg-3 auto-recovery: the
    master's direct region access runs on the card."""
    require_cuda()
    gpu = _fault_run("cuda")
    h = gpu.health()
    assert h.mn_recoveries == 1 and h.client_recoveries == 1
    assert_same_run(signature(_fault_run("cpu")), signature(gpu))


# ----------------------------------------------------------- obs surface
_OBS_PREP = {"hub": None, "hotspot": lambda cl: cl.enable_hotspot(),
             "tracer": lambda cl: cl.attach_tracer()}


@pytest.mark.parametrize("mode", sorted(_OBS_PREP))
@pytest.mark.parametrize("scenario", ["fleet", "fault"])
def test_obs_surface_on_cuda_matches_cpu(scenario, mode):
    """The default hub, the hot-key monitor and a recording tracer on the
    card: deterministic metrics, flight ring, verb ring, span trees and
    profile equal to the same run's on the CPU."""
    require_cuda()
    run = _fleet_run if scenario == "fleet" else _fault_run
    prep = _OBS_PREP[mode]

    def sig(device):
        out = run(device, prep)
        return obs_signature(TO, out[0] if scenario == "fleet" else out)

    gpu = sig("cuda")
    assert_same_run(sig("cpu"), gpu)
    if mode == "hotspot":
        assert '"hotspot"' in gpu["metrics"]
    if mode == "tracer":
        assert gpu["trace.seq"]


def test_recording_tracer_turns_fusion_off_on_cuda():
    """While a tracer records, fleet ticks run the per-kind batch verbs
    it wraps (every READ sweep still one fleet_read launch); paused, the
    fused tick is back and nothing is recorded."""
    require_cuda()
    holder = {}

    def prep(cl):
        holder["tr"] = cl.attach_tracer()

    cl, fleet = _fleet_run("cuda", prep)
    tr = holder["tr"]
    st = fleet.stats()
    assert st["fallback_ticks"] > 0 and st["fused_ticks"] == 0 and tr.n > 0
    tr.pause()
    n, fallback = tr.n, st["fallback_ticks"]
    before = fleet_read.launches
    for k in range(8):
        cl.scheduler.submit(k, "search", k, None)
    fleet.run()
    st = fleet.stats()
    assert st["fused_ticks"] > 0 and st["fallback_ticks"] == fallback
    assert tr.n == n and fleet_read.launches > before


# ------------------------------------------------------- attention kernels
def _assert_attn_close(got, want, spread):
    """Within ``attn_bound`` (2e-5 in f32; one bf16 rounding of the output
    and of each attention weight in bf16) of the plain version."""
    err = (got.float() - want.float()).abs()
    bound = attn_bound(want, spread)
    assert bool((err <= bound).all()), \
        f"max err {err.max().item():.3g}, worst excess " \
        f"{(err - bound).max().item():.3g}, mean |ref| " \
        f"{want.float().abs().mean().item():.3g}"


def _randn(rng, shape, dt):
    return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                        device="cuda").to(dt)


@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,causal", [
    (2, 4, 2, 256, 256, 16, True),
    (1, 8, 8, 512, 512, 128, True),
    (2, 6, 2, 256, 512, 16, False),
    (3, 3, 3, 128, 256, 128, False),
    (1, 4, 1, 1, 1, 128, True),
    (2, 4, 4, 63, 63, 16, True),
    (1, 8, 2, 65, 65, 16, True),
    (1, 8, 2, 300, 300, 128, True),
    (1, 4, 1, 100, 37, 128, False),
    (1, 4, 1, 70, 30, 16, True),        # rows with no visible key
    # the wgmma kernel's 128-row q and k/v tiles: ragged by one either way
    (1, 4, 4, 127, 127, 128, True),     # G = 1
    (1, 8, 2, 128, 128, 16, True),      # G = 4
    (1, 8, 1, 129, 129, 128, True),     # G = 8
    (1, 8, 1, 255, 255, 16, True),
    (1, 4, 1, 257, 257, 128, True),
    (1, 32, 8, 1152, 1152, 128, True),  # the serve shape's heads, B = 1
    (2, 8, 8, 1152, 1152, 16, True),
    (1, 8, 1, 129, 300, 128, True),     # Sq < Skv
    (1, 4, 2, 300, 129, 128, True),     # Sq > Skv: rows with no visible key
    (1, 8, 1, 200, 70, 128, True),
    # head dim 64 (smollm-360m: 15 heads over 5 kv heads, G = 3)
    (1, 15, 5, 300, 300, 64, True),
    (2, 15, 5, 1152, 1152, 64, True),
    (2, 6, 2, 129, 129, 64, False),
    (1, 8, 1, 65, 300, 64, True),
    (1, 4, 2, 300, 129, 64, True),
    (1, 24, 2, 257, 257, 64, True),     # G = 12
    # arctic-480b: 56 heads over 8 kv heads (G = 7)
    (1, 56, 8, 1152, 1152, 128, True),
    (2, 14, 2, 300, 300, 128, True),
    # whisper-medium (hd 64, G = 1): the encoder, and cross-attention at
    # Sq 1 (decode) and 128 (prefill) over its 1500 frames
    (1, 16, 16, 1500, 1500, 64, False),
    (4, 16, 16, 1, 1500, 64, False),
    (4, 16, 16, 128, 1500, 64, False),
])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(B, H, KV, Sq, Skv, hd, causal,
                                              dt):
    require_cuda()
    rng = np.random.default_rng(Sq * 7 + Skv)
    q = _randn(rng, (B, H, Sq, hd), dt)
    k = _randn(rng, (B, KV, Skv, hd), dt)
    v = _randn(rng, (B, KV, Skv, hd), dt)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    _assert_attn_close(got, want,
                       flash_attention_plain(q, k, v.abs(), causal=causal))


@pytest.mark.parametrize("Sq,Skv,causal", [
    (65, 65, True), (300, 300, True), (1152, 1152, True), (65, 300, False),
    (127, 127, True), (129, 129, True), (257, 257, True), (129, 300, True),
    (300, 129, True),
])
def test_flash_attention_bf16_kernel_masks_to_the_key(Sq, Skv, causal):
    """With attention weights exact in bf16, the bf16 kernel equals the
    plain version to one rounding: one key too many or too few in a row
    would show."""
    require_cuda()
    rng = np.random.default_rng(Sq + Skv)
    q, v = uniform_attn_inputs(
        _randn(rng, (1, 4, Sq, 128), torch.bfloat16),
        _randn(rng, (1, 1, Skv, 128), torch.bfloat16))
    k = _randn(rng, (1, 1, Skv, 128), torch.bfloat16)
    got = flash_attention(q, k, v, causal=causal).float()
    want = flash_attention_plain(q, k, v, causal=causal).float()
    assert bool(((got - want).abs() <= 1e-4 + 2 ** -7 * want.abs()).all())


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_flash_attention_bf16_kernel_reads_strided_views(hd):
    """The bf16 kernel maps q, k, v with their own strides: the model's
    (B, S, heads, hd) tensors seen through transpose(1, 2), and a k/v
    sliced out of a wider cache, give the plain version's output, in q's
    layout."""
    require_cuda()
    rng = np.random.default_rng(hd)
    q = _randn(rng, (2, 300, 8, hd), torch.bfloat16).transpose(1, 2)
    k = _randn(rng, (2, 300, 2, hd), torch.bfloat16).transpose(1, 2)
    v = _randn(rng, (2, 2, 400, hd), torch.bfloat16)[:, :, 50:350]
    got = flash_attention(q, k, v, causal=True)
    assert got.stride() == q.stride()
    want = flash_attention_plain(q, k, v, causal=True)
    _assert_attn_close(got, want,
                       flash_attention_plain(q, k, v.abs(), causal=True))


def test_flash_attention_kernel_raises_on_unsupported_head_dim():
    require_cuda()
    q = torch.zeros(1, 2, 8, 96, device="cuda")
    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :1], q[:, :1])
    assert flash_attention.launches == before


@pytest.mark.parametrize("nb,tb,B,KV,H,hd,vl", [
    (4, 128, 2, 2, 4, 16, 300),
    (8, 256, 1, 8, 8, 128, 2000),
    (2, 128, 3, 1, 2, 16, 17),
    (16, 128, 1, 4, 8, 128, 2048),
    (2, 1024, 4, 8, 32, 128, 1),
    (2, 1024, 4, 8, 32, 128, 1023),
    (2, 1024, 4, 8, 32, 128, 1025),
    (2, 64, 2, 1, 4, 16, 128),
    (2, 64, 2, 1, 4, 16, 500),          # valid_len past the pages: clamped
    # split edges (SPLIT_CHUNK = 64 positions a split)
    (2, 1024, 4, 8, 32, 128, 63),
    (2, 1024, 4, 8, 32, 128, 64),
    (2, 1024, 4, 8, 32, 128, 65),
    (2, 1024, 4, 8, 32, 128, 1167),     # the serve run's longest step
    (64, 256, 1, 8, 64, 128, 16384),    # 256 splits, G = 8: several waves
    # head dim 64 and G = 3 (smollm-360m's decode shape)
    (2, 1024, 4, 5, 15, 64, 1167),
    (2, 64, 2, 5, 15, 64, 65),
    (4, 128, 1, 2, 4, 64, 300),
    # the G <= 16 instance: G = 12 (mistral-large-123b), 9, 16
    (2, 1024, 4, 8, 96, 128, 1167),
    (2, 1024, 1, 8, 96, 128, 1),
    (2, 128, 2, 1, 9, 128, 200),
    (2, 256, 2, 1, 16, 128, 300),
    (4, 128, 1, 2, 32, 64, 257),
    (2, 64, 2, 1, 12, 16, 100),
    # G = 7 (arctic-480b) and hd 64 at G = 1 (whisper-medium's decoder)
    (2, 1024, 4, 8, 56, 128, 1156),
    (2, 128, 2, 1, 7, 64, 200),
    (1, 1024, 4, 16, 16, 64, 132),
    (4, 128, 2, 4, 4, 64, 300),
])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(nb, tb, B, KV, H, hd, vl, dt):
    require_cuda()
    rng = np.random.default_rng(nb * 31 + B + vl)
    q = _randn(rng, (B, H, hd), dt)
    kc = _randn(rng, (nb, tb, B, KV, hd), dt)
    vc = _randn(rng, (nb, tb, B, KV, hd), dt)
    before = paged_attention.launches
    got = paged_attention(q, kc, vc, vl)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_plain(q, kc, vc, vl)
    _assert_attn_close(got, want, paged_attention_plain(q, kc, vc.abs(), vl))
    if vl < nb * tb:                    # garbage past valid_len is unread
        kc[vl // tb + 1:] = 999.0
        vc.view(nb * tb, B, KV, hd)[vl:] = float("nan")
        torch.testing.assert_close(paged_attention(q, kc, vc, vl), got)


def test_paged_attention_kernel_raises_outside_its_instances():
    """A head dim or a group size the kernel does not build raises; it
    never turns to the plain version."""
    require_cuda()
    kc = torch.zeros(1, 64, 1, 1, 96, device="cuda")
    before = paged_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(torch.zeros(1, 2, 96, device="cuda"), kc, kc, 8)
    kc = torch.zeros(1, 64, 1, 1, 128, device="cuda")
    with pytest.raises(ValueError, match="at most 16"):
        paged_attention(torch.zeros(1, 17, 128, device="cuda"), kc, kc, 8)
    assert paged_attention.launches == before


@pytest.mark.parametrize("chunk", [8, 200])
@pytest.mark.parametrize("vl", [1, 199, 1167])
def test_paged_attention_kernel_at_other_split_chunks(monkeypatch, chunk, vl):
    """Splits of one tile and splits whose warps wrap their rings: the
    kernel takes any chunk the plan gives it."""
    require_cuda()
    from repro_torch.kernels.paged_attention import ops
    monkeypatch.setattr(ops, "SPLIT_CHUNK", chunk)
    rng = np.random.default_rng(chunk + vl)
    q = _randn(rng, (4, 32, 128), torch.bfloat16)
    kc = _randn(rng, (2, 1024, 4, 8, 128), torch.bfloat16)
    vc = _randn(rng, (2, 1024, 4, 8, 128), torch.bfloat16)
    got = paged_attention(q, kc, vc, vl)
    _assert_attn_close(got, paged_attention_plain(q, kc, vc, vl),
                       paged_attention_plain(q, kc, vc.abs(), vl))


def test_serve_run_on_cuda_matches_cpu():
    """The reduced f32 engine scenario on the card launches both attention
    kernels and equals the same run on the CPU with the same weights."""
    require_cuda()
    from torch.utils._pytree import tree_map
    from repro_torch.configs.base import get, reduced
    from repro_torch.models import build
    cfg = reduced(get("llama3-8b"))
    model = build(cfg, device="cuda")
    params = model.init(seed=0)
    before = (flash_attention.launches, paged_attention.launches,
              race_lookup.launches, leaf_probe.launches)
    gpu = port_serve_run(model, params)
    assert flash_attention.launches > before[0]
    assert paged_attention.launches > before[1]
    assert race_lookup.launches > before[2]
    assert leaf_probe.launches > before[3]           # list_prefixes
    assert gpu["converged"]
    assert sum(hits for _r, _o, hits in gpu["requests"]) >= 2
    cpu_params = tree_map(lambda t: t.cpu(), params)
    assert port_serve_run(build(cfg, device="cpu"), cpu_params) == gpu


def test_train_step_on_cuda_matches_cpu():
    """One reduced smollm-360m train step (f32, AdamW) on the card from the
    CPU's parameters, with 1 and with 4 microbatches: the loss and the new
    parameters within the CPU parity bounds of tests/test_torch_train.py."""
    require_cuda()
    from torch.utils._pytree import tree_map
    from repro_torch.configs.base import get, reduced
    from repro_torch.models import build
    from repro_torch.optim import OptConfig, Optimizer, tree_leaves
    from repro_torch.train import make_train_step
    cfg = reduced(get("smollm-360m"))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)))
    out = {}
    for dev in ("cpu", "cuda"):
        for n_micro in (1, 4):
            model = build(cfg, device=dev)
            params = tree_map(lambda t: t.to(dev),
                              build(cfg, device="cpu").init(seed=0))
            opt = Optimizer(OptConfig(lr=1e-3))
            batch = {"tokens": toks.to(dev), "labels": toks.to(dev)}
            state, metrics = make_train_step(model, opt, n_micro=n_micro)(
                {"params": params, "opt": opt.init(params)}, batch)
            out[dev, n_micro] = (float(metrics["loss"]), [
                t.cpu() for t in tree_leaves(state["params"])])
    for n_micro in (1, 4):
        (lg, pg), (lc, pc) = out["cuda", n_micro], out["cpu", n_micro]
        assert abs(lg - lc) <= 2e-5 * abs(lc)
        for a, b in zip(pg, pc):
            assert float((a - b).abs().max()) <= \
                1e-4 * float(b.abs().max()) + 1e-6


def test_slstm_function_on_cuda_matches_autograd():
    """``SLSTMScan``'s deferred-reduction backward on the card against
    plain autograd through the loop (f32, one sLSTM layer, B 2 x S 64):
    every parameter's and the input's gradient within 1e-4 x max|ref| +
    1e-6 (the bound of tests/test_torch_train.py)."""
    require_cuda()
    from repro_torch.models import xlstm as X
    from repro_torch.models.common import ParamInit
    gen = torch.Generator(device="cuda").manual_seed(0)
    pi = ParamInit(gen, torch.float32, torch.device("cuda"))
    p0 = {k: v[0] for k, v in X.make_slstm_params(pi, 1, 256, 4).items()}
    x0 = torch.randn(2, 64, 256, generator=gen, device="cuda")

    def grads(plain):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        x = x0.clone().requires_grad_(True)
        if plain:
            st = X.init_slstm_state(2, 256, x.device)
            xin = x @ p["w_in"]
            hs = []
            for t in range(x.shape[1]):
                st = X._slstm_cell(p, xin[:, t], st)
                hs.append(st.h)
            y = X._slstm_ffn(p, torch.stack(hs, 1), x)
        else:
            y = X.slstm_seq(p, x)[0]
        y.square().sum().backward()
        return {**{k: v.grad for k, v in p.items()}, "x": x.grad}

    got, want = grads(False), grads(True)
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= \
            1e-4 * float(want[k].abs().max()) + 1e-6, k


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_slstm_graphed_scan_matches_the_eager_scan(dt):
    """Serving's sLSTM scan on the card (CUDA graphs of ``GRAPH_STEPS``
    steps and an eager tail) against ``SLSTMScan``'s eager loop, over two
    whole graphs and a tail, then again from the carried state (the graph
    reused with another layer's weights): outputs and states within 2e-5 +
    2e-5 x |ref| in f32 (summation order) and one bf16 rounding of the
    output in bf16."""
    require_cuda()
    from repro_torch.models import xlstm as X
    from repro_torch.models.common import ParamInit
    gen = torch.Generator(device="cuda").manual_seed(1)
    pi = ParamInit(gen, dt, torch.device("cuda"))
    layers = X.make_slstm_params(pi, 2, 256, 4)
    x = torch.randn(3, 2 * X.GRAPH_STEPS + 5, 256, generator=gen,
                    device="cuda").to(dt)
    tol = 2e-5 if dt == torch.float32 else 2 ** -7
    st_g = st_e = None
    for i in range(2):
        p = {k: v[i] for k, v in layers.items()}
        xin = (x @ p["w_in"]).transpose(0, 1)
        st0 = st_g or X.init_slstm_state(3, 256, x.device)
        hs_g, st_g = X._scan_graphed(p["w_rec"], p["b"], xin, st0)
        hs_e, *st_e = X.SLSTMScan.apply(p["w_rec"], p["b"], xin,
                                        *(st_e or st0))
        torch.testing.assert_close(hs_g, hs_e, rtol=tol, atol=tol)
        for a, b in zip(st_g, st_e):
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)
        st_e = X.SLSTMState(*st_e)


def test_device_spec_reads_the_card():
    """``launch.device.device_spec()`` on the card: the table's H100 SXM5
    entry with the card's own memory size and nvidia-smi's power limit."""
    require_cuda()
    from repro_torch.launch.device import device_spec
    s = device_spec()
    props = torch.cuda.get_device_properties(0)
    assert s.name == "H100-SXM5-80GB" and s.card == props.name
    assert s.hbm_bytes == props.total_memory and s.power_limit.endswith("W")
    assert (s.peak_bf16_flops, s.hbm_bw) == (989e12, 3.35e12)


def test_measure_a_reduced_prefill_within_its_bound():
    """``launch.roofline.measure`` of a reduced llama3-8b prefill on the
    card, against its count on meta at the same shapes: the step takes
    longer than its bound (0 < share_of_bound <= 1.05) and its MFU is
    positive."""
    require_cuda()
    from repro_torch.configs import base as C
    from repro_torch.launch.device import device_spec
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.roofline import measure
    from repro_torch.models import build
    cfg = C.reduced(C.get("llama3-8b"))
    model = build(cfg, device="cuda")
    params = model.init(0)
    toks = torch.randint(0, cfg.vocab, (2, 64), device="cuda")
    spec = device_spec()
    res = count_step(cfg, "prefill", 2, 64, spec=spec)
    m = measure(lambda: model.prefill(params, toks), costs=res["costs"],
                model_flops=res["model_flops"], spec=spec)
    assert 0 < m["share_of_bound"] <= 1.05
    assert m["mfu"] > 0 and m["t_step"] > 0 and len(m["t_steps"]) == 3
