"""The port on the card: each CUDA kernel against its plain torch version,
and a seeded fleet run, fault run, YCSB-E run (with a client crashed inside
a leaf split) and serving run on ``cuda`` against the same runs on ``cpu``.  Every test is marked ``cuda`` and skips without a
GPU.

This file imports neither ``jax`` nor the JAX package, so it also runs on
a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.shadow import build_shadow
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 fleet_read, fleet_read_plain, leaf_probe,
                                 leaf_probe_plain, paged_attention,
                                 paged_attention_plain, race_lookup,
                                 race_lookup_plain)

from _torch_parity import (assert_same_run, attn_bound, port_serve_run,
                           require_cuda, signature, uniform_attn_inputs,
                           ycsbe_crash_audit, ycsbe_crash_scenario)

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


def _fleet_run(device):
    n_clients, n_keys = 24, 64
    cl = T.FuseeCluster(T.DMConfig(num_mns=4, replication=2),
                        num_clients=n_clients, seed=3, device=device)
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


def _fault_run(device):
    cl = T.FuseeCluster(T.DMConfig(num_mns=5, replication=2), num_clients=6,
                        seed=1, device=device)
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


def test_flash_attention_kernel_raises_on_unsupported_head_dim():
    require_cuda()
    q = torch.zeros(1, 2, 8, 64, device="cuda")
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
