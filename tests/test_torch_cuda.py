"""The port on the card: each CUDA kernel against its plain torch version,
and a seeded fleet run and fault run on ``cuda`` against the same runs on
``cpu``.  Every test is marked ``cuda`` and skips without a GPU.

This file imports neither ``jax`` nor the JAX package, so it also runs on
a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.shadow import build_shadow
from repro_torch.kernels import (fleet_read, fleet_read_plain, race_lookup,
                                 race_lookup_plain)

from _torch_parity import assert_same_run, require_cuda, signature

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
