"""The port's fleet engine against the JAX package, on the CPU.

Same-seed fleet runs (``FleetEngine`` ticks, ``submit_wave`` with the
cluster-wide ``probe_wave`` GET probe, fused ticks through
``exec_fused_tick``) must be bit-identical across the packages: pool bytes,
``health()``, the op history, the fleet counters and per-MN bytes — the
signature of ``tests/test_fleet_fused.py`` minus the metrics registry.
Covered: YCSB-A and YCSB-C at that file's size (24 clients, 64 keys), a
fault storm with client and MN crashes, the churn storm with an MN joining
and leaving mid-run, and ``add_mn`` fired under load.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from benchmarks.common import YCSB, fleet_dmconfig

from _torch_parity import assert_same_run, port_config, signature


def _cfg(M, ref_cfg):
    return ref_cfg if M is R else port_config(ref_cfg)


def _watch_read_batches(monkeypatch) -> list:
    """Per port ``DMPool.read_batch`` call with a live verb, the number of
    ``fleet_read`` calls it made (the migration windows' READ path)."""
    from repro_torch.core import heap
    n_fr = [0]
    per_batch: list = []
    orig_fr, orig_rb = heap.fleet_read, heap.DMPool.read_batch

    def fleet_read(*a):
        n_fr[0] += 1
        return orig_fr(*a)

    def read_batch(self, *a):
        before = n_fr[0]
        out = orig_rb(self, *a)
        if any(r is not None for r in out):
            per_batch.append(n_fr[0] - before)
        return out

    monkeypatch.setattr(heap, "fleet_read", fleet_read)
    monkeypatch.setattr(heap.DMPool, "read_batch", read_batch)
    return per_batch


def _drive(M, cl, fleet, plans):
    sched = cl.scheduler
    backends = [cl.store(c, max_inflight=0).backend
                for c in range(len(plans))]
    cursor = [0] * len(plans)
    while True:
        wave = []
        for c, plan in enumerate(plans):
            room = 4 - sched.inflight(c)
            if room > 0 and cursor[c] < len(plan):
                ops = plan[cursor[c]:cursor[c] + room]
                cursor[c] += len(ops)
                wave.append((backends[c], ops))
        if wave:
            fleet.submit_wave(wave)
        if not sched.has_work():
            break
        fleet.tick()


def _ycsb(M, mix_name, seed, *, n_clients=24, n_keys=64, ops_per_client=6,
          **kw):
    mix = YCSB[mix_name]
    cl = M.FuseeCluster(_cfg(M, fleet_dmconfig(n_clients, n_keys)),
                        num_clients=n_clients, seed=seed, **kw)
    fleet = cl.fleet()
    for k in range(n_keys):
        cl.scheduler.submit(k % n_clients, "insert", k, [k])
    fleet.run()
    wl = cl.rng.stream("workload")
    kinds = sorted(mix)
    probs = np.array([mix[k] for k in kinds], float)
    probs /= probs.sum()
    plans = [[] for _ in range(n_clients)]
    for i in range(n_clients * ops_per_client):
        kind = kinds[int(wl.choice(len(kinds), p=probs))]
        key = int(wl.integers(n_keys))
        val = [i, (1 << 64) - 1 - i] if kind in ("insert", "update") else None
        plans[i % n_clients].append(M.Op(kind, key, val))
    _drive(M, cl, fleet, plans)
    return cl, fleet


@pytest.mark.parametrize("mix_name,seed", [("A", 0), ("A", 7), ("C", 0),
                                           ("C", 3)])
def test_ycsb_matches_reference(mix_name, seed):
    ref = signature(*_ycsb(R, mix_name, seed))
    cl, fleet = _ycsb(T, mix_name, seed, device="cpu")
    assert_same_run(ref, signature(cl, fleet))
    st = fleet.stats()
    assert st["probe_invocations"] > 0 and st["fused_ticks"] > 0
    if mix_name == "C":
        assert st["probe_hits"] > 0


def _storm(M, seed, *, churn, **kw):
    if churn:       # test_fleet_fused.py's churn storm: an MN joins, leaves
        n_clients, n_mns, repl = 6, 5, 3
        cfg = R.DMConfig(num_mns=n_mns, replication=repl,
                         region_words=1 << 15, regions_per_mn=16,
                         index_shards=4)
    else:
        n_clients, n_mns, repl = 24, 5, 2
        cfg = fleet_dmconfig(n_clients, 64, n_mns=n_mns, replication=repl)
    cl = M.FuseeCluster(_cfg(M, cfg), num_clients=n_clients, seed=seed, **kw)
    plan = M.FaultPlan.storm(cl.rng.stream("faults"),
                             clients=range(n_clients), mns=n_mns,
                             replication=repl, n_client_crashes=2,
                             n_mn_crashes=1, n_add_mns=int(churn),
                             remove_added=churn, first_op=10, spacing=14,
                             recover_delay=8)
    cl.inject(plan)
    fleet = cl.fleet()
    stores = {c: cl.store(c, max_inflight=0) for c in range(n_clients)}
    submitted = 0
    while submitted < 120:
        for c in range(n_clients):
            if submitted >= 120:
                break
            k = submitted % 64 if not churn else submitted
            submitted += 1
            try:
                stores[c].submit(M.Op.put(k, [k, c]))
            except M.ClientCrashed:
                pass
        for _ in range(4):
            if cl.scheduler.has_work():
                fleet.tick()
    fleet.run()
    if cl.migrator.busy:
        cl.migrator.drive()
        fleet.run()
    return cl, fleet


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("seed", [0, 8, 15])
def test_fault_storm_matches_reference(seed, churn, monkeypatch):
    """Client crashes with log-replay recovery and an MN crash with Alg-3
    recovery (whose index re-placement runs through the migration engine);
    ``churn`` adds an MN join and leave with live shard migrations."""
    ref = signature(*_storm(R, seed, churn=churn))
    read_batches = _watch_read_batches(monkeypatch)
    cl, fleet = _storm(T, seed, churn=churn, device="cpu")
    assert_same_run(ref, signature(cl, fleet))
    h = cl.health()
    assert h.mn_recoveries == 1 and h.client_recoveries == 2
    assert set(read_batches) <= {1}      # each read batch: one fleet_read
    if churn:
        assert fleet.stats()["fallback_ticks"] > 0   # dual-write windows
        assert read_batches


@pytest.mark.parametrize("seed", [0, 11])
def test_add_mn_under_load_matches_reference(seed, monkeypatch):
    def run(M, **kw):
        n_clients, n_keys = 16, 96
        cfg = dataclasses.replace(
            fleet_dmconfig(n_clients, n_keys, n_mns=3, replication=2),
            index_shards=8)
        cl = M.FuseeCluster(_cfg(M, cfg), num_clients=n_clients, seed=seed,
                            **kw)
        fleet = cl.fleet()
        sched = cl.scheduler
        backends = [cl.store(c, max_inflight=0).backend
                    for c in range(n_clients)]
        for k in range(n_keys):
            sched.submit(k % n_clients, "insert", k, [k])
        fleet.run()
        wl = cl.rng.stream("workload")
        plans = [[] for _ in range(n_clients)]
        for i in range(n_clients * 10):
            kind = "update" if wl.random() < 0.5 else "search"
            plans[i % n_clients].append(M.Op(
                kind, int(wl.integers(n_keys)),
                [i] if kind == "update" else None))
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
        return cl, fleet

    ref = signature(*run(R))
    read_batches = _watch_read_batches(monkeypatch)
    cl, fleet = run(T, device="cpu")
    assert_same_run(ref, signature(cl, fleet))
    assert len(cl.pool.mns) == 4
    assert fleet.stats()["fallback_ticks"] > 0
    # the dual-write windows' READs and the bulk copy: one fleet_read each
    assert read_batches and set(read_batches) == {1}


def test_fleet_engine_rejects_scans():
    cl = T.FuseeCluster(T.DMConfig(), num_clients=2, device="cpu")
    be = cl.store(0, max_inflight=0).backend
    with pytest.raises(NotImplementedError, match="A6"):
        cl.fleet().submit_wave([(be, [T.Op("scan", 1, 3)])])
