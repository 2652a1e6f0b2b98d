"""The port's fleet engine against the JAX package, on the CPU.

Same-seed fleet runs (``FleetEngine`` ticks, ``submit_wave`` with the
cluster-wide ``probe_wave`` GET probe, fused ticks through
``exec_fused_tick``) must be bit-identical across the packages: pool bytes,
``health()``, the op history, the fleet counters and per-MN bytes — the
signature of ``tests/test_fleet_fused.py`` minus the metrics registry.
Covered: YCSB-A, YCSB-C and YCSB-E (95% SCAN over the ordered keydir, 5%
INSERT of fresh keys) at that file's size (24 clients, 64 keys), a fault
storm with client and MN crashes, the churn storm with an MN joining and
leaving mid-run, and ``add_mn`` fired under load.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from benchmarks.common import YCSB, fleet_dmconfig

from _torch_parity import assert_same_run, port_config, ref_c1_fixed, signature

# the reference client carries ROADMAP C1's fix, as the port does
pytestmark = pytest.mark.usefixtures("ref_c1_fixed")



def _cfg(M, ref_cfg):
    return ref_cfg if M is R else port_config(ref_cfg)


def _watch_read_batches(monkeypatch) -> list:
    """Per port ``DMPool.read_batch`` call with a live verb, the number of
    ``fleet_read`` calls it made through the pool's entry,
    ``fleet_read_tick`` (the migration windows' READ path)."""
    from repro_torch.core import heap
    n_fr = [0]
    per_batch: list = []
    orig_fr, orig_rb = heap.fleet_read_tick, heap.DMPool.read_batch

    def fleet_read(*a):
        n_fr[0] += 1
        return orig_fr(*a)

    def read_batch(self, *a):
        before = n_fr[0]
        out = orig_rb(self, *a)
        if any(r is not None for r in out):
            per_batch.append(n_fr[0] - before)
        return out

    monkeypatch.setattr(heap, "fleet_read_tick", fleet_read)
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
    cfg = fleet_dmconfig(n_clients, n_keys, ordered="scan" in mix)
    cl = M.FuseeCluster(_cfg(M, cfg), num_clients=n_clients, seed=seed,
                        **kw)
    fleet = cl.fleet()
    for k in range(n_keys):
        cl.scheduler.submit(k % n_clients, "insert", k, [k])
    fleet.run()
    wl = cl.rng.stream("workload")
    kinds = sorted(mix)
    probs = np.array([mix[k] for k in kinds], float)
    probs /= probs.sum()
    plans = [[] for _ in range(n_clients)]
    fresh = n_keys
    for i in range(n_clients * ops_per_client):
        kind = kinds[int(wl.choice(len(kinds), p=probs))]
        key = int(wl.integers(n_keys))
        val = [i, (1 << 64) - 1 - i] if kind in ("insert", "update") else None
        if kind == "scan":              # YCSB-E: length uniform in 1..100
            val = 1 + int(wl.integers(100))
        elif kind == "insert":          # ... beside inserts of fresh keys
            key, fresh = fresh, fresh + 1
        plans[i % n_clients].append(M.Op(kind, key, val))
    _drive(M, cl, fleet, plans)
    return cl, fleet


@pytest.mark.parametrize("mix_name,seed", [("A", 0), ("A", 7), ("C", 0),
                                           ("C", 3), ("E", 0), ("E", 3)])
def test_ycsb_matches_reference(mix_name, seed):
    ref = signature(*_ycsb(R, mix_name, seed))
    cl, fleet = _ycsb(T, mix_name, seed, device="cpu")
    assert_same_run(ref, signature(cl, fleet))
    st = fleet.stats()
    assert st["fused_ticks"] > 0
    if mix_name == "E":
        assert st["scan_locate_invocations"] > 0
        assert st["ord_leaf_verbs"] > 0
        scans = [r for r in cl.scheduler.history if r.kind == "scan"]
        assert scans and all(r.result.status == "OK" for r in scans)
    else:
        assert st["probe_invocations"] > 0
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
    """A scan wave on a cluster without the ordered keydir is rejected
    with the typed error before anything is submitted; with the keydir,
    a wave of scans and ranges from every client gives the reference's
    results, fleet counters and run signature."""
    cl = T.FuseeCluster(T.DMConfig(), num_clients=2, device="cpu")
    be = cl.store(0, max_inflight=0).backend
    with pytest.raises(T.OrderedIndexDisabled):
        cl.fleet().submit_wave([(be, [T.Op("scan", 1, 3)])])
    assert cl.scheduler.inflight(0) == 0

    def run(M, **kw):
        n_clients = 6
        cfg = fleet_dmconfig(n_clients, 80, ordered=True)
        cl = M.FuseeCluster(_cfg(M, cfg), num_clients=n_clients, seed=5,
                            **kw)
        fleet = cl.fleet()
        for k in range(80):
            cl.scheduler.submit(k % n_clients, "insert", k, [k, 1 << 63])
        fleet.run()
        bes = [cl.store(c, max_inflight=0).backend for c in range(n_clients)]
        futs = fleet.submit_wave(
            [(bes[c], [M.Op.scan(c * 11, 9), M.Op.range(c * 5, c * 5 + 4)])
             for c in range(n_clients)])
        fleet.run()
        return [[f.result().value for f in fs] for fs in futs], cl, fleet

    want, *ref = run(R)
    got, cl, fleet = run(T, device="cpu")
    assert got == want
    assert got[2][0] == [(k, [k, 1 << 63]) for k in range(22, 31)]
    assert_same_run(signature(*ref), signature(cl, fleet))
    assert fleet.stats()["scan_locate_invocations"] == 1


# ------------------------------------------------ elastic scale-in (A7.1)
def _elastic(M, seed, n_keys, **cfg_kw):
    """tests/test_elastic.py's cluster: 2 clients, ``n_keys`` keys put
    through client 0's store."""
    base = dict(num_mns=2, replication=2, region_words=1 << 15,
                regions_per_mn=8)
    base.update(cfg_kw)
    kw = {"device": "cpu"} if M is T else {}
    cl = M.FuseeCluster(M.DMConfig(**base), num_clients=2, seed=seed, **kw)
    kv = cl.store(0)
    for k in range(n_keys):
        assert kv.put(k, [k * 2]).status == "OK"
    return cl


def _read_back(cl, n_keys):
    return [cl.store(1).get(k) for k in range(n_keys)]


def test_remove_mn_drains_and_retires():
    def run(M):
        cl = _elastic(M, 2, 64, num_mns=4, index_shards=4)
        cl.remove_mn(1)
        mn = cl.pool.mns[1]
        assert mn.retired and not mn.regions
        assert 1 not in cl.pool.directory.members
        assert all(1 not in reps for reps in cl.pool.placement.values())
        h = cl.health()
        assert h.retired_mns == 1 and h.migrating_regions == 0
        return _read_back(cl, 64), signature(cl)

    (want, ref), (got, port) = run(R), run(T)
    assert got == want == [[k * 2] for k in range(64)]
    assert_same_run(ref, port)


def test_remove_mn_while_migrations_headed_for_it():
    """remove_mn of a node that in-flight migrations (from a just-issued
    add_mn) still target aborts and re-plans them, on both packages."""
    def run(M):
        cl = _elastic(M, 4, 48, num_mns=3, index_shards=8)
        mid = cl.add_mn(wait=False)
        assert cl.migrator.active
        cl.remove_mn(mid, wait=False)
        cl.migrator.drive(max_ticks=200_000)
        assert cl.pool.mns[mid].retired
        assert all(mid not in reps for reps in cl.pool.placement.values())
        return _read_back(cl, 48), signature(cl)

    (want, ref), (got, port) = run(R), run(T)
    assert got == want == [[k * 2] for k in range(48)]
    assert_same_run(ref, port)


def test_remove_mn_below_replication_raises_typed():
    from repro_torch.core.faults import InsufficientReplicas

    def run(M, exc):
        cl = _elastic(M, 0, 8)
        with pytest.raises(exc):
            cl.remove_mn(0)
        assert cl.pool.directory.members == [0, 1]
        assert not cl.pool.mns[0].retired
        return _read_back(cl, 8), signature(cl)

    (want, ref), (got, port) = (run(R, R.InsufficientReplicas),
                                run(T, InsufficientReplicas))
    assert got == want
    assert_same_run(ref, port)


def test_add_mn_then_rebalance_matches_reference():
    """Scale out by one MN, then re-place the index shards on the new ring:
    the migrations started, the values read back and the run's signature
    equal the reference's."""
    def run(M):
        cl = _elastic(M, 6, 64, num_mns=3, index_shards=8)
        mid = cl.add_mn()
        assert not cl.migrator.busy
        n = cl.rebalance()
        assert not cl.migrator.busy
        assert len(cl.pool.mns) == 4 and mid in cl.pool.directory.members
        return n, _read_back(cl, 64), signature(cl)

    (n_ref, want, ref), (n, got, port) = run(R), run(T)
    assert n == n_ref and got == want == [[k * 2] for k in range(64)]
    assert_same_run(ref, port)
