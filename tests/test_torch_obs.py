"""The port's observability hub (``repro_torch.obs``: registry, flight
recorder, exporters) against the JAX package, on the CPU.

The cases of ``tests/test_obs.py``, each run on both packages with the same
seeded inputs: registry units give equal results, and on a step-mode run,
a fleet YCSB-A run and a seeded fault storm (MN crash, client crash and
recovery, one flight dump per fault class)
``json.dumps(deterministic_view(metrics()))`` and the flight ring are
byte-identical to the reference's.  Dumps, metrics files and Perfetto
traces written by one package load in the other.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import repro.core as R
import repro.obs as RO
import repro_torch.core as T
import repro_torch.obs as TO
from benchmarks.common import YCSB, fleet_dmconfig

from _torch_parity import (assert_same_run, obs_signature, port_config,
                          ref_c1_fixed)

# the reference client carries ROADMAP C1's fix, as the port does
pytestmark = pytest.mark.usefixtures("ref_c1_fixed")


PKGS = ((R, RO), (T, TO))


def _cluster(M, cfg, **kw):
    if M is T:
        return T.FuseeCluster(port_config(cfg), device="cpu", **kw)
    return R.FuseeCluster(cfg, **kw)


def _both(run):
    """``run(M, O)`` on the reference and on the port; the port's obs
    surface must equal the reference's.  Returns the port's cluster and
    result."""
    (ref_cl, ref_out), (cl, out) = (run(M, O) for M, O in PKGS)
    assert_same_run(obs_signature(RO, ref_cl), obs_signature(TO, cl))
    return cl, out


# ------------------------------------------------------------ registry units
def test_histogram_log2_buckets():
    got = []
    for O in (RO, TO):
        h = O.Histogram("t", "ticks", n_buckets=8)
        h.observe_many(np.array([0, 1, 2, 3, 4, 7, 8, 1 << 40]))
        got.append((h.counts.tolist(), h.total, h.upper_edges().tolist()))
    assert got[0] == got[1]
    assert got[1] == ([1, 1, 2, 2, 1, 0, 0, 1], 8,
                      [0, 1, 3, 7, 15, 31, 63, 127])


def test_histogram_percentiles_conservative():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 1 << 20, 997)
    got = []
    for O in (RO, TO):
        h = O.Histogram("t", "ticks")
        h.observe_many(np.full(99, 2))
        h.observe(1000)
        fixed = [h.percentile(q) for q in (0.5, 0.99, 0.9999)]
        r = O.Histogram("r")
        r.observe_many(vals)
        got.append((fixed, O.Histogram("e").percentile(0.5),
                    [r.percentile(q) for q in (0.0, 0.5, 0.9, 0.999, 1.0)]))
    assert got[0] == got[1]
    assert got[1][0] == [3, 3, 1023] and got[1][1] == 0


def test_registry_type_conflict_and_snapshot_shape():
    snaps = []
    for O in (RO, TO):
        r = O.Registry()
        r.counter("a.x").inc(3)
        r.gauge("a.g").set_max(7)
        r.histogram("a.h", "rtts").observe(5)
        r.series("a.s", ("tick", "v")).append_rows(np.array([[1.0, 2.0]]))
        r.heat("a.heat", 8).touch(3)
        r.heat("a.heat", 8).update(np.array([1, 9, 17, 3]))
        with pytest.raises(TypeError):
            r.gauge("a.x")
        snaps.append(json.dumps(r.snapshot()))
    assert snaps[0] == snaps[1]
    snap = json.loads(snaps[1])
    assert snap["counters"] == {"a.x": 3}
    assert snap["gauges"] == {"a.g": 7}
    assert snap["histograms"]["a.h"]["unit"] == "rtts"
    assert snap["series"]["a.s"]["rows"] == [[1.0, 2.0]]
    assert snap["heat"]["a.heat"][3] == 2 and snap["heat"]["a.heat"][1] == 3


def test_snapshot_diff_and_merge():
    got = []
    for O in (RO, TO):
        r = O.Registry()
        c = r.counter("n")
        h = r.histogram("h")
        s = r.series("s", ("tick", "v"), capacity=4)
        old = r.snapshot()
        c.inc(5)
        h.observe(4)
        r.heat("x", 4).touch(1)
        s.append_rows(np.array([[3.0, 1.0], [1.0, 2.0]]))
        new = r.snapshot()
        d = O.snapshot_diff(new, old)
        m = O.snapshot_merge(new, new)
        got.append(json.dumps([d, m, O.snapshot_merge(d, old)]))
    assert got[0] == got[1]
    d, m, _ = json.loads(got[1])
    assert d["counters"]["n"] == 5
    assert sum(d["histograms"]["h"]["counts"]) == 1
    assert m["counters"]["n"] == 10
    assert sum(m["histograms"]["h"]["counts"]) == 2
    assert [r[0] for r in m["series"]["s"]["rows"]] == [1.0, 1.0, 3.0, 3.0]


def test_series_ring_wraps_keeping_newest():
    got = []
    for O in (RO, TO):
        s = O.Registry().series("s", ("t",), capacity=4)
        s.append_rows(np.arange(6, dtype=np.float64)[:, None])
        s.append_rows(np.arange(9, dtype=np.float64)[:, None] + 10)
        got.append((s.rows()[:, 0].tolist(), s.dropped))
    assert got[0] == got[1] == ([15.0, 16.0, 17.0, 18.0], 11)


def test_flight_ring_wrap_and_roundtrip(tmp_path):
    rows = np.arange(6 * 10, dtype=np.int64).reshape(6, 10)
    fr = TO.FlightRecorder(capacity=4)
    fr.push_rows(rows)
    ref = RO.FlightRecorder(capacity=4)
    ref.push_rows(rows)
    ev = fr.events()
    assert fr.dropped == ref.dropped == 2
    assert ev["tick"].tolist() == rows[2:, 0].tolist()
    for f, col in ref.events().items():
        assert np.array_equal(ev[f], col), f
    path = str(tmp_path / "f.npz")
    fr.save(path, ["alpha", "beta"])
    for load in (TO.load_flight, RO.load_flight):      # either package reads
        dump = load(path)
        assert dump["labels"] == ["alpha", "beta"]
        assert dump["dropped"] == 2
        assert dump["tick"].tolist() == ev["tick"].tolist()


# ------------------------------------------------------- cluster determinism
def _seeded_run(M, seed, *, dump_dir=None):
    cl = _cluster(M, R.DMConfig(num_mns=4, replication=3), num_clients=3,
                  seed=seed, obs_dump_dir=dump_dir)
    kv = cl.store(0)
    for i in range(30):
        kv.put(f"k{i}", f"v{i}")
    for i in range(30):
        kv.get(f"k{i}")
    kv.drain()
    return cl


def test_step_mode_metrics_match_reference():
    """A step-mode run: the whole metrics snapshot, percentiles included,
    is byte-identical to the reference's as ``json.dumps`` (no metric of a
    step-mode run is path-dependent), and same-seed port runs agree."""
    a = json.dumps(_seeded_run(R, 11).metrics(), sort_keys=True)
    b = json.dumps(_seeded_run(T, 11).metrics(), sort_keys=True)
    assert a == b
    assert b == json.dumps(_seeded_run(T, 11).metrics(), sort_keys=True)
    assert_same_run(obs_signature(RO, _seeded_run(R, 12)),
                    obs_signature(TO, _seeded_run(T, 12)))


def test_metrics_snapshot_contents():
    m = _seeded_run(T, 3).metrics()
    assert m["counters"]["op.settled"] == 60
    assert m["counters"]["op.begun"] == 60
    assert m["counters"]["op.crashed"] == 0
    ins = m["histograms"]["op.lat_ticks.kind.insert"]
    assert ins["unit"] == "ticks" and sum(ins["counts"]) == 30
    p = m["percentiles"]["op.lat_rtts.kind.search"]
    assert p["count"] == 30 and p["p50"] >= 1 and p["p99"] >= p["p50"]
    assert sum(m["heat"]["cache.heat"]) > 0
    assert any(k.startswith("op.lat_ticks.shard.")
               for k in m["histograms"])
    assert any(k.startswith("op.lat_ticks.mn.") for k in m["histograms"])


def test_detached_hub_records_nothing_new():
    def run(M, O):
        cl = _seeded_run(M, 5)
        before = cl.metrics()["counters"]["op.settled"]
        cl.detach_obs()
        assert cl.scheduler.obs is None and cl.pool._obs is None
        kv = cl.store(1)
        for i in range(5):
            kv.put(f"d{i}", b"x")
        kv.drain()
        assert cl.metrics()["counters"]["op.settled"] == before
        cl.attach_obs()
        kv.put("post", b"y")
        kv.drain()
        return cl, before

    cl, before = _both(run)
    assert cl.metrics()["counters"]["op.settled"] == before + 1


def test_legacy_counters_deprecated_but_live():
    """The ``counters`` aliases of the fleet engine, the migration engine
    and a store's backend: read-only views that warn and read through the
    registry handles, with the reference's keys."""
    cl = _seeded_run(T, 1)
    ref = _seeded_run(R, 1)
    views = []
    for c in (cl, ref):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            views.append((c.fleet().counters, c.migrator.counters,
                          c.store(0).backend.counters))
            assert sum(issubclass(x.category, DeprecationWarning)
                       for x in w) == 3
    fleet_c, mig_c, api_c = views[0]
    assert fleet_c["ticks"] == cl.scheduler.metrics.get("fleet.ticks").value
    for got, want in zip(views[0], views[1]):
        assert dict(got) == dict(want)
    with pytest.raises(TypeError):
        fleet_c["ticks"] = 5                 # read-only Mapping


def test_fleet_run_populates_series_and_heat():
    """A fleet YCSB-A run (preload, then waves of the YCSB-A mix through
    ``submit_wave``'s cluster-wide probe): ``deterministic_view(metrics())``
    and the flight ring equal the reference's; the per-MN series and the
    heat sketch are populated."""
    n, n_keys = 16, 128
    mix = YCSB["A"]

    def run(M, O):
        cl = _cluster(M, fleet_dmconfig(n, n_keys), num_clients=n, seed=2)
        fleet = cl.fleet()
        backends = [cl.store(c, max_inflight=0).backend for c in range(n)]
        for k in range(n_keys):
            cl.scheduler.submit(k % n, "insert", k, [k])
        fleet.run()
        wl = cl.rng.stream("workload")
        kinds = list(mix)
        p = [mix[k] for k in kinds]
        for r in range(6):
            wave = []
            for be in backends:
                ops = []
                for j in range(8):
                    key = int(wl.integers(n_keys))
                    ops.append(M.Op.get(key) if kinds[int(wl.choice(
                        len(kinds), p=p))] == "search"
                        else M.Op.update(key, [r, j]))
                wave.append((be, ops))
            fleet.submit_wave(wave)
            fleet.run()
        return cl, fleet.stats()

    cl, st = _both(run)
    assert st["fused_ticks"] > 0 and st["probe_invocations"] > 0
    m = cl.metrics()
    rows = m["series"]["mn.load"]["rows"]
    assert rows, "per-MN series never sampled"
    fields = m["series"]["mn.load"]["fields"]
    assert fields == ["tick", "mid", "bytes", "verbs", "qdepth",
                      "cpu_ops", "util"]
    by = {f: i for i, f in enumerate(fields)}
    assert sum(r[by["bytes"]] for r in rows) > 0
    assert sum(r[by["verbs"]] for r in rows) > 0
    assert all(r[by["util"]] >= 0 for r in rows)
    assert sum(m["heat"]["cache.heat"]) > 0
    top = cl.obs.heat.top(4)
    assert top and top[0][1] >= top[-1][1]


# ------------------------------------------------------- dumps + fault storm
def test_storm_dumps_once_per_fault_class(tmp_path):
    """A seeded fault storm (an MN crash, two client crashes, a recovery):
    one flight dump per fault class, with the reference's file names
    (classes and ticks) and contents; metrics and flight ring equal."""
    def run(M, O):
        dump_dir = str(tmp_path / O.__name__)
        cl = _cluster(M, R.DMConfig(num_mns=4, replication=3),
                      num_clients=3, seed=9, obs_dump_dir=dump_dir)
        plan = (M.FaultPlan().crash_mn(2, after_ops=12)
                .crash_client(0, after_ops=18)
                .crash_client(1, after_ops=24)
                .recover_client(0, after_ops=30))
        cl.inject(plan)
        kv = cl.store(2)
        for i in range(60):
            kv.put(i, [i])
        kv.drain()
        files = sorted(os.listdir(dump_dir))
        return cl, (files, [O.load_flight(os.path.join(dump_dir, f))
                            for f in files])

    (_, (ref_files, ref_dumps)), (_, (files, dumps)) = \
        (run(M, O) for M, O in PKGS)
    assert files == ref_files
    for a, b in zip(dumps, ref_dumps):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) \
                else a[k] == b[k], k
    classes = {f.split("_t")[0] for f in files}
    assert classes == {"flight_fault_crash_mn", "flight_fault_crash_client",
                       "flight_fault_recover_client"}
    assert len(files) == 3
    assert (dumps[0]["etype"] == TO.EV_FAULT).sum() >= 1
    assert "crash_mn" in dumps[0]["labels"]
    cl = _cluster(T, R.DMConfig(num_mns=4, replication=3), num_clients=3,
                  seed=9)
    ref = _cluster(R, R.DMConfig(num_mns=4, replication=3), num_clients=3,
                   seed=9)
    for c, M in ((ref, R), (cl, T)):
        c.inject(M.FaultPlan().crash_mn(2, after_ops=12)
                 .crash_client(0, after_ops=18)
                 .recover_client(0, reassign_to=1, after_ops=30))
        kv = c.store(2)
        for i in range(60):
            kv.put(i, [i])
        kv.drain()
    assert_same_run(obs_signature(RO, ref), obs_signature(TO, cl))
    kinds = cl.obs.labels()
    ev = cl.obs.flight_events()
    assert {kinds[k] for k in ev["kind"][ev["etype"] == TO.EV_RECOVERY]} \
        == {"mn_recovery", "client_recovery"}


def test_undumped_cluster_never_writes():
    cl = _seeded_run(T, 4)
    assert cl.obs.dump("anything") is None
    cl.crash_mn(1)
    assert cl.obs.dumped == {}


# ------------------------------------------------------------------ exports
def test_metrics_json_roundtrip(tmp_path):
    cl = _seeded_run(T, 6)
    path = str(tmp_path / "m.json")
    TO.metrics_to_json(cl.metrics(), path)
    ref_path = str(tmp_path / "ref.json")
    RO.metrics_to_json(_seeded_run(R, 6).metrics(), ref_path)
    with open(path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()               # byte-identical files
    m = TO.load_metrics(path)
    assert m == json.loads(json.dumps(cl.metrics(), sort_keys=True))
    assert RO.load_metrics(path) == m


def test_perfetto_export_roundtrip(tmp_path):
    def run(M, O):
        dump_dir = str(tmp_path / O.__name__)
        cl = _cluster(M, R.DMConfig(num_mns=3, replication=2,
                                    index_shards=4),
                      num_clients=2, seed=8, obs_dump_dir=dump_dir)
        kv = cl.store(0)
        for i in range(20):
            kv.put(i, [i])
        kv.drain()
        cl.crash_mn(2)                    # fault instant + Alg-3 recovery
        kv2 = cl.store(1)
        for i in range(10):
            kv2.put(100 + i, [i])
        kv2.drain()
        cl.add_mn()                       # migration windows
        path = cl.obs.dump("manual", force=True)
        out = str(tmp_path / f"{O.__name__}.json")
        return cl, (O.flight_to_perfetto(O.load_flight(path), out), out)

    _cl, (trace, out) = _both(run)
    ref_trace, ref_out = run(R, RO)[1]
    assert trace == ref_trace
    loaded = TO.load_perfetto(out)
    assert loaded == trace == RO.load_perfetto(out)
    cats = {e.get("cat") for e in trace["traceEvents"]}
    assert {"op", "fault", "migration"} <= cats
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "op"]
    assert ops and all(e["ph"] == "X" and e["dur"] > 0 for e in ops)
    migs = [e for e in trace["traceEvents"] if e.get("cat") == "migration"]
    assert any(e["args"]["phase"] == "cutover" for e in migs)
    ts = [e.get("ts", 0) for e in trace["traceEvents"]]
    assert ts == sorted(ts)
    bogus = str(tmp_path / "bogus.json")
    with open(bogus, "w") as f:
        json.dump({"nope": 1}, f)
    with pytest.raises(ValueError):
        TO.load_perfetto(bogus)


def test_deterministic_view_drops_path_dependent():
    assert TO.PATH_DEPENDENT == RO.PATH_DEPENDENT
    cl = _seeded_run(T, 2)
    cl.fleet()                            # registers fleet.* counters
    m = cl.metrics()
    v = TO.deterministic_view(m)
    assert "fleet.fused_ticks" not in v["counters"]
    assert "fleet.array_calls" not in v["counters"]
    assert "op.settled" in v["counters"]
    assert v == RO.deterministic_view(m)


def test_serving_metrics_twin():
    from repro_torch.serving import PoolConfig, ServeEngine

    class _Stub:                          # never stepped: metrics-only engine
        device = torch.device("cpu")

        def decode_step(self, params, cache, token):
            raise NotImplementedError

    eng = ServeEngine(_Stub(), None, max_batch=2,
                      pool_cfg=PoolConfig(n_pages=64, n_buckets=32,
                                          slots_per_bucket=4))
    m = eng.metrics()
    assert set(m) == {"counters", "gauges", "histograms", "series", "heat"}
    assert all(k.startswith("serve.") for k in m["counters"])
    assert m["gauges"]["serve.slots_free"] == 2
    json.dumps(m)
    merged = TO.snapshot_merge(m, m)
    assert merged == RO.snapshot_merge(m, m)
    assert merged["gauges"]["serve.slots_free"] == 2
    assert merged["counters"] == {k: 2 * v for k, v in m["counters"].items()}
