"""The port's causal op profiler, verb tracer and hot-key monitor
(``repro_torch.obs.spans`` / ``profile`` / ``hotspot``,
``repro_torch.analysis.trace``) against the JAX package, on the CPU.

The cases of ``tests/test_profile.py``, each run on both packages with the
same seeded inputs: every verb-ring column, span tree, critical-path report
(the RTT conservation identity and the crash / open / wrap flags included),
hotspot snapshot and flight ring of the port must equal the reference's.
Sizes follow that file, the 256-client YCSB-A storm included (about 8 s of
the port's CPU time).
"""
import json

import numpy as np
import pytest

import repro.core as R
import repro.obs as RO
import repro_torch.core as T
import repro_torch.obs as TO
from repro_torch.analysis.trace import FIELDS, VerbTracer

from _torch_parity import (assert_same_run, obs_signature, port_config,
                          ref_c1_fixed)

# the reference client carries ROADMAP C1's fix, as the port does
pytestmark = pytest.mark.usefixtures("ref_c1_fixed")


PKGS = ((R, RO), (T, TO))


def _cluster(M, cfg, **kw):
    if M is T:
        return T.FuseeCluster(port_config(cfg), device="cpu", **kw)
    return R.FuseeCluster(cfg, **kw)


def _drive(M, cl, n_clients, ops, *, batch=64):
    """Submit (cid, Op) pairs through per-client stores on fleet ticks."""
    fleet = cl.fleet()
    stores = {c: cl.store(c, max_inflight=0) for c in range(n_clients)}
    for i, (c, op) in enumerate(ops):
        try:
            stores[c].submit(op)
        except M.ClientCrashed:
            pass
        if i % batch == batch - 1:
            fleet.run()
    fleet.run()
    if cl.migrator.busy:
        cl.migrator.drive()
        fleet.run()
    return fleet


def _zipf_ops(M, cl, n_clients, n_keys, n_ops, *, theta=0.99, preload=True):
    ops = []
    if preload:
        ops += [(k % n_clients, M.Op.insert(k, [k])) for k in range(n_keys)]
    wl = cl.rng.stream("workload")
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    p = ranks ** (-theta)
    p /= p.sum()
    keys = wl.choice(n_keys, size=n_ops, p=p)
    for i, k in enumerate(keys):
        op = M.Op.update(int(k), [i]) if i % 2 else M.Op.get(int(k))
        ops.append((i % n_clients, op))
    return ops


def _assert_conserved(ss):
    """The exact per-op identity, checked op by op (not just in sum)."""
    o = ss.ops
    settled = o["rtts"] >= 0
    assert (o["fg_spans"][settled] + o["untraced"][settled]
            == o["rtts"][settled]).all()
    assert (o["untraced"][settled] >= 0).all(), "over-attribution"


def _both(run):
    """``run(M, O)`` on the reference and on the port; the port's obs
    surface must equal the reference's.  Returns the port's cluster and
    result."""
    (ref_cl, ref_out), (cl, out) = (run(M, O) for M, O in PKGS)
    assert_same_run(obs_signature(RO, ref_cl), obs_signature(TO, cl))
    return cl, out


# -------------------------------------------------- conservation under load
def test_rtt_conservation_ycsba_storm_256_clients():
    """The acceptance property: a seeded 256-client YCSB-A-shaped run
    through a crash / recover / add-MN storm conserves RTTs exactly, with
    every verb row, span and report row equal to the reference's."""
    n_clients, n_keys = 256, 512

    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=5, replication=3,
                                    index_shards=4, region_words=1 << 15,
                                    regions_per_mn=16),
                      num_clients=n_clients, seed=42)
        cl.attach_tracer(capacity=1 << 18)
        plan = M.FaultPlan.storm(cl.rng.stream("faults"),
                                 clients=range(n_clients), mns=5,
                                 replication=3, n_client_crashes=2,
                                 n_mn_crashes=1, n_add_mns=1,
                                 remove_added=False, first_op=100,
                                 spacing=120, recover_delay=10)
        cl.inject(plan)
        fleet = _drive(M, cl, n_clients,
                       _zipf_ops(M, cl, n_clients, n_keys, 1500))
        return cl, fleet.stats()["fallback_ticks"]

    cl, fallback = _both(run)
    assert fallback > 0            # a recording tracer turns fusion off
    prof = cl.profile()
    c = prof["conservation"]
    assert c["ok"], c
    assert c["violations"] == 0
    assert c["attributed_rtts"] + c["untraced_rtts"] == c["total_rtts"]
    assert c["ops"] > 1000
    _assert_conserved(prof["spans"])
    causes = {r["cause"] for r in prof["rows"]}
    assert causes - {""}, "no retry causes attributed under a storm"
    h = cl.health()
    assert h.mn_recoveries >= 1 and h.client_recoveries >= 1
    assert len(cl.pool.mns) == 6


def test_mid_flight_crash_flags_not_misattributed():
    n_clients = 4

    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=4, replication=3),
                      num_clients=n_clients, seed=13)
        cl.attach_tracer()
        cl.inject(M.FaultPlan().crash_mn(2, after_ops=30)
                  .crash_client(0, after_ops=40))
        ops = [(i % n_clients, M.Op.put(i, [i])) for i in range(120)]
        _drive(M, cl, n_clients, ops, batch=16)
        return cl, O.spans_from_cluster(cl)

    _cl, ss = _both(run)
    _assert_conserved(ss)
    o = ss.ops
    crashed = (o["flags"] & TO.FLAG_CRASHED) > 0
    assert crashed.any(), "client crash produced no CRASHED ops"
    assert (o["rtts"][crashed] >= 0).all()
    rep = TO.critical_path_report(ss)
    assert rep["conservation"]["ok"], rep["conservation"]


def test_retries_across_add_mn_cutover_conserve():
    """``add_mn`` fired under fleet load: the dual-write window's verbs
    carry ``mig_dual_write`` in both packages' verb rings, row for row."""
    n_clients = 8

    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=2, replication=2,
                                    index_shards=8, region_words=1 << 15,
                                    regions_per_mn=8),
                      num_clients=n_clients, seed=3)
        cl.attach_tracer(capacity=1 << 17)
        fleet = cl.fleet()
        sched = cl.scheduler
        backends = [cl.store(c, max_inflight=0).backend
                    for c in range(n_clients)]
        k, added = 0, False
        while k < 300 or cl.migrator.busy or sched.has_work():
            for c in range(n_clients):
                if k < 300 and sched.inflight(c) < 4:
                    backends[c].submit_many([M.Op.put(k, [k])])
                    k += 1
            if k >= 100 and not added:
                cl.add_mn(wait=False)
                added = True
            fleet.tick()
        return cl, O.spans_from_cluster(cl)

    _cl, ss = _both(run)
    _assert_conserved(ss)
    rep = TO.critical_path_report(ss)
    assert rep["conservation"]["ok"], rep["conservation"]
    labels = {(r["phase"], r["cause"]) for r in rep["rows"]}
    assert any(c == "mig_dual_write" for _p, c in labels), \
        "cutover window left no dual-write attribution"


def test_wrapped_verb_ring_partial_but_flagged():
    n_clients = 4

    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=4, replication=3),
                      num_clients=n_clients, seed=17)
        tr = cl.attach_tracer(capacity=256)
        ops = [(i % n_clients, M.Op.put(i, [i])) for i in range(200)]
        ops += [(i % n_clients, M.Op.get(i % 200)) for i in range(200)]
        _drive(M, cl, n_clients, ops, batch=16)
        return cl, (tr, O.spans_from_cluster(cl))

    _cl, (tr, ss) = _both(run)
    assert tr.dropped > 0 and ss.trace_dropped > 0
    _assert_conserved(ss)
    partial = (ss.ops["flags"] & TO.FLAG_PARTIAL) > 0
    assert partial.any(), "wrapped ring produced no FLAG_PARTIAL ops"
    rep = TO.critical_path_report(ss)
    assert rep["conservation"]["partial_ops"] == int(partial.sum())
    assert rep["conservation"]["ok"], rep["conservation"]
    assert rep["totals"]["trace_dropped"] == ss.trace_dropped


def test_same_seed_profiles_match_reference():
    def one(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=4, replication=3,
                                    index_shards=4),
                      num_clients=8, seed=29)
        cl.attach_tracer(capacity=1 << 16)
        cl.inject(M.FaultPlan().crash_mn(3, after_ops=60))
        _drive(M, cl, 8, _zipf_ops(M, cl, 8, 128, 400))
        prof = cl.profile()
        prof.pop("spans")
        prof.pop("tick_phases", None)           # wall clock: never compared
        return json.dumps(prof, sort_keys=True)
    assert one(R, RO) == one(T, TO)


# ------------------------------------------------------------- span units
def test_build_spans_empty_trace_all_untraced():
    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=3, replication=2),
                      num_clients=2, seed=1)
        kv = cl.store(0)
        for i in range(10):
            kv.put(i, [i])
        kv.drain()
        obs = cl.obs
        ss = O.build_spans({f: np.zeros(0, np.int64)
                            for f in ("seq", "tick", "cid", "op_id", "phase",
                                      "label", "cause", "bg", "ok")},
                           [], obs.flight_events(), obs.labels())
        return cl, (ss, O.critical_path_report(ss))

    (_, (ref_ss, ref_rep)), (_, (ss, rep)) = (run(M, O) for M, O in PKGS)
    assert ss.n_spans == 0 and ss.n_ops == 10
    _assert_conserved(ss)
    assert (ss.ops["untraced"] == ss.ops["rtts"]).all()
    assert rep["conservation"]["ok"]
    assert all(r["phase"] == "(untraced)" for r in rep["rows"])
    assert json.dumps(rep, sort_keys=True) == \
        json.dumps(ref_rep, sort_keys=True)


def test_open_ops_flagged_and_excluded():
    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=3, replication=2),
                      num_clients=2, seed=2)
        cl.attach_tracer()
        kv = cl.store(0)
        for i in range(6):
            kv.put(i, [i])
        kv.drain()
        cl.store(1).submit(M.Op.put(99, [99]))
        for _ in range(2):                      # a couple of beats only
            cl.scheduler.step(1)
        return cl, O.spans_from_cluster(cl)

    _cl, ss = _both(run)
    o = ss.ops
    open_ops = (o["flags"] & TO.FLAG_OPEN) > 0
    assert open_ops.sum() == 1
    assert (o["rtts"][open_ops] == -1).all()
    rep = TO.critical_path_report(ss)
    assert rep["totals"]["open_ops"] == 1
    assert rep["conservation"]["ops"] == int((~open_ops).sum())
    tree = ss.op_tree(1, int(o["op_id"][open_ops][0]))
    assert tree is not None and tree["rtts"] == -1


def test_op_tree_shape_and_format_report():
    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=3, replication=2),
                      num_clients=2, seed=5)
        cl.attach_tracer()
        kv = cl.store(0)
        kv.insert(7, [7])
        kv.get(7)
        kv.drain()
        ss = O.spans_from_cluster(cl)
        o = ss.ops
        row = int(np.flatnonzero(o["rtts"] >= 0)[0])
        tree = ss.op_tree(int(o["cid"][row]), int(o["op_id"][row]))
        return cl, (tree, O.format_report(O.critical_path_report(ss),
                                          top=3))

    (_, ref), (_, (tree, txt)) = (run(M, O) for M, O in PKGS)
    assert (tree, txt) == ref
    assert tree["spans"], "settled op reconstructed with no spans"
    phases = [s["phase"] for s in tree["spans"]]
    assert phases == sorted(phases), "spans not in phase order"
    assert all(s["verbs"] >= 1 for s in tree["spans"])
    assert "conservation: OK" in txt
    assert txt.count("\n") <= 3 + 2 + 1


def test_spans_nest_in_perfetto_export(tmp_path):
    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=3, replication=2),
                      num_clients=2, seed=8)
        cl.attach_tracer()
        kv = cl.store(0)
        for i in range(12):
            kv.put(i, [i])
        kv.drain()
        ss = O.spans_from_cluster(cl)
        obs = cl.obs
        path = str(tmp_path / f"{O.__name__}.json")
        trace = O.flight_to_perfetto({"labels": obs.labels(),
                                      **obs.flight_events(),
                                      "dropped": obs.flight.dropped},
                                     path, spans=ss)
        return cl, (trace, O.load_perfetto(path))

    (_, (ref_trace, _)), (_, (trace, loaded)) = (run(M, O) for M, O in PKGS)
    assert trace == ref_trace and loaded == trace
    evs = trace["traceEvents"]
    phase_spans = [e for e in evs if e.get("cat") == "phase"
                   and e.get("ph") == "X"]
    op_spans = {(e["tid"], e["args"]["op_id"]): e for e in evs
                if e.get("cat") == "op" and "op_id" in e.get("args", {})}
    assert phase_spans
    for e in phase_spans:
        parent = op_spans.get((e["tid"], e["args"]["op_id"]))
        assert parent is not None
        assert parent["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 1e-9


# ------------------------------------------------------------- verb tracer
def test_step_mode_tracer_rows_match_reference(tmp_path):
    """A step-mode run with an MN crash, a client crash and its recovery:
    the verb ring equals the reference's in every column (CAS / FAA old
    values, WRITE first words and payload crc32 as int64 bit patterns, the
    master's recovery traffic under the master context), and a saved ring
    loads back in either package."""
    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=4, replication=3),
                      num_clients=3, seed=19, mn_detect_delay=3)
        tr = cl.attach_tracer()
        cl.inject(M.FaultPlan().crash_mn(1, after_ops=10)
                  .crash_client(0, after_ops=16)
                  .recover_client(0, reassign_to=2, after_ops=22))
        stores = [cl.store(c) for c in range(3)]
        for c in range(3):
            stores[c].submit_batch(
                [M.Op.put(i, [i, c, (1 << 64) - 1 - i]) for i in range(12)]
                + [M.Op.get(i) for i in range(4)])
        cl.drain()
        return cl, tr

    _cl, tr = _both(run)
    ev = tr.events()
    assert (ev["cid"] == -1).any() and (ev["ok"] == 0).any()
    assert (ev["old"] < 0).any() or (ev["arg"] < 0).any()
    path = str(tmp_path / "trace.npz")
    tr.save(path)
    from repro.analysis.trace import VerbTracer as RefTracer
    for loader in (VerbTracer.load, RefTracer.load):
        got, labels = loader(path)
        assert labels == tr.labels
        for f in FIELDS:
            assert np.array_equal(got[f], ev[f]), f


def test_paused_tracer_keeps_fusion_and_records_nothing():
    """A paused tracer leaves the fused tick on (the same fused and
    fallback tick counts as an untraced run) and records nothing; resumed,
    it turns fusion off and records; detached, the pool's own verbs are
    back."""
    def run(M, O, trace=True):
        cl = _cluster(M, R.DMConfig(num_mns=3, replication=2),
                      num_clients=4, seed=6)
        tr = cl.attach_tracer() if trace else None
        if trace:
            tr.pause()
        fleet = _drive(M, cl, 4, [(i % 4, M.Op.put(i, [i]))
                                  for i in range(24)])
        paused = (fleet.stats()["fused_ticks"],
                  fleet.stats()["fallback_ticks"], tr.n if trace else 0)
        if trace:
            tr.resume()
        _drive(M, cl, 4, [(i % 4, M.Op.get(i)) for i in range(24)])
        return cl, (paused, fleet.stats()["fallback_ticks"], tr)

    cl, ((fused, fallback, n), fallback_after, tr) = _both(run)
    _cl0, ((fused0, fallback0, _), fallback_after0, _) = run(T, TO, False)
    assert (fused, fallback) == (fused0, fallback0) and n == 0
    assert fallback_after > fallback_after0 and tr.n > 0
    tr.detach()
    assert "read_batch" not in vars(cl.pool) and cl.pool._tracer is None


# --------------------------------------------------------------- hotspot
def test_space_saving_exact_under_capacity():
    got = []
    for O in (RO, TO):
        s = O.SpaceSaving(capacity=16)
        keys = [1] * 5 + [2] * 3 + [3] * 2 + [4]
        s.update(np.array(keys))
        s.update(np.array([1, 1, 5]))
        got.append((s.top(), s.n_seen))
    assert got[0] == got[1]
    top, n_seen = got[1]
    assert top[0] == (1, 7, 0) and top[1] == (2, 3, 0)
    assert n_seen == 14


def test_space_saving_eviction_error_bound():
    got = []
    for O in (RO, TO):
        s = O.SpaceSaving(capacity=4)
        rng = np.random.default_rng(0)
        true = {k: 0 for k in range(64)}
        for _ in range(30):
            batch = np.concatenate([np.repeat([0, 1], 10),
                                    rng.integers(2, 64, size=8)])
            for k in batch:
                true[int(k)] += 1
            s.update(batch)
        got.append(s.top())
    assert got[0] == got[1]
    assert {k for k, _c, _e in got[1][:2]} == {0, 1}
    for k, c, e in got[1]:
        assert true[k] <= c <= true[k] + e


def test_space_saving_deterministic():
    def run(O):
        s = O.SpaceSaving(capacity=8)
        rng = np.random.default_rng(7)
        for _ in range(20):
            s.update(rng.integers(0, 40, size=32))
        return s.top()
    assert run(TO) == run(TO) == run(RO)


def test_zipf_theta_estimator_contract():
    ranks = np.arange(1, 129, dtype=np.float64)
    cases = (np.round(1e6 * ranks ** -0.99), np.full(128, 50.0), [9, 5, 3],
             np.zeros(20), np.random.default_rng(3).integers(1, 500, 64))
    assert [TO.zipf_theta(c) for c in cases] == \
        [RO.zipf_theta(c) for c in cases]
    assert abs(TO.zipf_theta(cases[0]) - 0.99) < 0.05
    assert TO.zipf_theta(cases[1]) == pytest.approx(0.0, abs=0.05)
    assert TO.zipf_theta(cases[2]) == 0.0 and TO.zipf_theta(cases[3]) == 0.0


def test_hotkey_monitor_regime_hysteresis():
    def run(O):
        m = O.HotKeyMonitor(top_k=8, capacity=32, theta_hi=0.6,
                            imb_hi=2.0, imb_lo=1.4)
        events = [m.evaluate()]
        rng = np.random.default_rng(1)
        ranks = np.arange(1, 65, dtype=np.float64)
        p = ranks ** -1.2
        p /= p.sum()
        for _ in range(12):
            m.observe_keys(rng.choice(64, size=256, p=p))
            events.append(m.evaluate())
        events.append(m.evaluate())
        return events, m.snapshot()
    ref, (events, snap) = run(RO), run(TO)
    assert (events, snap) == ref
    assert events[0] is None and events[-1] is None
    flips = [e for e in events if e is not None]
    assert len(flips) == 1 and flips[0]["regime"] == "skewed"
    assert snap["regime"] == "skewed" and snap["regime_flips"] == 1
    json.dumps(snap)


def test_hotkey_monitor_imbalance_ewma():
    got = []
    for O in (RO, TO):
        m = O.HotKeyMonitor(alpha=0.5)
        for _ in range(6):
            m.observe_load(np.array([0, 0, 0, 1]), np.array([2, 2, 2, 2]))
        got.append((m.shard_imbalance, m.mn_imbalance,
                    O.HotKeyMonitor().shard_imbalance))
    assert got[0] == got[1]
    shard, mn, fresh = got[1]
    assert shard > 1.4 and mn == 1.0 and fresh == 1.0


def test_planted_zipf_top32_recovered_within_2k_ticks():
    n_clients, n_keys = 16, 4096

    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=4, replication=3,
                                    index_shards=4, region_words=1 << 16,
                                    regions_per_mn=16),
                      num_clients=n_clients, seed=23)
        cl.enable_hotspot()
        fleet = cl.fleet()
        sched = cl.scheduler
        for k in range(64):
            sched.submit(k % n_clients, "insert", k, [k])
        fleet.run()
        wl = cl.rng.stream("workload")
        ranks = np.arange(1, n_keys + 1, dtype=np.float64)
        p = ranks ** (-0.99)
        p /= p.sum()
        tick0 = sched.tick
        while sched.tick - tick0 < 2000:
            keys = wl.choice(n_keys, size=n_clients, p=p)
            for c, k in enumerate(keys):
                sched.submit(c, "search", int(k), None)
            fleet.run()
        cl.obs.flush()
        return cl, None

    cl, _ = _both(run)
    got = {k for k, _c, _e in cl.obs.hotspot.sketch.top(32)}
    assert len(got & set(range(32))) / 32 >= 0.90
    assert cl.metrics()["hotspot"]["theta_milli"] > 350


def test_regime_event_lands_in_flight_ring():
    n_clients = 8

    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=4, replication=3),
                      num_clients=n_clients, seed=31)
        cl.enable_hotspot(theta_hi=0.3, imb_hi=1.5)
        _drive(M, cl, n_clients,
               _zipf_ops(M, cl, n_clients, 128, 600, theta=1.2))
        return cl, None

    cl, _ = _both(run)
    ev = cl.obs.flight_events()
    regimes = ev["etype"] == TO.EV_REGIME
    assert regimes.any(), "no regime event recorded"
    labels = cl.obs.labels()
    assert "skewed" in {labels[int(k)] for k in ev["kind"][regimes]}
    m = cl.metrics()
    assert m["gauges"]["hot.regime"] == 1
    assert m["counters"]["hot.regime_flips"] >= 1
    trace = TO.flight_to_perfetto({"labels": labels, **ev, "dropped": 0})
    regs = [e for e in trace["traceEvents"] if e.get("cat") == "regime"]
    assert regs and all(e["ph"] == "i" for e in regs)
    assert all("theta_milli" in e["args"] for e in regs)
    st = cl.store(0).stats()
    assert st["hot_regime"] == "skewed" and len(st["hot_keys"]) == 8


def test_hotspot_off_keeps_snapshots_identical():
    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=4, replication=3),
                      num_clients=3, seed=11)
        kv = cl.store(0)
        for i in range(30):
            kv.put(f"k{i}", f"v{i}")
        kv.drain()
        return cl, None

    cl, _ = _both(run)
    m = cl.metrics()
    assert "hotspot" not in m
    assert not any(k.startswith("hot.") for k in m["counters"])
    assert not any(k.startswith("hot.") for k in m["gauges"])
    assert "hot_keys" not in cl.store(0).stats()


# ------------------------------------------------- obs-hub flush hardening
def test_pending_heat_and_events_survive_detach():
    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=3, replication=2),
                      num_clients=2, seed=4)
        obs = cl.obs
        for i in range(10):
            obs.heat_key64(i)
        assert obs._heat_pend
        cl.enable_hotspot()
        cl.detach_obs()
        assert not obs._heat_pend
        return cl, obs

    cl, obs = _both(run)
    assert sum(cl.metrics()["heat"]["cache.heat"]) >= 10
    assert obs.hotspot.sketch.n_seen == 10


def test_cluster_events_flush_at_threshold():
    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=3, replication=2),
                      num_clients=2, seed=6)
        obs = cl.obs
        obs.flush()
        for i in range(obs.flush_every + 5):
            obs.fault("synthetic", i, tick=i)
        assert len(obs._pend) < obs.flush_every
        return cl, obs

    _cl, obs = _both(run)
    ev = obs.flight_events()
    assert (ev["etype"] == TO.EV_FAULT).sum() == obs.flush_every + 5


def test_flight_events_accessor_sees_buffered_tail():
    def run(M, O):
        cl = _cluster(M, R.DMConfig(num_mns=3, replication=2),
                      num_clients=2, seed=9)
        kv = cl.store(0)
        for i in range(5):
            kv.put(i, [i])
        kv.drain()
        obs = cl.obs
        assert obs._pend
        raw = obs.flight.events()["etype"]
        return cl, (len(raw), len(obs.flight_events()["etype"]))

    _cl, (raw, via) = _both(run)
    assert via > raw
