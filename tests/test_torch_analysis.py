"""The port's sanitizers against the JAX package's, on the CPU: every case
of tests/test_analysis.py but its nine ``test_lint_*`` cases, which
tests/test_torch_lint.py holds.

Each case runs on both packages and compares what the sanitizers say: the
race detector's findings (rule, region, replica, word, cids, verbs, op
ids, event seqs and detail) and the heap auditor's errors, warnings and
stats.  The test-only revert flags (``UNSAFE_*``) are set on both packages
through ``monkeypatch``, so each is restored at teardown.  Every run here
pipelines several ops per client, so the reference client carries ROADMAP
C1's fix (``ref_c1_fixed``), as the port does.
"""
import numpy as np
import pytest

import repro.analysis.heapcheck as ref_heapcheck
import repro.analysis.races as ref_races
import repro.analysis.trace as ref_trace
import repro.core as R
import repro.core.client as ref_client
import repro.core.sim as ref_sim
import repro_torch.analysis.heapcheck as port_heapcheck
import repro_torch.analysis.races as port_races
import repro_torch.analysis.trace as port_trace
import repro_torch.core as T
import repro_torch.core.client as port_client
import repro_torch.core.sim as port_sim

from _torch_parity import (finding_rows, heap_rows, lost_write_run,
                           ref_c1_fixed)

pytestmark = pytest.mark.usefixtures("ref_c1_fixed")

PKGS = {R: (ref_races, ref_heapcheck, ref_trace, ref_client, ref_sim),
        T: (port_races, port_heapcheck, port_trace, port_client, port_sim)}


def _cluster(M, **kw):
    if M is T:
        kw["device"] = "cpu"
    return M.FuseeCluster(**kw)


def _set_flag(monkeypatch, mod_index: int, name: str, value: bool):
    """Set a test-only revert flag on both packages' module."""
    for mods in PKGS.values():
        monkeypatch.setattr(mods[mod_index], name, value)


# ---------------------------------------------------------------- helpers
def _ev(trace_mod, rows):
    defaults = dict(seq=0, tick=0, cid=0, op_id=0, phase=0, label=0,
                    cause=0, bg=0, verb=trace_mod.WRITE, region=0,
                    replica=0, off=0, n=1, epoch_issue=0, epoch_exec=0,
                    ok=1, arg=0, val=0, old=0)
    cols = {f: np.asarray([int(r.get(f, defaults[f])) for r in rows],
                          np.int64) for f in trace_mod.FIELDS}
    if "seq" not in rows[0]:
        cols["seq"] = np.arange(len(rows), dtype=np.int64)
    return cols


def _detect_both(rows, *, ops=None, rules=None, index_regions={0},
                 ordered_regions=frozenset()):
    """The synthetic rows through both packages' ``detect_events``; the two
    must agree.  ``ops`` maps op id -> (cid, inv, resp, status, rule)."""
    out = []
    for races, _hc, trace_mod, _c, _s in PKGS.values():
        info = {k: races._OpInfo(*v) for k, v in (ops or {}).items()}
        out.append(races.detect_events(
            _ev(trace_mod, rows), ["master", "p"],
            index_regions=set(index_regions),
            ordered_regions=set(ordered_regions), ops=info, rules=rules))
    assert finding_rows(out[0]) == finding_rows(out[1])
    return out[1]


def _small(M, seed=0, **kw):
    return _cluster(M, num_clients=kw.pop("num_clients", 2), seed=seed, **kw)


# ================================================================= tracer
def _trace_cols(tr) -> dict:
    return {f: c.tolist() for f, c in tr.events().items()}


@pytest.mark.parametrize("M", [R, T], ids=["repro", "repro_torch"])
def test_tracer_attach_detach_restores_fast_path(M):
    cl = _small(M)
    pool = cl.pool
    assert "read" not in pool.__dict__
    tr = cl.attach_tracer()
    assert pool.__dict__["read"] is not None
    assert cl.attach_tracer() is tr
    s = cl.store(0)
    s.put(1, [7])
    assert tr.n > 0
    tr.detach()
    assert "read" not in pool.__dict__ and pool._tracer is None
    n = tr.n
    s.put(2, [8])
    assert s.get(2) == [8] and tr.n == n


def test_tracer_pause_skips_recording():
    got = []
    for M in (R, T):
        cl = _small(M)
        tr = cl.attach_tracer()
        s = cl.store(0)
        s.put(1, [1])
        n = tr.n
        tr.pause()
        s.put(2, [2])
        assert tr.n == n
        tr.resume()
        s.put(3, [3])
        assert tr.n > n
        got.append(_trace_cols(tr))
    assert got[0] == got[1]


def test_tracer_ring_wrap_keeps_newest():
    got = []
    for M in (R, T):
        cl = _small(M)
        tr = PKGS[M][2].VerbTracer(capacity=16).attach(cl.pool)
        s = cl.store(0)
        for k in range(8):
            s.put(k, [k])
        assert tr.n > 16 and tr.dropped == tr.n - 16
        ev = tr.events()
        assert len(ev["seq"]) == 16
        assert list(ev["seq"]) == list(range(tr.n - 16, tr.n))
        got.append((tr.n, tr.dropped, _trace_cols(tr)))
    assert got[0] == got[1]


def test_tracer_records_op_context_and_epoch():
    got = []
    for M in (R, T):
        cl = _small(M)
        tr = cl.attach_tracer()
        s = cl.store(0)
        s.put(5, [50])
        ev = tr.events()
        mine = ev["cid"] == 0
        assert mine.any()
        assert (ev["op_id"][mine] >= 0).all()
        assert (ev["epoch_issue"][mine] == cl.pool.epoch).all()
        tr.set_master_ctx(tick=cl.scheduler.tick)
        cl.crash_client(0)
        cl.recover_client(0)
        ev = tr.events()
        assert (ev["cid"] == PKGS[M][2].MASTER_CID).any()
        got.append((tr.labels, _trace_cols(tr)))
    assert got[0] == got[1]


def test_tracer_batch_context_via_fleet():
    got = []
    for M in (R, T):
        cl = _small(M, num_clients=3)
        tr = cl.attach_tracer()
        stores = {c: cl.store(c, max_inflight=0) for c in range(3)}
        futs = [stores[c].submit(M.Op.put(10 + c, [c])) for c in range(3)]
        cl.fleet().run()
        assert all(f.result().status == "OK" for f in futs)
        ev = tr.events()
        assert set(int(c) for c in ev["cid"][ev["cid"] >= 0]) == {0, 1, 2}
        got.append(_trace_cols(tr))
    assert got[0] == got[1]


def test_tracer_save_load_roundtrip(tmp_path):
    got = []
    for M in (R, T):
        VT = PKGS[M][2].VerbTracer
        cl = _small(M)
        tr = cl.attach_tracer()
        cl.store(0).put(1, [9])
        p = tmp_path / f"trace-{M.__name__}.npz"
        tr.save(p)
        ev2, labels = VT.load(p)
        ev1 = tr.events()
        assert labels == tr.labels
        for f in PKGS[M][2].FIELDS:
            assert (ev1[f] == ev2[f]).all(), f
        got.append({f: c.tolist() for f, c in ev2.items()})
    assert got[0] == got[1]


# ================================================= detector (synthetic) ==
WRITE, READ, CAS = port_trace.WRITE, port_trace.READ, port_trace.CAS
MASTER_CID = port_trace.MASTER_CID


def test_trace_constants_match_reference():
    for name in ("READ", "WRITE", "CAS", "FAA", "MASTER_CID", "FIELDS",
                 "VERB_NAMES"):
        assert getattr(port_trace, name) == getattr(ref_trace, name), name
    assert port_races.ALL_RULES == ref_races.ALL_RULES
    assert port_races.CAS_GUARD_WINDOW == ref_races.CAS_GUARD_WINDOW
    assert port_races.MAX_EVENTS_PER_WORD == ref_races.MAX_EVENTS_PER_WORD


def test_rule_stale_epoch_flags_mutations_only():
    rows = [dict(verb=WRITE, epoch_issue=0, epoch_exec=1, off=9),
            dict(verb=READ, epoch_issue=0, epoch_exec=1, off=9)]
    got = _detect_both(rows, rules=("stale_epoch",))
    assert [f.rule for f in got] == ["stale_epoch"]
    assert got[0].off == 9 and got[0].verbs == ("write",)


def test_rule_index_plain_write():
    rows = [dict(verb=WRITE, region=0, cid=1, off=4),
            dict(verb=WRITE, region=5, cid=1, off=4),
            dict(verb=WRITE, region=0, cid=MASTER_CID)]
    got = _detect_both(rows, rules=("index_plain_write",))
    assert len(got) == 1 and got[0].cids == (1,)


def test_rule_clear_order():
    bad = [dict(verb=WRITE, region=0, off=7, arg=0, n=1, replica=0, phase=1),
           dict(verb=WRITE, region=0, off=7, arg=0, n=1, replica=1, phase=2)]
    good = [dict(verb=WRITE, region=0, off=7, arg=0, n=1, replica=1, phase=1),
            dict(verb=WRITE, region=0, off=7, arg=0, n=1, replica=0, phase=2)]
    assert [f.rule for f in _detect_both(bad, rules=("clear_order",))] \
        == ["clear_order"]
    assert _detect_both(good, rules=("clear_order",)) == []
    data = [dict(r, region=5) for r in bad]
    assert _detect_both(data, rules=("clear_order",)) == []


def test_rule_ww_race_and_exclusions():
    ops = {1: (1, 0, 10), 2: (2, 0, 10), 3: (2, 20, 30)}
    race = [dict(verb=WRITE, region=5, off=40, arg=11, cid=1, op_id=1),
            dict(verb=WRITE, region=5, off=40, arg=22, cid=2, op_id=2)]
    got = _detect_both(race, ops=ops, rules=("ww_race",))
    assert len(got) == 1 and sorted(got[0].cids) == [1, 2]
    same_value = [dict(r, arg=11) for r in race]
    assert _detect_both(same_value, ops=ops, rules=("ww_race",)) == []
    ordered = [dict(race[0]), dict(race[1], op_id=3)]
    assert _detect_both(ordered, ops=ops, rules=("ww_race",)) == []
    guarded = [dict(verb=CAS, region=5, off=38, arg=0, val=9, old=0,
                    cid=1, op_id=1)] + race
    assert _detect_both(guarded, ops=ops, rules=("ww_race",)) == []


def test_rule_torn_read():
    rows = [dict(verb=WRITE, region=0, off=7, n=2, cid=1, op_id=4, phase=2,
                 seq=0),
            dict(verb=READ, region=0, off=8, n=1, cid=2, op_id=5, seq=1),
            dict(verb=WRITE, region=0, off=8, n=1, cid=1, op_id=4, phase=2,
                 seq=2)]
    got = _detect_both(rows, rules=("torn_read",))
    assert [f.rule for f in got] == ["torn_read"]
    assert 2 in got[0].cids


def test_rule_lost_cas_ack_needs_acked_op():
    v_mine, v_other = 77 | (5 << 56), 123 | (9 << 56)
    lost = dict(verb=CAS, region=0, off=16, arg=0, val=v_mine, old=v_other,
                cid=1, op_id=9)
    acked = {9: (1, 0, 5, "OK", "LOSE")}
    got = _detect_both([lost], ops=acked, rules=("lost_cas_ack",))
    assert len(got) == 1 and got[0].off == 16
    retried = {9: (1, 0, 5, "FULL")}
    assert _detect_both([lost], ops=retried, rules=("lost_cas_ack",)) == []
    master = {9: (1, 0, 5, "OK", "MASTER_WIN")}
    assert _detect_both([lost], ops=master, rules=("lost_cas_ack",)) == []
    landed = [lost, dict(verb=CAS, region=0, off=24, arg=0, val=v_mine,
                         old=0, cid=1, op_id=9, seq=1)]
    assert _detect_both(landed, ops=acked, rules=("lost_cas_ack",)) == []


def test_report_formats_findings():
    rows = [dict(verb=WRITE, region=0, cid=1, off=4)]
    got = _detect_both(rows, rules=("index_plain_write",))
    txt = port_races.report(got)
    assert txt == ref_races.report(got)
    assert "1 finding(s)" in txt and "index_plain_write" in txt
    assert "clean" in port_races.report([]) == ref_races.report([])


# ============================================= regressions (acceptance) ==
@pytest.mark.parametrize("unsafe", [True, False])
def test_regression_lost_write_cas_race(monkeypatch, unsafe):
    """Lost-write bug class (acking OK after losing an empty-slot index CAS),
    re-introduced on both packages: the port's detector pins the reference's
    finding; with the guard in place both runs are clean."""
    _set_flag(monkeypatch, 3, "UNSAFE_ACK_LOST_EMPTY_CAS", unsafe)
    (rcl, rf, rvals), (cl, findings, vals) = (
        lost_write_run(R), lost_write_run(T, device="cpu"))
    assert finding_rows(findings) == finding_rows(rf) and vals == rvals
    if unsafe:
        assert vals[1] is None
        assert [f.rule for f in findings] == ["lost_cas_ack"]
        f = findings[0]
        assert f.region in cl.pool.index_region_set
        assert f.verbs == ("cas",) and f.cids == (1,)
        assert f.off >= 0 and "acked OK" in f.detail
    else:
        assert vals == ([11], [22])
        assert findings == []


def _storm_both(seed, **kw):
    rcl, rtr = ref_races._storm_run(seed, **kw)
    cl, tr = port_races._storm_run(seed, device="cpu", **kw)
    assert tr.n == rtr.n and tr.dropped == rtr.dropped
    return (rcl, rtr), (cl, tr)


@pytest.mark.parametrize("unsafe", [True, False])
def test_regression_stale_epoch_redirection(monkeypatch, unsafe):
    """Stale-epoch bug class (verbs under an expired lease epoch landing): the
    MN-crash storm of seed 0 with the §5.2 guard bypassed on both packages
    (step mode and the fleet tick read the same flag); equal findings, and
    the same seed with the guard on is clean."""
    _set_flag(monkeypatch, 4, "UNSAFE_EXEC_STALE_EPOCH", unsafe)
    (rcl, _rtr), (cl, _tr) = _storm_both(0)
    rf, findings = rcl.race_findings(), cl.race_findings()
    assert finding_rows(findings) == finding_rows(rf)
    stale = [f for f in findings if f.rule == "stale_epoch"]
    if unsafe:
        assert stale, "guard bypass must produce stale-epoch landings"
        f = stale[0]
        assert f.verbs[0] in ("write", "cas", "faa")
        assert "executed at pool epoch" in f.detail
    else:
        assert findings == []


def test_known_bug_seed7_churn_loses_acked_writes():
    """The churn-cutover acked-write loss of storm seed 7 stays fixed on
    both packages: equal, clean heap audits."""
    (rcl, _), (cl, _) = _storm_both(7, churn=True)
    rep = port_heapcheck.audit(cl)
    assert heap_rows(rep) == heap_rows(ref_heapcheck.audit(rcl))
    assert rep.ok, str(rep)


def test_seed7_churn_bug_reproducible_under_unsafe_flag(monkeypatch):
    """``UNSAFE_FREE_OWN_ON_RETRY`` re-introduces the seed-7-class use
    after free on both packages; it shows on churn seed 4, as in the
    reference's own test, and both auditors report the same errors."""
    _set_flag(monkeypatch, 3, "UNSAFE_FREE_OWN_ON_RETRY", True)
    (rcl, _), (cl, _) = _storm_both(4, churn=True)
    rep = port_heapcheck.audit(cl)
    assert heap_rows(rep) == heap_rows(ref_heapcheck.audit(rcl))
    assert not rep.ok
    assert any("use after free" in e or "invalidated" in e
               for e in rep.errors), str(rep)


@pytest.mark.parametrize("seed", range(16))
def test_churn_storm_seed_neighborhood_clean(seed):
    """The seed-7 neighborhood (0-15) with membership churn: equal verb
    rings, no race finding and a clean heap/epoch audit on both
    packages."""
    (rcl, rtr), (cl, tr) = _storm_both(seed, churn=True)
    assert {f: c.tolist() for f, c in tr.events().items()} \
        == {f: c.tolist() for f, c in rtr.events().items()}
    findings = port_races.detect(tr, scheduler=cl.scheduler)
    assert finding_rows(findings) == finding_rows(
        ref_races.detect(rtr, scheduler=rcl.scheduler))
    assert findings == [], "\n".join(str(f) for f in findings)
    rep = port_heapcheck.audit(cl)
    assert heap_rows(rep) == heap_rows(ref_heapcheck.audit(rcl))
    assert rep.ok, str(rep)


# =============================================================== heapcheck
def _loaded(M, n_keys=12):
    cl = _small(M)
    s = cl.store(0)
    for k in range(n_keys):
        s.put(k, [k, k])
    return cl


def _region_words(M, pool, region, mid) -> np.ndarray:
    """A host copy of an MN's region as unsigned words (either package)."""
    mem = pool.mns[mid].regions[region]
    return mem.numpy().view(np.uint64) if M is T else mem


def _first_ref(M, pool):
    g = pool.index_regions[0]
    mem = _region_words(M, pool, g, pool.placement[g][0])
    w = int(np.nonzero(mem[:pool.cfg.index_words])[0][0])
    return g, w, int(mem[w])


def _poke(M, pool, region, off, value):
    """Forge one word on every replica of ``region`` (the corruption under
    audit), in either package's word type."""
    for mid in pool.placement[region]:
        mem = pool.mns[mid].regions[region]
        if M is T:
            mem[off] = int(np.uint64(value & (2**64 - 1)).view(np.int64))
        else:
            mem[off] = np.uint64(value & (2**64 - 1))


def _audit_both(corrupt) -> object:
    """Load both packages' clusters, apply ``corrupt(M, cluster)`` to each,
    audit both through ``FuseeCluster.heap_audit``; the reports must be
    equal.  Returns the port's."""
    reps = []
    for M in (R, T):
        cl = corrupt(M)
        reps.append(cl.heap_audit())
    assert heap_rows(reps[1]) == heap_rows(reps[0])
    return reps[1]


def test_heapcheck_clean_run():
    rep = _audit_both(_loaded)
    assert rep.ok and rep.errors == [], str(rep)
    assert rep.stats["index_slots_used"] >= 12
    assert rep.stats["leaks"] == 0 and not rep.stats["lenient"]


def test_heapcheck_use_after_free():
    def corrupt(M):
        cl = _loaded(M)
        pool = cl.pool
        _g, _w, slot = _first_ref(M, pool)
        ptr = R.layout.slot_ptr(slot)
        region, off = R.layout.ptr_region(ptr), R.layout.ptr_offset(ptr)
        cfg = pool.cfg
        blk = (off - cfg.bat_words) // cfg.block_words
        obj_idx = (off - pool.block_base(blk)) // R.layout.MIN_OBJ_WORDS
        woff = pool.bitmap_base(blk) + obj_idx // 64
        mem0 = _region_words(M, pool, region, pool.placement[region][0])
        _poke(M, pool, region, woff,
              int(mem0[woff]) | (1 << (obj_idx % 64)))
        return cl
    rep = _audit_both(corrupt)
    assert not rep.ok
    assert any("use after free" in e for e in rep.errors), str(rep)


def test_heapcheck_invalidated_but_referenced():
    def corrupt(M):
        cl = _loaded(M)
        pool = cl.pool
        _g, _w, slot = _first_ref(M, pool)
        L = R.layout
        ptr, sc = L.slot_ptr(slot), L.slot_size_class(slot)
        region, off = L.ptr_region(ptr), L.ptr_offset(ptr)
        tail_off = off + L.size_class_words(sc) - 1
        mem0 = _region_words(M, pool, region, pool.placement[region][0])
        _poke(M, pool, region, tail_off, int(mem0[tail_off]) | L.INVALID_BIT)
        return cl
    rep = _audit_both(corrupt)
    assert not rep.ok
    assert any("invalidated but still referenced" in e
               for e in rep.errors), str(rep)


def test_heapcheck_dangling_reference():
    def corrupt(M):
        cl = _loaded(M)
        pool = cl.pool
        L = R.layout
        g = pool.index_regions[0]
        mem = _region_words(M, pool, g, pool.placement[g][0])
        empty = int(np.nonzero(mem[:pool.cfg.index_words] == 0)[0][0])
        blk = pool.cfg.blocks_per_region - 1
        bogus = L.pack_slot(5, 0, L.pack_ptr(pool.data_regions[0],
                                             pool.block_base(blk)))
        _poke(M, pool, g, empty, int(bogus))
        return cl
    rep = _audit_both(corrupt)
    assert not rep.ok
    assert any("UNALLOCATED" in e for e in rep.errors), str(rep)


def test_heapcheck_epoch_mismatch():
    def corrupt(M):
        cl = _loaded(M, n_keys=2)
        cl.pool.epoch += 1
        return cl
    rep = _audit_both(corrupt)
    assert not rep.ok
    assert any("lease epoch" in e for e in rep.errors), str(rep)
