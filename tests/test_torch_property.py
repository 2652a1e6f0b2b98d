"""The seven cases of tests/test_property.py on the port, at fixed draws.

Each case is parametrized over draws made once from
``np.random.default_rng(20261018)`` and written here as literals: no
hypothesis, no example database and no random draw at test time, so every
run tests the same histories.  Each draw runs on both packages with its own
``np.random.default_rng(seed)``, the reference client carrying ROADMAP C1's
fix (``ref_c1_fixed``), and must give:

* a history that linearizes per key under the port's checker
  (``repro_torch.core.linearize``; the crash case accepts SOME subset of the
  crashed writes as applied, the CRASHED contract);
* the reference's history, op for op (cid, op id, kind, key, value,
  invocation and response ticks, status, result value);
* the same verdict from the reference's checker (``repro.core.linearize``)
  on it.

The crash case also runs the two draws on which the reference fails C1
(seed 51 at 43 steps, seed 88854 at 39); ``test_c1_draws_fail_unfixed_
reference`` runs them on the unwrapped reference, which does not linearize,
and on the port, which does.
"""
import numpy as np
import pytest

import repro.core as R
import repro.core.linearize as ref_lin
import repro_torch.core as T
import repro_torch.core.linearize as port_lin
from repro_torch.analysis.races import detect as port_detect
from repro_torch.analysis.races import report as port_report
from repro_torch.analysis.trace import VerbTracer as PortTracer
from repro.analysis.races import detect as ref_detect
from repro.analysis.trace import VerbTracer as RefTracer

from _torch_parity import (crash_during_commit, linearizes, ref_c1_fixed,
                           step_cluster)

KINDS = ("insert", "update", "search", "delete")
C1_DRAWS = [(51, 43), (88854, 39)]


def _fresh(M, **kw):
    return step_cluster(M, **kw, **({"device": "cpu"} if M is T else {}))


def _cluster(M, cfg_kw, **kw):
    if M is T:
        kw["device"] = "cpu"
    return M.FuseeCluster(M.DMConfig(**cfg_kw), **kw)


def _submit_random_mix(sched, clients, rng, keys, depth):
    recs, val = [], 100
    for c in clients:
        for _ in range(depth):
            kind = KINDS[int(rng.integers(len(KINDS)))]
            key = keys[int(rng.integers(len(keys)))]
            v = [val] if kind in ("insert", "update") else None
            val += 1
            recs.append(sched.submit(c.cid, kind, key, v))
    return recs


def _history(sched) -> list:
    return [(r.cid, r.op_id, r.kind, r.key,
             list(r.value) if isinstance(r.value, (list, tuple))
             else r.value, r.inv_tick,
             r.resp_tick, None if r.result is None else r.result.status,
             None if r.result is None or r.result.value is None
             else repr(r.result.value))
            for r in sched.history]


def _hold(ref_sched, port_sched, keys, crashed=()):
    """The port's history equals the reference's, and linearizes per key
    under both checkers."""
    assert _history(port_sched) == _history(ref_sched)
    for k in keys:
        ok = linearizes(port_lin, port_sched.history, k, crashed)
        assert ok == linearizes(ref_lin, port_sched.history, k, crashed)
        assert ok, f"key {k}"


# ------------------------------------------------------------ random mixes --
def _mix_depth(M, seed, depth):
    rng = np.random.default_rng(seed)
    pool, master, clients, sched = _fresh(M, num_clients=3)
    rec0 = sched.submit(clients[0].cid, "insert", 5, [1])
    sched.run_round_robin()
    assert rec0.result.status == "OK"
    _submit_random_mix(sched, clients, rng, keys=[5], depth=depth)
    sched.run_random(rng=rng)
    return sched


@pytest.mark.usefixtures("ref_c1_fixed")
@pytest.mark.parametrize("seed,depth", [
    (69431, 5), (83953, 2), (58331, 1), (70277, 4), (3043, 5), (45309, 4),
    (69255, 4), (86591, 1)])
def test_random_mix_any_pipeline_depth_linearizable(seed, depth):
    _hold(_mix_depth(R, seed, depth), _mix_depth(T, seed, depth), [5])


def _two_keys(M, seed):
    rng = np.random.default_rng(seed)
    pool, master, clients, sched = _fresh(M, num_clients=4)
    for k in (5, 6):
        sched.submit(clients[0].cid, "insert", k, [k])
    sched.run_round_robin()
    _submit_random_mix(sched, clients, rng, keys=[5, 6], depth=3)
    sched.run_random(rng=rng)
    return sched


@pytest.mark.usefixtures("ref_c1_fixed")
@pytest.mark.parametrize("seed", [46268, 232, 92540, 96922, 62441, 86850,
                                  15348, 72590])
def test_random_mix_two_keys_linearizable_per_key(seed):
    _hold(_two_keys(R, seed), _two_keys(T, seed), [5, 6])


def _replication(M, seed, r):
    rng = np.random.default_rng(seed)
    pool, master, clients, sched = _fresh(M, num_clients=3, r=r,
                                          num_mns=max(4, r))
    sched.submit(clients[0].cid, "insert", 7, [1])
    sched.run_round_robin()
    _submit_random_mix(sched, clients, rng, keys=[7], depth=3)
    sched.run_random(rng=rng)
    return sched


@pytest.mark.usefixtures("ref_c1_fixed")
@pytest.mark.parametrize("seed,r", [
    (45763, 1), (6241, 1), (34260, 1), (40477, 4), (69593, 4), (69355, 1),
    (18307, 1), (89837, 4)])
def test_random_mix_replication_sweep_linearizable(seed, r):
    _hold(_replication(R, seed, r), _replication(T, seed, r), [7])


# ------------------------------------------------------ crash during commit --
@pytest.mark.usefixtures("ref_c1_fixed")
@pytest.mark.parametrize("seed,steps", [
    (50402, 21), (97897, 11), (50710, 19), (57395, 23), (56622, 66),
    (18046, 136), (2763, 78), (3861, 135)] + C1_DRAWS)
def test_crash_during_commit_history_linearizable(seed, steps):
    """Crash a client at a verb boundary with a pipeline of writes in
    flight, recover it (§5.3), finish the survivors: completed ops exactly
    once, crashed ops at most once."""
    ref_sched, _ = crash_during_commit(R, seed, steps)
    sched, crashed = crash_during_commit(T, seed, steps, device="cpu")
    _hold(ref_sched, sched, [9], crashed=crashed)


@pytest.mark.parametrize("seed,steps", C1_DRAWS)
def test_c1_draws_fail_unfixed_reference(seed, steps):
    """ROADMAP C1 pinned: on these draws the reference as it stands (a
    pipelined client's later prepare overwrites the log word an earlier op
    commits) gives a history no subset of the crashed writes explains; the
    port carries the word with its op and linearizes."""
    ref_sched, ref_crashed = crash_during_commit(R, seed, steps)
    assert not linearizes(ref_lin, ref_sched.history, 9, ref_crashed)
    assert not linearizes(port_lin, ref_sched.history, 9, ref_crashed)
    sched, crashed = crash_during_commit(T, seed, steps, device="cpu")
    assert linearizes(port_lin, sched.history, 9, crashed)
    assert linearizes(ref_lin, sched.history, 9, crashed)


# --------------------------------------------- membership churn mid-history --
def _add_mn_cutover(M, seed, steps):
    rng = np.random.default_rng(seed)
    cl = _cluster(M, dict(num_mns=3, replication=2, index_shards=4,
                          region_words=1 << 15, regions_per_mn=8),
                  num_clients=3, seed=seed)
    sched = cl.scheduler
    rec0 = sched.submit(0, "insert", 5, [1])
    sched.run_round_robin()
    assert rec0.result.status == "OK"
    clients = [cl.clients[c] for c in range(3)]
    _submit_random_mix(sched, clients, rng, keys=[5], depth=3)
    for _ in range(steps):
        cids = sched.eligible_cids()
        if not cids:
            break
        sched.step(cids[int(rng.integers(len(cids)))],
                   pick=int(rng.integers(4)))
    cl.add_mn(wait=False)
    sched.run_random(rng=rng)
    if cl.migrator.busy:
        cl.migrator.drive()
    sched.submit(0, "search", 5)
    sched.run_round_robin()
    return sched


@pytest.mark.usefixtures("ref_c1_fixed")
@pytest.mark.parametrize("seed,steps", [
    (38271, 30), (61654, 2), (57814, 85), (20368, 6), (69333, 59),
    (81872, 66), (99650, 74), (77763, 79)])
def test_random_mix_across_add_mn_cutover_linearizable(seed, steps):
    """An MN joins mid-history: the shard migrations' dual-write window and
    the epoch-bump cutover reorder, lose or double-apply nothing."""
    _hold(_add_mn_cutover(R, seed, steps), _add_mn_cutover(T, seed, steps),
          [5])


# ------------------------------------------------- quiescent scan totality --
def _quiescent_scans(M, seed, depth):
    rng = np.random.default_rng(seed)
    cl = _cluster(M, dict(num_mns=4, replication=2, ordered_index=True,
                          region_words=1 << 15, regions_per_mn=16),
                  num_clients=3, seed=seed)
    sched = cl.scheduler
    keys = list(range(24))
    for k in keys[:12]:
        sched.submit(0, "insert", k, [k])
    sched.run_round_robin()
    kinds = ("insert", "update", "delete", "scan")
    val = 1000
    for c in range(3):
        for _ in range(depth):
            kind = kinds[int(rng.integers(len(kinds)))]
            key = keys[int(rng.integers(len(keys)))]
            if kind == "scan":
                sched.submit(c, "scan", key, 1 + int(rng.integers(12)))
            else:
                v = [val] if kind in ("insert", "update") else None
                val += 1
                sched.submit(c, kind, key, v)
    sched.run_random(rng=rng)
    kv = cl.store(0)
    committed = {k: kv.get(k) for k in keys}
    live = sorted(k for k, v in committed.items() if v is not None)
    ranges = {}
    for start, end in ((0, 24), (5, 17), (11, 12), (23, 24)):
        res = kv.range(start, end)
        assert [k for k, _ in res] == [k for k in live if start <= k < end], \
            f"range[{start},{end}): {res}"
        for k, v in res:
            assert committed[k] == v, f"key={k}"
        ranges[start, end] = [(k, list(v)) for k, v in res]
    return sched, committed, ranges


@pytest.mark.usefixtures("ref_c1_fixed")
@pytest.mark.parametrize("seed,depth", [
    (41326, 3), (69681, 4), (19423, 3), (3401, 4), (50187, 1), (6743, 1),
    (41381, 4), (5341, 2)])
def test_quiescent_scan_contains_exactly_committed_keys(seed, depth):
    """After a random insert/update/delete/scan history quiesces, a scan
    returns exactly the keys whose point reads succeed, with their values,
    and the same on both packages."""
    ref_sched, ref_committed, ref_ranges = _quiescent_scans(R, seed, depth)
    sched, committed, ranges = _quiescent_scans(T, seed, depth)
    assert _history(sched) == _history(ref_sched)
    assert committed == ref_committed and ranges == ref_ranges


# ------------------------------------------------------- sanitizer coverage --
def _race_run(M, Tracer, detect, seed, depth, steps):
    rng = np.random.default_rng(seed)
    pool, master, clients, sched = _fresh(M, num_clients=3)
    tr = Tracer(capacity=1 << 14).attach(pool)
    sched.submit(clients[0].cid, "insert", 5, [1])
    sched.run_round_robin()
    _submit_random_mix(sched, clients, rng, keys=[5, 6], depth=depth)
    for _ in range(steps):
        cids = sched.eligible_cids()
        if not cids:
            break
        sched.step(cids[int(rng.integers(len(cids)))],
                   pick=int(rng.integers(4)))
    sched.crash_client(1)
    tr.set_master_ctx(sched.tick)
    master.recover_client(1, reassign_to=clients[2])
    sched.run_random(rng=rng)
    return sched, tr, detect(tr, scheduler=sched)


@pytest.mark.usefixtures("ref_c1_fixed")
@pytest.mark.parametrize("seed,depth,steps", [
    (3473, 3, 10), (4431, 4, 40), (86162, 3, 52), (74155, 3, 101),
    (68565, 3, 78), (79099, 4, 56), (55604, 4, 101), (56141, 4, 102)])
def test_random_mix_with_crash_is_race_free(seed, depth, steps):
    """Random mixes and interleavings with a client crash + §5.3 recovery
    under the verb tracer: equal verb rings, and no race finding on
    either package."""
    ref_sched, ref_tr, ref_f = _race_run(R, RefTracer, ref_detect, seed,
                                         depth, steps)
    sched, tr, findings = _race_run(T, PortTracer, port_detect, seed, depth,
                                    steps)
    assert _history(sched) == _history(ref_sched)
    assert {f: c.tolist() for f, c in tr.events().items()} \
        == {f: c.tolist() for f, c in ref_tr.events().items()}
    assert findings == [] and ref_f == [], port_report(findings, tr)
