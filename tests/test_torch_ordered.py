"""The port's ordered keydir (SCAN/RANGE) against the JAX package, on the
CPU.

* ``leaf_probe``: the plain torch version against ``leaf_probe_np``,
  ``leaf_probe_ref`` and the Pallas kernel in interpret mode, on the edge
  sets of ``tests/test_kernels.py`` plus the 32- and 64-bit boundaries,
  duplicate lows and no lows at all (tolerance 0).
* The keydir's codec and the fence cache: leaves, meta words, locate
  hints, locate waves and chain predictions equal the reference's; the
  port's ``FenceCache`` keeps its sorted view and version right through
  seeded sequences of every dict mutator.
* The non-slow cases of ``tests/test_ordered.py``, each run on both
  packages: the results and the run's ``signature()`` (pool bytes,
  ``health()``, op history, per-MN bytes, fleet counters) must be equal.
* One seeded scan storm (client and MN crashes under mixed scan/insert
  fleet traffic) and the small YCSB-E run with a client crashed inside a
  leaf split (``_torch_parity.ycsbe_crash_scenario``) on both packages.

The YCSB-E fleet runs (mix "E" of ``_ycsb``) are in
``tests/test_torch_fleet.py``; the card's ``leaf_probe`` launches are in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import ordered as RO
from repro.kernels.leaf_probe.kernel import leaf_probe_fwd
from repro.kernels.leaf_probe.ref import leaf_probe_ref
from repro_torch.core import ordered as TO
from repro_torch.core.fences import FenceCache
from repro_torch.kernels import leaf_probe, leaf_probe_plain, reset_launches

from _torch_parity import assert_same_run, ref_c1_fixed, signature

# the reference client carries ROADMAP C1's fix, as the port does
pytestmark = pytest.mark.usefixtures("ref_c1_fixed")


M64 = (1 << 64) - 1
CFG = dict(num_mns=4, replication=3, ordered_index=True,
           region_words=1 << 15, regions_per_mn=16)
EDGES = [0, 1, 1 << 31, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
         (1 << 64) - 2]


def _kw(M):
    return {} if M is R else {"device": "cpu"}


def _cluster(M, num_clients=2, seed=0, mn_detect_delay=0, **over):
    return M.FuseeCluster(M.DMConfig(**{**CFG, **over}),
                          num_clients=num_clients, seed=seed,
                          mn_detect_delay=mn_detect_delay, **_kw(M))


def _both(run, *args):
    """``run`` on the reference and on the port: equal results and equal
    run signatures.  ``run(M, *args)`` returns (result, cluster[, fleet])."""
    ref = run(R, *args)
    port = run(T, *args)
    assert port[0] == ref[0]
    assert_same_run(signature(*ref[1:]), signature(*port[1:]))
    return ref[0]


def _sound(res, start, end=None):
    keys = [k for k, _v in res]
    assert keys == sorted(set(keys))
    assert all(k >= start for k in keys)
    if end is not None:
        assert all(k < end for k in keys)


# ------------------------------------------------------------- leaf probe
def _t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint64).view(np.int64))


def _all_probes(starts, lows):
    """(plain torch, leaf_probe_np, leaf_probe_ref, Pallas interpret) on
    the same uint64 inputs, each as an int32 numpy array."""
    got = leaf_probe_plain(_t64(starts), _t64(lows)).numpy()
    outs = [got, RO.leaf_probe_np(starts, lows)]
    halves = [jnp.asarray((x >> np.uint64(32)).astype(np.uint32))
              for x in (starts, lows)] + \
        [jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32))
         for x in (starts, lows)]
    shi, lhi, slo, llo = halves
    outs.append(np.asarray(leaf_probe_ref(shi, slo, lhi, llo)))
    if len(lows):
        outs.append(np.asarray(leaf_probe_fwd(shi, slo, lhi, llo,
                                              block_keys=len(starts),
                                              interpret=True)))
    return outs


@pytest.mark.parametrize("n_starts,n_lows", [(256, 7), (512, 100), (128, 1)])
def test_leaf_probe_plain_matches_reference(n_starts, n_lows):
    """``tests/test_kernels.py``'s edge set: lows straddling the 32-bit
    boundary and at 2^64-2, starts over the full 64-bit range."""
    rng = np.random.default_rng(n_starts + n_lows)
    lows = np.sort(rng.choice(np.array(
        [0, 1, 5, (1 << 32) - 1, 1 << 32, (1 << 32) + 7, 1 << 40,
         (1 << 64) - 2], np.uint64), size=n_lows, replace=True))
    lows = np.unique(np.concatenate(
        [lows, rng.integers(0, 1 << 63, size=max(n_lows - len(lows), 1),
                            dtype=np.uint64)]))[:n_lows]
    lows = np.sort(lows)
    starts = rng.integers(0, 1 << 64, size=n_starts, dtype=np.uint64)
    starts[: len(lows)] = lows[: len(lows)]          # exact-hit edges
    got, *refs = _all_probes(starts, lows)
    assert got.dtype == np.int32
    for want in refs:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n_lows", [0, 1, 2, 8, 300])
def test_leaf_probe_plain_edges_and_duplicates(n_lows):
    """Starts and lows at 0, 2^31, 2^32-1, 2^32, 2^63-1, 2^63 and 2^64-2;
    duplicate lows (racing splits mint them: the last of a run wins); no
    lows at all (every start -> -1)."""
    rng = np.random.default_rng(n_lows)
    pool = np.array(EDGES, np.uint64)
    lows = np.sort(np.concatenate([
        rng.choice(pool, size=n_lows // 2 + n_lows % 2),
        rng.integers(0, 1 << 64, n_lows // 2, dtype=np.uint64)]))
    if n_lows > 2:
        lows[n_lows // 3:n_lows // 3 + 3] = lows[n_lows // 3]  # duplicates
        lows = np.sort(lows)
    starts = np.concatenate([pool, pool - np.uint64(1), lows,
                             rng.integers(0, 1 << 64, 257, dtype=np.uint64)])
    got, *refs = _all_probes(starts, lows)
    for want in refs:
        assert np.array_equal(got, want)
    if n_lows == 0:
        assert (got == -1).all()


def test_leaf_probe_wrapper_cpu_path_and_batch_entry_point():
    """The reference's ``leaf_probe_batch`` example; a CPU tensor takes the
    plain version and launches nothing; wrong inputs raise."""
    from repro.kernels import leaf_probe_batch
    lows = np.array([0, 10, 20, 30], np.uint64)
    starts = np.array([0, 5, 10, 29, 30, 31, 2 ** 63], np.uint64)
    reset_launches()
    got = leaf_probe(_t64(starts), _t64(lows))
    assert got.tolist() == leaf_probe_batch(starts, lows).tolist() \
        == [0, 0, 1, 2, 3, 3, 3]
    assert leaf_probe.launches == 0
    assert leaf_probe(_t64(starts[:0]), _t64(lows)).numel() == 0
    with pytest.raises(TypeError):
        leaf_probe(_t64(starts).to(torch.int32), _t64(lows))
    with pytest.raises(ValueError):
        leaf_probe(_t64(starts)[:, None], _t64(lows))


# ---------------------------------------------------- codec and fences
def test_leaf_codec_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        low, prev = int(rng.integers(0, 1 << 63)) * 2, int(rng.integers(1 << 20))
        ver, nxt = int(rng.integers(1 << 16)), int(rng.integers(1 << 20))
        ents = [TO.stored(int(k)) for k in
                rng.integers(0, 1 << 64, int(rng.integers(0, 14)),
                             dtype=np.uint64)]
        words = TO.build_leaf(low, ver, nxt, prev, ents)
        assert words == RO.build_leaf(low, ver, nxt, prev, ents)
        arr = np.array([w & M64 for w in words], np.uint64)
        assert TO.parse_leaf(arr) == RO.parse_leaf(arr)
    assert TO.stored(M64) == RO.stored(M64) == 0
    assert TO.unstored(0) == RO.unstored(0) == M64


def test_fence_cache_hints_match_reference():
    """Locate hints and chain predictions from the same fence cache
    (random lows, duplicates, deletions) equal the reference's."""
    rng = np.random.default_rng(3)
    ref_c = R.FuseeCluster(R.DMConfig(**CFG), num_clients=1).clients[0]
    port_c = _cluster(T, num_clients=1).clients[0]
    ref_c.ord_fences = {}
    port_c.ord_fences = {}
    lows = rng.integers(0, 1 << 64, 60, dtype=np.uint64).tolist()
    for i in range(300):
        lid = int(rng.integers(60))
        low = lows[lid] if rng.random() < 0.8 else int(rng.integers(1 << 40))
        if rng.random() < 0.1:
            low = lows[0]                               # duplicate lows
        for c in (ref_c, port_c):
            c.ord_fences[lid] = low
        if i % 50 == 49:
            victim = next(iter(ref_c.ord_fences))
            del ref_c.ord_fences[victim]
            del port_c.ord_fences[victim]
        assert port_c.ord_fences == ref_c.ord_fences
        starts = [0, M64, lows[lid], lows[lid] - 1] + \
            rng.integers(0, 1 << 64, 5, dtype=np.uint64).tolist()
        assert TO.locate_leaves(port_c, starts) == \
            RO.locate_leaves(ref_c, starts)
        assert TO._predict_chain(port_c, lid, 7) == \
            RO._predict_chain(ref_c, lid, 7)


def test_leaf_probe_hint_roundtrip():
    """locate_leaves hints agree with the covering leaves (the reference's
    test), and with the reference's hints."""
    def run(M):
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(100):
            kv.insert(k, [k])
        client = cl.clients[0]
        hints = M.ordered.locate_leaves(client, [0, 13, 57, 99])
        for start, leaf in zip([0, 13, 57, 99], hints):
            assert client.ord_fences[leaf] <= start
        return hints, cl
    _both(run)


# ------------------------------------------------------------ fence cache
def _check_sorted_view(fc):
    lows, ids = fc.sorted_view()
    assert lows.dtype == np.uint64 and ids.dtype == np.int64
    assert list(zip(map(int, lows), map(int, ids))) == \
        sorted((low, lid) for lid, low in fc.items())
    assert torch.equal(fc.device_lows(torch.device("cpu")),
                       _t64(lows))


@pytest.mark.parametrize("seed", range(4))
def test_fence_cache_sorted_view_and_version(seed):
    """Seeded sequences of set, same-value set, overwrite, delete,
    ``update``, ``setdefault``, ``pop``, ``popitem``, ``|=``, ``clear``
    and re-bootstrap (a clear, then a chain walk of sets with no read in
    between): the cache equals a plain dict driven alike, its version moves
    exactly when its contents change, and after each step (after each
    chain walk) its sorted view is ``sorted((low, lid))``."""
    rng = np.random.default_rng(seed)
    lows = [0, 1, (1 << 63) - 1, 1 << 63, M64] + \
        rng.integers(0, 1 << 64, 12, dtype=np.uint64).tolist()
    fc, shadow = FenceCache(), {}

    def low():
        return lows[int(rng.integers(len(lows)))]

    def step(fn):
        before, v0 = dict(shadow), fc.version
        assert fn(fc) == fn(shadow)
        assert fc == shadow
        assert (fc.version != v0) == (shadow != before)

    for _ in range(300):
        lid = int(rng.integers(24))
        op = int(rng.integers(10))
        if op == 0:
            v = low()
            step(lambda d: d.__setitem__(lid, v))
        elif op == 1 and shadow:
            same = next(iter(shadow))
            step(lambda d: d.__setitem__(same, shadow[same]))
        elif op == 2 and lid in shadow:
            step(lambda d: d.__delitem__(lid))
        elif op == 3:
            upd = {int(rng.integers(24)): low() for _ in range(3)}
            step(lambda d: d.update(upd))
        elif op == 4:
            v = low()
            step(lambda d: d.setdefault(lid, v))
        elif op == 5:
            step(lambda d: d.pop(lid, None))
        elif op == 6 and shadow:
            step(lambda d: d.popitem())
        elif op == 7:
            upd = {int(rng.integers(24)): low()}
            step(lambda d: d.__ior__(upd) and None)
        elif op == 8:
            step(lambda d: d.clear())
        elif op == 9:                       # re-bootstrap: clear + chain walk
            step(lambda d: d.clear())
            for i in range(int(rng.integers(1, 40))):
                v = low()
                step(lambda d: d.__setitem__(i, v))
        _check_sorted_view(fc)


def test_fence_cache_grows_in_place():
    """Fences added one at a time with a read after each (a rebuild of the
    sorted view and a new upload of the lows after every change, through
    several growths of the staging buffers), then removed again."""
    rng = np.random.default_rng(11)
    fc, lids = FenceCache(), rng.permutation(300).tolist()
    for lid in lids:
        fc[lid] = int(rng.integers(0, 40)) << 58       # many equal lows
        _check_sorted_view(fc)
    for lid in lids[::2]:
        del fc[lid]
        _check_sorted_view(fc)
    assert len(fc) == 150


def test_client_fence_cache_survives_assignment_and_bootstrap():
    """Assigning any mapping to ``ord_fences`` gives a ``FenceCache`` with
    the same contents; a bootstrap refills the same object."""
    cl = _cluster(T, num_clients=1)
    client = cl.clients[0]
    client.ord_fences = {3: 30, 1: 10}
    assert isinstance(client.ord_fences, FenceCache)
    assert client.ord_fences == {3: 30, 1: 10}
    kv = cl.store(0)
    for k in range(80):
        kv.insert(k, [k])
    cache = client.ord_fences
    client.ord_fences.clear()
    assert [k for k, _v in kv.scan(0, 80)] == list(range(80))
    assert client.ord_fences is cache and len(cache) > 1
    _check_sorted_view(cache)


@pytest.mark.parametrize("case", ["empty", "duplicates", "high", "below"])
def test_locate_and_predict_chain_edges_match_reference(case):
    """``locate_leaves`` and ``_predict_chain`` on the same fences equal the
    reference's: duplicate lows inserted out of lid order, lows >= 2^63,
    starts below every low, an empty cache; then after a few changes."""
    fences = {
        "empty": {},
        "duplicates": {5: 10, 2: 10, 9: 10, 0: 0, 7: 40, 3: 40, 8: 25},
        "high": {0: 0, 4: 1 << 63, 2: M64 - 1, 6: (1 << 63) - 1, 1: M64},
        "below": {3: 100, 1: 200, 2: 200, 9: 1 << 63},
    }[case]
    ref_c = R.FuseeCluster(R.DMConfig(**CFG), num_clients=1).clients[0]
    port_c = _cluster(T, num_clients=1).clients[0]
    starts = [0, 5, 9, 10, 11, 25, 40, 99, 100, 200, 201, (1 << 63) - 1,
              1 << 63, M64 - 1, M64]
    for change in (None, (9, 40), (5, None), (11, 0), (2, M64)):
        if change is not None:
            lid, low = change
            for c in (ref_c, port_c):
                if low is None:
                    c.ord_fences.pop(lid, None)
                else:
                    c.ord_fences[lid] = low
        else:
            ref_c.ord_fences = dict(fences)
            port_c.ord_fences = dict(fences)
        assert port_c.ord_fences == ref_c.ord_fences
        assert TO.locate_leaves(port_c, starts) == \
            RO.locate_leaves(ref_c, starts)
        for head in list(ref_c.ord_fences) + [77]:
            for n in (1, 3, 50):
                assert TO._predict_chain(port_c, head, n) == \
                    RO._predict_chain(ref_c, head, n)


def test_locate_wave_union_matches_reference():
    """A wave whose clients disagree on a lid's low (a later row's low wins
    in the union) and know different lids, one row knowing none: the same
    hints as the reference's ``locate_wave``, in one probe."""
    fences = [{0: 0, 1: 100, 2: 200}, {},
              {0: 0, 1: 150, 3: 1 << 63, 2: 200},
              {2: 50, 4: M64 - 1, 5: 200}]
    keys = [[0, 99, 100, 149], [7], [150, 199, 200, (1 << 63) + 5],
            [49, 50, M64]]

    def run(M):
        cl = _cluster(M, num_clients=4, seed=1)
        fleet = cl.fleet()
        backends = [cl.store(c, max_inflight=0).backend for c in range(4)]
        for c, f in enumerate(fences):
            cl.clients[c].ord_fences = dict(f)
        wave = [(backends[c], [M.Op.scan(k, 2) for k in ks])
                for c, ks in enumerate(keys)]
        base = fleet.stats()["scan_locate_invocations"]
        hints = fleet.locate_wave(wave)
        assert fleet.stats()["scan_locate_invocations"] == base + 1
        return hints

    got = run(T)
    assert got == run(R)
    # lid 1's low is 150 (row 2 over row 0), lid 2's 50 (row 3 over 0, 2)
    assert got[2] == [1, 1, 5, 3]


# ----------------------------------------------------------- basic scans
def test_scan_returns_ordered_keys_and_values():
    def run(M):
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(60):
            assert kv.insert(k, [k * 3]).status == "OK"
        res = kv.scan(10, 20)
        assert [k for k, _ in res] == list(range(10, 30))
        assert all(v == [k * 3] for k, v in res)
        rng_ = kv.range(40, 45)
        assert [k for k, _ in rng_] == list(range(40, 45))
        return (res, rng_), cl
    _both(run)


def test_scan_count_clips_and_empty_ranges():
    def run(M):
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(10):
            kv.insert(k, [k])
        out = (kv.scan(7, 50), kv.scan(100, 5), kv.range(5, 5),
               kv.range(7, 3), kv.range(100, 200))
        assert [k for k, _ in out[0]] == [7, 8, 9]
        assert out[1:] == ([], [], [], [])
        return out, cl
    _both(run)


def test_delete_removes_from_scans_update_keeps():
    def run(M):
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(30):
            kv.insert(k, [k])
        kv.delete(11)
        kv.update(12, [999])
        res = kv.scan(10, 4)
        assert [k for k, _ in res] == [10, 12, 13, 14]
        assert dict(res)[12] == [999]
        return res, cl
    _both(run)


def test_scan_through_op_future_surface_and_byte_keys():
    def run(M):
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(20):
            kv.insert(k, bytes([k]) * 3)
        r = kv.submit(M.Op.scan(5, 4)).result()
        assert r.status == "OK"
        assert r.value == [(k, bytes([k]) * 3) for k in range(5, 9)]
        r2 = kv.submit(M.Op.range(5, 8)).result()
        assert [k for k, _ in r2.value] == [5, 6, 7]
        keys = [b"\xff\xfe", b"user:1", "caf\xe9", b"\x00" * 100]
        for i, k in enumerate(keys):
            assert kv.put(k, bytes([i + 1])).status == "OK"
        res = kv.scan(1 << 40, 10)
        assert [k for k, _ in res] == sorted(
            k for k in (M.codec.encode_key(k) for k in keys) if k >= 1 << 40)
        return (r.value, r2.value, res), cl
    _both(run)


def test_scan_disabled_raises_typed_before_any_op_is_accepted():
    for M in (R, T):
        cl = M.FuseeCluster(M.DMConfig(num_mns=2), num_clients=1, **_kw(M))
        kv = cl.store(0)
        with pytest.raises(M.OrderedIndexDisabled):
            kv.scan(0, 4)
        with pytest.raises(M.OrderedIndexDisabled):
            kv.submit_batch([M.Op.put(1, [1]), M.Op.scan(0, 10)])
        assert cl.scheduler.inflight(0) == 0
        assert kv.get(1) is None


def test_batched_scans_locate_in_one_probe():
    """Two or more scans in one batch share one locate call; their hints
    and results equal the reference's."""
    def run(M):
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(70):
            kv.insert(k, [k])
        futs = kv.submit_batch([M.Op.scan(3, 5), M.Op.range(30, 41),
                                M.Op.scan(66, 9)])
        out = [f.result().value for f in futs]
        assert kv.stats()["scan_locate_batches"] == 1
        assert kv.stats()["scans"] == 3
        return out, cl
    _both(run)


# ----------------------------------------------- splits under concurrency
def test_many_keys_force_splits_scan_complete():
    def run(M):
        cl = _cluster(M)
        kv = cl.store(0)
        n = 200
        for k in range(n):
            assert kv.insert(k, [k]).status == "OK"
        res = kv.scan(0, n)
        assert [k for k, _ in res] == list(range(n))
        keys = M.ordered.ordered_keys_direct(cl.pool)
        assert set(keys) >= set(range(n))
        return (res, keys), cl
    _both(run)


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_scan_spanning_split_in_flight(seed):
    def run(M):
        rng = np.random.default_rng(seed)
        cl = _cluster(M, num_clients=3, seed=seed)
        sched = cl.scheduler
        pre = 26
        for k in range(pre):
            sched.submit(0, "insert", k, [k])
        sched.run_round_robin()
        scan_rec = sched.submit(0, "scan", 0, 500)
        for c, k in ((1, 100), (2, 101), (1, 13), (2, 14)):
            sched.submit(c, "insert", 300 + k, [k])
        for k in range(40):
            sched.submit(1 + k % 2, "insert", pre + k, [pre + k])
        sched.run_random(rng=rng)
        res = scan_rec.result
        assert res.status == "OK"
        _sound(res.value, 0)
        got = dict(res.value)
        assert all(got.get(k) == [k] for k in range(pre))
        return res.value, cl
    _both(run)


def test_naive_and_batched_scans_agree():
    def run(M):
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(80):
            kv.insert(k, [k])
        sched, client = cl.scheduler, cl.clients[0]
        out = {}
        for mode in (True, False):
            rec = sched.submit(0, "scan", 15, 30,
                               gen=client.op_scan(15, 30, batched=mode))
            sched.run_round_robin()
            out[mode] = rec.result.value
        assert out[True] == out[False]
        assert [k for k, _ in out[True]] == list(range(15, 45))
        return out, cl
    _both(run)


# -------------------------------------------------------- crash + repair
@pytest.mark.parametrize("steps", [5, 17, 33, 61, 95])
def test_crash_mid_split_no_acked_insert_lost(steps):
    def run(M):
        cl = _cluster(M, num_clients=3, seed=steps)
        sched = cl.scheduler
        for k in range(24):
            sched.submit(1, "insert", k, [k])
        sched.run_round_robin()
        recs = [sched.submit(0, "insert", 24 + i, [24 + i])
                for i in range(12)]
        for _ in range(steps):
            if not sched.eligible_cids():
                break
            sched.step(0)
        cl.crash_client(0)
        cl.recover_client(0, reassign_to_cid=1)
        cl.drain()
        acked = [24 + i for i, r in enumerate(recs)
                 if r.result is not None and r.result.status == "OK"]
        res = cl.store(1).scan(0, 100)
        got = [k for k, _ in res]
        _sound(res, 0)
        assert not [k for k in list(range(24)) + acked if k not in got]
        kv1 = cl.store(1)
        for k, v in res:
            assert kv1.get(k) == v
        return (acked, res), cl
    _both(run)


def _arrays(cl):
    pool = cl.pool
    g = pool.ordered_regions[0]
    return [pool.mns[m].regions[g] for m in pool.placement[g]]


def _word(a, off) -> int:
    return int(a[off]) & M64


def _put(a, off, words):
    w = np.array([int(x) & M64 for x in words], np.uint64)
    if isinstance(a, torch.Tensor):
        a[off:off + len(w)] = torch.from_numpy(w.view(np.int64))
    else:
        a[off:off + len(w)] = w


def _leaf(M, a, i):
    lo = M.ordered.leaf_off(i)
    return M.ordered.parse_leaf([_word(a, o) for o in range(lo, lo + 16)])


def _drop_key(M, arrays, key):
    """Clear every entry equal to stored(key) in every replica."""
    O = M.ordered
    sv = O.stored(key)
    for a in arrays:
        n = _word(a, O.CURSOR_OFF)
        for i in range(n):
            for j in range(O.LEAF_ENTRIES):
                if _word(a, O.entry_off(i, j)) == sv:
                    _put(a, O.entry_off(i, j), [0])


def test_repair_reaps_unlinked_half_split_leaf():
    def run(M):
        O = M.ordered
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(20):
            kv.insert(k, [k])
        arrays = _arrays(cl)
        new_id = _word(arrays[0], O.CURSOR_OFF)
        words = O.build_leaf(low=7, ver=0, next_id=0, prev=0,
                             entries=[O.stored(999)])
        for a in arrays:
            _put(a, O.CURSOR_OFF, [new_id + 1])
            _put(a, O.leaf_off(new_id), words)
        before = kv.scan(0, 100)
        assert 999 not in [k for k, _ in before]
        O.repair_ordered(cl.pool)
        assert not _leaf(M, arrays[0], new_id)["valid"]
        after = kv.scan(0, 100)
        assert [k for k, _ in after] == list(range(20))
        return (before, after), cl
    _both(run)


def test_repair_rehomes_stranded_entries():
    def run(M):
        O = M.ordered
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(40):
            kv.insert(k, [k])
        arrays = _arrays(cl)
        kv.delete(5)
        assert 5 not in [k for k, _ in kv.scan(0, 100)]
        kv.insert(5, [50])
        _drop_key(M, arrays, 17)
        last = _word(arrays[0], O.CURSOR_OFF) - 1
        for a in arrays:
            _put(a, O.entry_off(last, O.LEAF_ENTRIES - 1), [O.stored(17)])
        O.repair_ordered(cl.pool)
        res = cl.store(0).scan(0, 100)
        assert 17 in [k for k, _ in res]
        _sound(res, 0)
        return res, cl
    _both(run)


def test_repair_salvages_acked_entries_from_primary_only_link():
    def run(M):
        O = M.ordered
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(20):
            kv.insert(k, [k])
        arrays = _arrays(cl)
        assert kv.insert(999, [9990]).status == "OK"
        sv = O.stored(999)
        _drop_key(M, arrays, 999)
        head = _leaf(M, arrays[0], 0)
        new_id = _word(arrays[0], O.CURSOR_OFF)
        words = O.build_leaf(low=head["low"] + 1, ver=0,
                             next_id=head["next"], prev=0, entries=[sv])
        for a in arrays:
            _put(a, O.CURSOR_OFF, [new_id + 1])
            _put(a, O.leaf_off(new_id), words)
        link = O.pack_meta(head["ver"] + 1, new_id,
                           O.leaf_crc(head["low"], head["prev"]))
        _put(arrays[0], O.leaf_off(0) + 1, [link])         # primary ONLY
        seen = [k for k, _ in kv.scan(0, 2000)]
        assert 999 in seen
        O.repair_ordered(cl.pool)
        cl.clients[0].ord_fences = {}
        got = [k for k, _ in cl.store(0).scan(0, 2000)]
        assert 999 in got and got == sorted(set(got))
        return (seen, got), cl
    _both(run)


def test_repair_rehomes_multiple_stranded_keys_across_split():
    def run(M):
        O = M.ordered
        cl = _cluster(M)
        kv = cl.store(0)
        for k in range(13):
            kv.insert(k, [k])
        for k in (50, 60):
            assert kv.insert(k, [k]).status == "OK"
        arrays = _arrays(cl)
        for key in (50, 60):
            _drop_key(M, arrays, key)
        head = _leaf(M, arrays[0], 0)
        new_id = _word(arrays[0], O.CURSOR_OFF)
        words = O.build_leaf(low=100, ver=0, next_id=head["next"], prev=0,
                             entries=[O.stored(50), O.stored(60)])
        link = O.pack_meta(head["ver"] + 1, new_id,
                           O.leaf_crc(head["low"], head["prev"]))
        for a in arrays:
            _put(a, O.CURSOR_OFF, [new_id + 1])
            _put(a, O.leaf_off(new_id), words)
            _put(a, O.leaf_off(0) + 1, [link])
        O.repair_ordered(cl.pool)
        cl.clients[0].ord_fences = {}
        got = [k for k, _ in cl.store(0).scan(0, 2000)]
        assert all(key in got for key in list(range(13)) + [50, 60])
        tail = [k for k, _ in cl.store(0).scan(14, 2000)]
        assert 60 in tail
        return (got, tail), cl
    _both(run)


def test_mn_crash_during_scans_recovers():
    def run(M):
        cl = _cluster(M, num_clients=2, seed=5)
        kv = cl.store(0)
        for k in range(60):
            kv.insert(k, [k])
        cl.crash_mn(2)
        res = kv.scan(0, 100)
        assert [k for k, _ in res] == list(range(60))
        return res, cl
    _both(run)


# ----------------------------------------------------- migration cutover
def test_scan_across_add_mn_cutover():
    def run(M):
        cl = _cluster(M, num_clients=4, seed=9, num_mns=2, replication=2,
                      index_shards=4)
        fleet = cl.fleet()
        sched = cl.scheduler
        backends = [cl.store(c, max_inflight=0).backend for c in range(4)]
        for k in range(120):
            sched.submit(k % 4, "insert", k, [k])
        fleet.run()
        futs = fleet.submit_wave(
            [(backends[c], [M.Op.scan(c * 7, 40)]) for c in range(4)])
        cl.add_mn(wait=False)
        fleet.run()
        if cl.migrator.busy:
            cl.migrator.drive()
        out = [fs[0].result().value for fs in futs]
        for c, v in enumerate(out):
            assert [k for k, _ in v] == list(range(c * 7, c * 7 + 40))
        g = cl.pool.ordered_regions[0]
        assert cl.migrator._handles["cutovers"].value >= 1
        final = cl.store(0).scan(0, 200)
        assert [k for k, _ in final] == list(range(120))
        return (out, final, cl.pool.placement[g]), cl, fleet
    _both(run)


# ------------------------------------------------------------ fleet mode
def test_fleet_locate_wave_single_invocation():
    def run(M):
        cl = _cluster(M, num_clients=8, seed=3)
        fleet = cl.fleet()
        sched = cl.scheduler
        backends = [cl.store(c, max_inflight=0).backend for c in range(8)]
        for k in range(100):
            sched.submit(k % 8, "insert", k, [k])
        fleet.run()
        fleet.submit_wave([(backends[c], [M.Op.scan(0, 4)])
                           for c in range(8)])
        fleet.run()
        base = fleet.stats()["scan_locate_invocations"]
        futs = fleet.submit_wave(
            [(backends[c], [M.Op.scan(c * 9, 6), M.Op.scan(c * 3, 2)])
             for c in range(8)])
        st = fleet.stats()
        assert st["scan_locate_invocations"] == base + 1
        assert st["scan_locate_keys"] >= 16
        fleet.run()
        out = [[f.result().value for f in fs] for fs in futs]
        for c, v in enumerate(out):
            assert [k for k, _ in v[0]] == list(range(c * 9, c * 9 + 6))
        assert fleet.stats()["ord_leaf_verbs"] > 0
        return out, cl, fleet
    _both(run)


# ------------------------------------------------------------ scan storm
def _scan_storm(M, seed):
    """``tests/test_ordered.py``'s scan storm (one seed): client and MN
    crashes under mixed scan/insert fleet traffic, then recovery and a
    quiescent scan."""
    cl = _cluster(M, num_clients=6, seed=seed, num_mns=4, replication=2,
                  mn_detect_delay=2)
    fleet = cl.fleet()
    sched = cl.scheduler
    backends = {c: cl.store(c, max_inflight=0).backend for c in range(6)}
    for k in range(60):
        sched.submit(k % 6, "insert", k, [k])
    fleet.run()
    plan = M.FaultPlan.storm(cl.rng.stream("faults"), clients=range(6),
                             mns=4, replication=2, n_client_crashes=2,
                             n_mn_crashes=1, first_op=80, spacing=24,
                             recover_delay=12)
    cl.inject(plan)
    wl = cl.rng.stream("workload")
    fresh, futs, scans = 60, [], []
    for _wave in range(30):
        wave = []
        for c in range(6):
            if cl.clients.get(c) is None or cl.clients[c].crashed:
                continue
            if sched.inflight(c) >= 4:
                continue
            if wl.random() < 0.3:
                op = M.Op.insert(fresh, [fresh])
                futs.append((fresh, backends[c].submit_many([op])[0]))
                fresh += 1
            else:
                start = int(wl.integers(fresh))
                wave.append((backends[c],
                             [M.Op.scan(start, 1 + int(wl.integers(40)))]))
        if wave:
            try:
                scans += [fs[0] for fs in fleet.submit_wave(wave)]
            except M.ClientCrashed:
                pass
        fleet.tick()
    fleet.run()
    for c in range(6):
        cli = cl.clients.get(c)
        if cli is not None and cli.crashed:
            cl.recover_client(c)
    cl.drain()
    acked = sorted(k for k, f in futs
                   if f.done() and f.result().status == "OK")
    live = next(c for c in range(6) if cl.clients.get(c) is not None
                and not cl.clients[c].crashed)
    final = cl.store(live).scan(0, 10_000)
    keys = [k for k, _ in final]
    assert not [k for k in acked if k not in keys]
    assert keys == sorted(set(keys))
    done = [f.result().value for f in scans
            if f.done() and f.result().status == "OK"]
    for v in done:
        ks = [k for k, _ in v]
        assert ks == sorted(set(ks))
    return (acked, final, done), cl, fleet


def test_scan_storm_matches_reference():
    _both(_scan_storm, 0)


def test_ycsbe_crash_mid_split_matches_reference():
    """``_torch_parity.ycsbe_crash_scenario`` (the run ``chip_smoke.py``
    compares on cuda and cpu): a client crashed inside a leaf split under
    YCSB-E fleet traffic, recovered; equal on both packages, audit holds."""
    from _torch_parity import ycsbe_crash_audit, ycsbe_crash_scenario

    def run(M):
        cl, fleet, crash, futs = ycsbe_crash_scenario(M, **_kw(M))
        assert crash is not None
        audit = ycsbe_crash_audit(M, cl, futs)
        return (crash, audit, [(f.result().status, f.result().value)
                               for f in futs]), cl, fleet
    _both(run)


# ------------------------------------------------------ keydir drop regime
def _ycsbe_small(M, n_clients, n_keys, sparse_fences):
    from benchmarks.common import fleet_dmconfig
    from _torch_parity import port_config, ycsbe_small_run
    cfg = fleet_dmconfig(n_clients, n_keys, n_mns=5, replication=2,
                         ordered=True)
    return ycsbe_small_run(M, cfg if M is R else port_config(cfg),
                           n_clients=n_clients, n_keys=n_keys,
                           ops_per_client=2, sparse_fences=sparse_fences,
                           **_kw(M))


@pytest.mark.parametrize("n_clients,n_keys,sparse_fences", [
    (64, 500, False),     # racing splitters' leaked leaves fill the region
    (16, 1000, True),     # locates give up after MAX_ORD_RETRIES moves
])
def test_ycsbe_drop_regime_matches_reference(n_clients, n_keys,
                                             sparse_fences):
    """``chip_smoke.py``'s YCSB-E traffic where the keydir protocol loses
    acknowledged inserts (``_split`` or ``_locate`` gives up,
    ``ord_ensure`` returns FULL, the INSERT still acks) and scans come back
    NOT_FOUND: the port loses the same keys and scans as the reference —
    equal results, equal ``ord_full_drops``, equal ``signature()`` — and
    the audit ``chip_smoke.py`` applies holds on both."""
    audit, _results = _both(_ycsbe_small, n_clients, n_keys, sparse_fences)
    assert audit["drops"] > 0
    if sparse_fences:
        assert audit["not_found"] > 0
