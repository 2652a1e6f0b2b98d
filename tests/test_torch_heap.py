"""The port's ``DMPool`` (one int64 slab tensor) against the JAX package's
(one uint64 numpy slab), on the CPU.

The same bytes are loaded into both pools (``load_numpy_state``), the same
verbs run through both, and every result and the whole slab must agree
exactly: scalar verbs, ``*_batch`` verbs, and ``exec_fused_tick`` replaying
the ledger that ``benchmarks/roofline.py::capture_ledger`` records from a
fleet YCSB-A run, plus ticks with same-word CAS/FAA races, overlapping
same-tick writes and a dead MN.
"""
import numpy as np
import pytest
import torch

from benchmarks.roofline import capture_ledger
from repro.core import DMConfig, DMPool
from repro_torch.core import DMConfig as PortConfig
from repro_torch.core import DMPool as PortPool
from repro_torch.core.heap import MemoryNode, RegionSlab

from _torch_parity import (assert_same_typed, norm, norm_list,
                           port_pool_like, ref_state, slab_u64)

M64 = (1 << 64) - 1


def _pair(seed=0, **cfg):
    ref = DMPool(DMConfig(**cfg), num_clients=8, seed=seed)
    return ref, port_pool_like(ref)


def _assert_same_pools(ref, port):
    assert np.array_equal(slab_u64(ref), slab_u64(port))
    assert np.array_equal(ref.mn_bytes, port.mn_bytes)
    assert ref.placement == port.placement
    for a, b in zip(ref.mns, port.mns):
        assert sorted(a.regions) == sorted(b.regions)
        for g in a.regions:
            assert np.array_equal(a.regions[g],
                                  b.regions[g].numpy().view(np.uint64))


def _replay(ref, port, tick):
    """One tick through both pools; results must agree value and type."""
    want = ref.exec_fused_tick(*tick)
    got = port.exec_fused_tick(*tick)
    for w, g in zip(want, got):
        assert norm_list(w) == norm_list(g)
        assert_same_typed(w, g)
    return want


# ------------------------------------------------------------ ledger replay
@pytest.fixture(scope="module")
def ledger():
    cl, led = capture_ledger(16, ops_per_client=4)
    return cl, led


def test_ledger_replay_matches_reference(ledger):
    """Every recorded fused tick of a fleet YCSB-A run, replayed against the
    same starting bytes, gives the same results and the same slab."""
    cl, led = ledger
    assert len(led) > 20
    ref = cl.pool
    port = port_pool_like(ref)
    for tick in led:
        _replay(ref, port, tick)
    _assert_same_pools(ref, port)


def test_ledger_replay_with_dead_mn(ledger):
    cl, led = ledger
    ref2 = cl.pool
    port2 = port_pool_like(ref2)
    dead = ref2.placement[0][0]         # the index primary: its READs FAIL
    ref2.crash_mn(dead)
    port2.crash_mn(dead)
    fails = 0
    for tick in led[:40]:
        out = _replay(ref2, port2, tick)
        fails += sum(x is None for x in out[0])
    assert fails > 0
    _assert_same_pools(ref2, port2)


def _coords(pool, n, rng, region=None):
    regions = [region if region is not None else
               int(rng.choice(sorted(pool.placement))) for _ in range(n)]
    replicas = [int(rng.integers(len(pool.placement[g]))) for g in regions]
    return regions, replicas


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fused_tick_races_and_overlaps(seed):
    """Same-word CAS and FAA races (serialised in input order), overlapping
    same-tick writes (landing in the batch twin's group order), words at
    and above 2^63, zero-length verbs and a dead MN, in one tick."""
    rng = np.random.default_rng(seed)
    ref, port = _pair(seed=seed, num_mns=4, region_words=1 << 12,
                      regions_per_mn=2)
    dead = int(rng.integers(4))
    ref.crash_mn(dead)
    port.crash_mn(dead)
    g = int(sorted(ref.placement)[3])
    # writes: overlapping ranges of mixed lengths in one region, plus
    # scattered ones; huge words and FAIL-pattern words included
    w_regions, w_reps = _coords(ref, 24, rng, region=g)
    w_offs = [int(o) for o in rng.integers(0, 64, 24)]
    words = [[int(v) for v in rng.integers(0, 1 << 64, int(m),
                                           dtype=np.uint64)]
             for m in rng.integers(0, 9, 24)]
    words[0] = [M64, 1 << 63, (1 << 32) - 1, 1 << 32]
    writes = (w_regions, w_reps, w_offs, words)
    # reads overlap the writes (reads see the pre-write slab)
    r_regions, r_reps = _coords(ref, 20, rng, region=g)
    reads = (r_regions, r_reps, [int(o) for o in rng.integers(0, 64, 20)],
             [int(m) for m in rng.integers(0, 6, 20)])
    # CAS: several verbs on the same word, some hitting
    c_offs = [int(o) for o in rng.integers(0, 12, 30)]
    c_regions, c_reps = _coords(ref, 30, rng, region=g)
    exps = [int(v) for v in rng.integers(0, 3, 30)]
    news = [int(v) for v in rng.integers(0, 1 << 64, 30, dtype=np.uint64)]
    exps[:3] = [0, 0, 0]
    cass = (c_regions, c_reps, c_offs, exps, news)
    f_offs = [int(o) for o in rng.integers(0, 8, 20)]
    f_regions, f_reps = _coords(ref, 20, rng, region=g)
    deltas = [int(v) for v in rng.integers(0, 1 << 64, 20, dtype=np.uint64)]
    deltas[0] = M64                             # wraps around
    faas = (f_regions, f_reps, f_offs, deltas)
    assert len(set(zip(c_reps, c_offs))) < len(c_offs)      # CAS races
    assert len(set(zip(f_reps, f_offs))) < len(f_offs)      # FAA races
    spans = [(r, o, o + len(w)) for r, o, w in zip(w_reps, w_offs, words)
             if w]
    assert any(r1 == r2 and a1 < b2 and a2 < b1                # overlaps
               for i, (r1, a1, b1) in enumerate(spans)
               for (r2, a2, b2) in spans[i + 1:])
    for _ in range(3):
        _replay(ref, port, (reads, writes, cass, faas))
    _assert_same_pools(ref, port)


# ------------------------------------------------------------- plain verbs
def test_scalar_verbs_match_reference():
    ref, port = _pair(num_mns=3)
    g = 2
    vals = [M64, 1 << 63, (1 << 63) - 1, 0, 5]
    for p in (ref, port):
        assert p.write(g, 0, 10, vals) is True
    assert norm(ref.read(g, 0, 9, 7)) == norm(port.read(g, 0, 9, 7))
    assert_same_typed([ref.read(g, 0, 9, 7)], [port.read(g, 0, 9, 7)])
    for exp, new in ((M64, 3), (M64, 4), (3, 1 << 63)):
        a, b = ref.cas(g, 0, 10, exp, new), port.cas(g, 0, 10, exp, new)
        assert int(a) == int(b) and type(a) is type(b)
    for d in (1, M64, 1 << 63):
        a, b = ref.faa(g, 0, 11, d), port.faa(g, 0, 11, d)
        assert int(a) == int(b) and type(a) is type(b)
    dead = ref.placement[g][0]
    ref.crash_mn(dead)
    port.crash_mn(dead)
    assert port.read(g, 0, 0, 1) is None and ref.read(g, 0, 0, 1) is None
    assert port.write(g, 0, 0, [1]) is False
    assert port.cas(g, 0, 0, 0, 1) is None and port.faa(g, 0, 0, 1) is None
    _assert_same_pools(ref, port)


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_verbs_match_reference(seed):
    rng = np.random.default_rng(seed)
    ref, port = _pair(seed=seed, num_mns=3, region_words=1 << 12)
    g = sorted(ref.placement)[2]
    regions, reps = _coords(ref, 16, rng, region=g)
    offs = [int(o) for o in rng.integers(0, 30, 16)]
    words = [[int(v) for v in rng.integers(0, 1 << 64, int(m),
                                           dtype=np.uint64)]
             for m in rng.integers(0, 6, 16)]
    for name, args in (
            ("write_batch", (regions, reps, offs, words)),
            ("read_batch", (regions, reps, offs, [4] * 16)),
            ("cas_batch", (regions, reps, [o % 5 for o in offs],
                           [0] * 16, list(range(1, 17)))),
            ("faa_batch", (regions, reps, [o % 4 for o in offs],
                           [M64] * 16)),
            ("cas_batch", (regions, reps, offs, [0] * 16,
                           list(range(16))))):
        a = getattr(ref, name)(*args)
        b = getattr(port, name)(*args)
        assert norm_list(a) == norm_list(b), name
        assert_same_typed(a, b)
    _assert_same_pools(ref, port)


@pytest.mark.parametrize("seed", [0, 1])
def test_read_batch_is_one_ragged_fleet_read(seed, monkeypatch):
    """``read_batch`` over several regions, ragged and zero lengths and a
    dead MN matches the reference and is one ``fleet_read`` call."""
    import repro_torch.core.heap as heap
    calls = []
    orig = heap.fleet_read
    monkeypatch.setattr(heap, "fleet_read",
                        lambda *a: calls.append(a[3]) or orig(*a))
    rng = np.random.default_rng(seed)
    ref, port = _pair(seed=seed, num_mns=4, region_words=1 << 12)
    rw = [int(v) for v in rng.integers(0, 1 << 64, 64, dtype=np.uint64)]
    for p in (ref, port):
        for g in sorted(p.placement):
            p.write(g, 0, 0, rw)
            p.write(g, 1, 0, rw[::-1])
    dead = int(rng.integers(4))
    ref.crash_mn(dead)
    port.crash_mn(dead)
    regions, reps = _coords(ref, 40, rng)
    offs = [int(o) for o in rng.integers(0, 40, 40)]
    ns = [int(m) for m in rng.integers(0, 20, 40)]
    ns[:2] = [0, 0]
    want, got = ref.read_batch(regions, reps, offs, ns), \
        port.read_batch(regions, reps, offs, ns)
    assert norm_list(want) == norm_list(got)
    assert_same_typed(want, got)
    assert any(x is None for x in got) and calls == [
        sum(len(x) for x in got if x is not None)]
    _assert_same_pools(ref, port)


def test_alloc_free_and_recovery_rehome_match_reference():
    ref, port = _pair(num_mns=4, region_words=1 << 12)
    for cid in range(6):
        mid = cid % 4
        assert ref.alloc_block(mid, cid) == port.alloc_block(mid, cid)
    g, b = ref.alloc_block(1, 9)
    assert port.alloc_block(1, 9) == (g, b)
    assert ref.free_block(1, g, b) == port.free_block(1, g, b)
    dead = ref.placement[g][0]
    for p in (ref, port):
        p.crash_mn(dead)
        alive = [m.mid for m in p.mns if m.alive]
        survivors = [m for m in p.placement[g] if p.mns[m].alive]
        extra = [m for m in alive if m not in survivors][:1]
        p.recover_mn_placement(g, survivors + extra)
    _assert_same_pools(ref, port)
    assert [m.cpu_ops for m in ref.mns] == [m.cpu_ops for m in port.mns]


# -------------------------------------------------------- slab and devices
def test_slab_growth_rebinds_views():
    slab = RegionSlab(16, capacity=1)
    mn = MemoryNode(0, PortConfig(region_words=16), slab)
    mn.host_region(5)
    mn.regions[5][3] = 7
    mn.host_region(6)                          # grows the slab
    assert slab.capacity == 2
    assert int(mn.regions[5][3]) == 7
    mn.regions[5][4] = 9
    assert int(slab.buf[slab.cells[(0, 5)] * 16 + 4]) == 9


def test_load_numpy_state_round_trip():
    ref, port = _pair(num_mns=3)
    ref.write(2, 0, 1, [M64, 1 << 63])
    port.load_numpy_state(slab_words=ref.slab.buf.copy(),
                          cells=dict(ref.slab.cells),
                          placement=ref.placement, mn_bytes=ref.mn_bytes)
    _assert_same_pools(ref, port)
    with pytest.raises(ValueError):
        port.load_numpy_state(slab_words=ref.slab.buf[:-1],
                              cells={}, placement={})


def test_pool_device_contract():
    """``device=None`` means CUDA and never silently drops to the CPU."""
    cfg = PortConfig(num_mns=2)
    if torch.cuda.is_available():
        assert PortPool(cfg).slab.buf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PortPool(cfg)
    assert PortPool(cfg, device="cpu").slab.buf.device.type == "cpu"
    # the ordered keydir builds: its region, placement and initial leaf
    # (cursor 1, head leaf of low 0) equal the reference pool's
    ref = DMPool(DMConfig(num_mns=3, ordered_index=True))
    port = PortPool(PortConfig(num_mns=3, ordered_index=True), device="cpu")
    assert port.ordered_regions == ref.ordered_regions == [ref.num_regions - 1]
    _assert_same_pools(ref, port)
    port.load_numpy_state(**ref_state(ref))
    _assert_same_pools(ref, port)
