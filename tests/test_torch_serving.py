"""The port's serving pool held bit for bit against the JAX package's:
slot packing and hashes, the SNAPSHOT epoch (fed the reference's CAS
arrival draws), a seeded ``KVPool`` op sequence, and ``DeviceBackend``
behind ``KVStore``.

The reference draws each epoch's per-replica arrival priorities from
``jax.random``, which torch cannot reproduce; the port takes them as an
argument.  ``FedPool`` overrides the port pool's draw with the reference
pool's own key sequence, so both pools take the same decisions and must
end in identical state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import KVStore as RefStore, Op as RefOp
from repro.serving import slots_jax as RS
from repro.serving.backend import DeviceBackend as RefBackend
from repro.serving.kvpool import KVPool as RefPool, PoolConfig as RefCfg
from repro.serving.snapshot_jax import (snapshot_epoch as ref_epoch,
                                        snapshot_epoch_np as ref_epoch_np)
from repro_torch.core.api import KVStore, Op
from repro_torch.serving import (DeviceBackend, PoolConfig, slots as PS,
                                 snapshot_epoch, snapshot_epoch_np)
from repro_torch.serving.kvpool import KVPool

EDGE_KEYS = np.array([0, 1, 2 ** 31 - 1, -2 ** 31, -1, 12345, 7],
                     np.int32)


class FedPool(KVPool):
    """A CPU port pool whose epochs take the JAX pool's arrival draws."""

    def __init__(self, cfg, seed=0):
        super().__init__(cfg, seed=seed, device="cpu")
        self.key = jax.random.PRNGKey(seed)

    def _draw_prios(self, n_writers):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(
            k, (self.cfg.replicas, n_writers))))


def _u32(keys):
    return torch.from_numpy(keys.astype(np.int64) & 0xFFFFFFFF)


# ------------------------------------------------------------ slots, hashes
def test_slot_packing_and_hashes_bit_identical():
    rng = np.random.default_rng(0)
    keys = np.concatenate([EDGE_KEYS, rng.integers(-2 ** 31, 2 ** 31, 2000)
                           .astype(np.int32)])
    kj = jnp.asarray(keys)
    for seed in (1, 2, 7):
        assert np.array_equal(np.asarray(RS.hash32(kj, seed), np.int64),
                              PS.hash32(_u32(keys), seed).numpy())
    for nb in (1, 2, 64, 1000):
        r1, r2 = RS.bucket_pair(kj, nb)
        t1, t2 = PS.bucket_pair(_u32(keys), nb)
        assert np.array_equal(np.asarray(r1), t1.numpy())
        assert np.array_equal(np.asarray(r2), t2.numpy())
    fp = np.array(RS.fingerprint(kj))
    assert np.array_equal(fp, PS.fingerprint32(_u32(keys)).numpy())
    ptr = rng.integers(0, 1 << 24, len(keys)).astype(np.int32)
    ptr[:3] = [0, (1 << 24) - 1, 1]
    packed = np.asarray(RS.pack_slot(jnp.asarray(fp), jnp.asarray(ptr)))
    got = PS.pack_slot(torch.from_numpy(fp), torch.from_numpy(ptr))
    assert got.dtype == torch.int32
    assert np.array_equal(packed, got.numpy())
    assert np.array_equal(packed, PS.pack_slot_np(fp, ptr))
    assert np.array_equal(np.asarray(RS.slot_fp(jnp.asarray(packed))),
                          PS.slot_fp(got).numpy())
    assert np.array_equal(np.asarray(RS.slot_ptr(jnp.asarray(packed))),
                          PS.slot_ptr(got).numpy())
    assert np.array_equal(RS.slot_fp_np(packed), PS.slot_fp_np(packed))
    assert np.array_equal(RS.slot_ptr_np(packed), PS.slot_ptr_np(packed))


# ---------------------------------------------------------- SNAPSHOT epoch
def _epoch_case(trial, r, W, stale, contended):
    """tests/test_serving.py's epoch inputs (invariant and oracle trials)."""
    rng = np.random.default_rng(trial)
    M = 16 if contended else 32
    if contended:
        base = np.zeros(M, np.int32)
        slot = rng.integers(0, 4, W).astype(np.int32)
    else:
        base = (rng.integers(0, 3, M).astype(np.int32)) * 7
        slot = rng.integers(-1, M, W).astype(np.int32)
    index = np.tile(base, (r, 1))
    v_old = base[np.maximum(slot, 0)].astype(np.int32)
    if stale and W:
        v_old[0] += 1  # a writer with a stale read
    v_new = (rng.permutation(1000)[:W] + 10).astype(np.int32)
    return index, slot, v_old, v_new


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("contended", [False, True])
def test_snapshot_epoch_bit_identical_with_fed_prios(r, contended):
    for trial in range(24):
        W = 1 + trial % 12
        index, slot, v_old, v_new = _epoch_case(trial * 7 + r, r, W,
                                                stale=trial % 3 == 0,
                                                contended=contended)
        key = jax.random.PRNGKey(trial)
        want = ref_epoch(jnp.asarray(index), jnp.asarray(slot),
                         jnp.asarray(v_old), jnp.asarray(v_new), key)
        prios = torch.from_numpy(np.array(jax.random.uniform(key, (r, W))))
        got = snapshot_epoch(torch.from_numpy(index), torch.from_numpy(slot),
                             torch.from_numpy(v_old), torch.from_numpy(v_new),
                             prios)
        for name, a, b in zip(("index", "win", "committed", "rule"),
                              want, got):
            assert np.array_equal(np.asarray(a), b.numpy()), (trial, name)
        # the sequential oracle is the reference's, copied
        order = [list(np.random.default_rng(trial).permutation(W))
                 for _ in range(r)]
        for a, b in zip(ref_epoch_np(index, slot, v_old, v_new, order),
                        snapshot_epoch_np(index, slot, v_old, v_new, order)):
            assert np.array_equal(a, b)


def test_snapshot_epoch_single_winner_per_contended_slot():
    """Equal priorities on one slot go to the lowest writer: still exactly
    one winner, and the replicas converge."""
    index = torch.zeros((3, 8), dtype=torch.int32)
    slot = torch.tensor([2, 2, 2, 5], dtype=torch.int32)
    v_new = torch.tensor([11, 12, 13, 14], dtype=torch.int32)
    res = snapshot_epoch(index, slot, torch.zeros(4, dtype=torch.int32),
                         v_new, torch.full((3, 4), 0.5))
    assert res.win.tolist() == [True, False, False, True]
    assert (res.index[:, 2] == 11).all() and (res.index[:, 5] == 14).all()


# ------------------------------------------------------------------- pool
POOL = dict(n_pages=512, n_buckets=128, slots_per_bucket=4, replicas=3)


def _assert_same_pool(ref, port):
    for name in ("index", "log", "chain", "free_bitmap"):
        assert np.array_equal(np.asarray(getattr(ref, name)),
                              getattr(port, name).numpy()), name
    assert np.array_equal(ref.grant, port.grant)
    assert np.array_equal(ref.shard_of_chunk, port.shard_of_chunk)
    assert np.array_equal(ref.cursor, port.cursor)
    assert ref.cfg.n_shards == port.cfg.n_shards
    assert ref.stats == port.stats
    assert ({c: vars(s) for c, s in ref.slabs.items()}
            == {c: vars(s) for c, s in port.slabs.items()})


def _pool_sequence(pool):
    """insert, search, delete, concurrent writers, alloc/free/reclaim,
    crash + recovery with redo, add_shard, upserts; returns every result."""
    out = []
    keys = np.arange(100, 300).astype(np.int32)
    pages = pool.alloc_pages(0, len(keys))
    pool.write_pages(0, pages, keys, opcode=1)
    out.append(pool.insert_batch(0, keys, pages))
    out.append(pool.search(keys))
    out.append(pool.delete_batch(0, keys[:50]))
    out.append(pool.search(keys))
    pg1 = pool.alloc_pages(1, 32)                  # two clients race
    pg2 = pool.alloc_pages(2, 32)
    pool.write_pages(1, pg1, keys[60:92], opcode=1)
    pool.write_pages(2, pg2, keys[60:92], opcode=1)
    out += [pool.insert_batch(1, keys[60:92], pg1),
            pool.insert_batch(2, keys[60:92], pg2)]
    pool.free_pages(pg1[:10])
    out.append(pool.reclaim(1))
    crashed = pool.alloc_pages(3, 40)              # crash before the insert
    pool.write_pages(3, crashed, keys[:40], opcode=1)
    pool.crash_client(3)
    out.append(pool.recover_client(3, reassign_to=2))
    out.append(pool.recover_client(2))             # idempotent
    out.append(pool.add_shard())
    up = pool.alloc_pages(7, 30)                   # upserts after scale-out
    pool.write_pages(7, up, keys[150:180], opcode=2)
    out.append(pool.insert_batch(7, keys[150:180], up, opcode=2))
    out.append(pool.search(np.arange(90, 310).astype(np.int32)))
    out.append(pool.check_replicas_converged())
    return out


def _flat(x):
    if isinstance(x, tuple):
        return [_flat(v) for v in x]
    return np.asarray(x).tolist() if isinstance(x, np.ndarray) else x


def test_pool_op_sequence_identical_state():
    ref = RefPool(RefCfg(**POOL), seed=0)
    port = FedPool(PoolConfig(**POOL), seed=0)
    assert [_flat(x) for x in _pool_sequence(ref)] == \
        [_flat(x) for x in _pool_sequence(port)]
    _assert_same_pool(ref, port)


def test_pool_draws_its_own_arrival_order():
    """Without fed draws the pool uses its own seeded generator: the same
    seed gives the same pool, and every key still lands once."""
    a, b = (KVPool(PoolConfig(**POOL), seed=3, device="cpu")
            for _ in range(2))
    res = [_flat(x) for x in _pool_sequence(a)]
    assert res == [_flat(x) for x in _pool_sequence(b)]
    assert torch.equal(a.index, b.index)
    assert res[-1] is True


def test_pool_needs_a_device_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        KVPool(PoolConfig(**POOL))


# ---------------------------------------------------------------- backend
def _store_ops(Op_):
    keys = [f"k{i}" for i in range(24)] + [b"\xff\x00", 7, 2 ** 63]
    return [
        [Op_.insert(k, f"v{i}".encode()) for i, k in enumerate(keys)],
        [Op_.get(k) for k in keys] + [Op_.get("missing")],
        [Op_.update("k3", b"new"), Op_.update("k3", b"newer"),
         Op_.insert("k4", None)],
        [Op_.delete(k) for k in keys[:6]] + [Op_.delete("missing")],
        [Op_.get(k) for k in keys[:10]],
        [Op_.reclaim()],
        [Op_.put(k, b"again") for k in keys[:8]] + [Op_.get("k1")],
    ]


def _results(store, batches):
    out = []
    for batch in batches:
        out.append([(r.status, r.page, r.value) for r in
                    (f.result() for f in store.submit_batch(batch))])
    return out


def test_device_backend_through_kvstore_matches_reference():
    ref_b = RefBackend(pool=RefPool(RefCfg(**POOL), seed=1))
    port_b = DeviceBackend(pool=FedPool(PoolConfig(**POOL), seed=1))
    want = _results(RefStore(ref_b), _store_ops(RefOp))
    got = _results(KVStore(port_b), _store_ops(Op))
    assert got == want
    _assert_same_pool(ref_b.pool, port_b.pool)
    assert port_b.stats() == {k: v for k, v in ref_b.stats().items()}


def test_device_backend_scan_and_range_raise():
    store = KVStore(DeviceBackend(PoolConfig(**POOL), device="cpu"))
    store.put("a", b"1")
    with pytest.raises(NotImplementedError, match="A6"):
        store.scan(0, 5)
    with pytest.raises(NotImplementedError, match="A6"):
        store.range(0, 100)
