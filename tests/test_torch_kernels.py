"""The port's two kernels against the JAX package, on the CPU.

* RACE probe: ``hash32``, ``build_shadow`` and the plain ``race_lookup`` of
  ``repro_torch`` against ``repro.core.shadow``, ``race_lookup_ref`` and the
  Pallas kernel ``race_lookup_fwd`` in interpret mode, at the shapes of
  ``tests/test_kernels.py`` plus the edge keys 0, 2^31 and 2^32-1.
* Fused-tick READ sweep: the plain ``fleet_read`` against ``fleet_read_ref``,
  ``fleet_read_fwd`` in interpret mode and ``DMPool._fused_read_sweep`` of a
  live reference pool.

Integer paths: tolerance 0.  The CUDA launches are in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shadow as ref_shadow
from repro.kernels.fleet_tick.kernel import fleet_read_fwd
from repro.kernels.fleet_tick.ref import fleet_read_ref
from repro.kernels.race_lookup.kernel import race_lookup_fwd
from repro.kernels.race_lookup.ref import race_lookup_ref
from repro_torch.core import shadow as port_shadow
from repro_torch.kernels import (KERNELS, fleet_read, fleet_read_plain,
                                 race_lookup, race_lookup_plain,
                                 reset_launches)

from _torch_parity import port_pool_like

EDGE_KEYS = np.array([0, 1 << 31, (1 << 32) - 1, (1 << 31) - 1, 1],
                     np.uint32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _table_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------- RACE probe
@pytest.mark.parametrize("seed", [1, 2, 5, 7])
def test_hash32_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([EDGE_KEYS, rng.integers(0, 1 << 32, 4096,
                                                dtype=np.uint64)
                        .astype(np.uint32)])
    want = ref_shadow.hash32_np(x, seed)
    got = port_shadow.hash32(_t(x), seed).numpy()
    assert got.dtype == np.int64 and (got >= 0).all()
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("n,spb,min_buckets", [
    (0, 8, 16), (1, 8, 16), (300, 8, 16), (5000, 8, 16), (777, 4, 2),
    (2000, 1, 2), (64, 16, 16)])
def test_build_shadow_matches_reference(n, spb, min_buckets):
    rng = np.random.default_rng(n + spb)
    keys = np.concatenate([EDGE_KEYS, rng.integers(0, 1 << 32, n,
                                                   dtype=np.uint64)
                           .astype(np.uint32)])[:n]
    want = ref_shadow.build_shadow(keys, spb=spb, min_buckets=min_buckets)
    got = port_shadow.build_shadow(_t(keys), spb=spb,
                                   min_buckets=min_buckets)
    assert got.dtype == torch.int32
    assert got.shape == want.shape
    assert np.array_equal(_table_u32(got), want)


def _probe_keys(n_keys, stored, rng, block=128):
    q = np.concatenate([EDGE_KEYS, stored[: n_keys // 2],
                        rng.integers(0, 1 << 32, n_keys, dtype=np.uint64)
                        .astype(np.uint32)])
    pad = -len(q) % block
    return np.concatenate([q, stored[:pad]])


@pytest.mark.parametrize("nb,spb,n_keys", [(256, 8, 512), (1024, 4, 1024),
                                           (128, 16, 256)])
def test_race_lookup_plain_matches_reference(nb, spb, n_keys):
    """The port's plain probe (the CPU path of ``race_lookup``) against the
    numpy mirror, the jnp oracle and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(nb + spb)
    stored = np.concatenate([EDGE_KEYS[:3], np.arange(1, n_keys + 1,
                                                      dtype=np.uint32)])
    table = ref_shadow.build_shadow(stored, spb=spb, min_buckets=nb)
    q = _probe_keys(n_keys, stored, rng)
    p_np, f_np = ref_shadow.race_lookup_np(q, table)
    p_t, f_t = race_lookup(_t(q), torch.from_numpy(table.view(np.int32)))
    assert p_t.dtype == torch.int32 and f_t.dtype == torch.bool
    assert np.array_equal(p_t.numpy().view(np.uint32), p_np)
    assert np.array_equal(f_t.numpy(), f_np)
    assert f_t[:3].all(), "stored edge keys must be found"
    kj = jnp.asarray(q.view(np.int32))
    ij = jnp.asarray(table.view(np.int32))
    for p_j, f_j in (race_lookup_ref(kj, ij),
                     race_lookup_fwd(kj, ij, block_keys=128,
                                     interpret=True)):
        assert np.array_equal(np.asarray(p_j), p_t.numpy())
        assert np.array_equal(np.asarray(f_j), f_t.numpy())


def test_race_lookup_wrapper_cpu_path_launches_nothing():
    reset_launches()
    keys = _t(EDGE_KEYS)
    table = port_shadow.build_shadow(keys)
    ptr, found = race_lookup(keys, table)
    assert found.all()
    assert race_lookup.launches == 0 and fleet_read.launches == 0
    assert set(KERNELS) == {race_lookup, fleet_read}
    with pytest.raises(TypeError):
        race_lookup(keys.to(torch.int32), table)
    with pytest.raises(ValueError):
        race_lookup(keys[:, None], table)


# ------------------------------------------------------ fused-tick READ sweep
def _slab(rng, n_cells, region_words):
    slab = rng.integers(0, 1 << 64, size=n_cells * region_words,
                        dtype=np.uint64)
    slab[::7] = (1 << 32) - 1                        # 32-bit boundary words
    slab[::11] = 1 << 32
    slab[::13] = (1 << 63) + np.arange(0, slab.size, 13, dtype=np.uint64)
    slab[::17] = (1 << 64) - 1
    return slab


@pytest.mark.parametrize("n_verbs,n", [(16, 1), (48, 7), (32, 16)])
def test_fleet_read_plain_matches_reference(n_verbs, n):
    """Uniform-length sweeps (the Pallas kernel's contract): the port's
    ragged plain gather with CSR offsets ``i * n`` equals the jnp oracle
    and the Pallas kernel on hi/lo planes, word for word."""
    rng = np.random.default_rng(n_verbs * 31 + n)
    n_cells, region_words = 6, 64
    slab = _slab(rng, n_cells, region_words)
    cells = rng.integers(0, n_cells, size=n_verbs).astype(np.int64)
    offs = rng.integers(0, region_words - n + 1,
                        size=n_verbs).astype(np.int64)
    base = cells * region_words + offs
    start = np.arange(n_verbs + 1, dtype=np.int64) * n
    got = fleet_read(torch.from_numpy(slab.view(np.int64)), _t(base),
                     _t(start), n_verbs * n).numpy().view(np.uint64)
    slab2d = slab.reshape(n_cells, region_words)
    hi = jnp.asarray((slab2d >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((slab2d & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    ci = jnp.asarray(cells, jnp.int32)
    oi = jnp.asarray(offs, jnp.int32)
    for rhi, rlo in (fleet_read_ref(hi, lo, ci, oi, n=n),
                     fleet_read_fwd(hi, lo, ci, oi, n=n, interpret=True)):
        want = (np.asarray(rhi, np.uint64) << np.uint64(32)) \
            | np.asarray(rlo, np.uint64)
        assert np.array_equal(got.reshape(n_verbs, n), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_read_plain_ragged(seed):
    """One call covers ragged lengths, zero-length verbs included."""
    rng = np.random.default_rng(seed)
    slab = _slab(rng, 4, 256)
    lens = rng.integers(0, 40, 64)
    lens[::5] = 0
    base = rng.integers(0, slab.size - 40, 64)
    start = np.concatenate([[0], np.cumsum(lens)])
    got = fleet_read_plain(torch.from_numpy(slab.view(np.int64)), _t(base),
                           _t(start), int(start[-1]))
    want = np.concatenate([slab[b:b + m] for b, m in zip(base, lens)])
    assert np.array_equal(got.numpy().view(np.uint64), want)
    empty = fleet_read(torch.from_numpy(slab.view(np.int64)), _t(base[:0]),
                       _t(start[:1]), 0)
    assert empty.numel() == 0
    with pytest.raises(ValueError):
        fleet_read(torch.from_numpy(slab.view(np.int64)), _t(base),
                   _t(start[:-1]), int(start[-1]))


def test_fleet_read_matches_pool_sweep():
    """On a live cluster slab, the port pool's read sweep (which runs the
    ``fleet_read`` wrapper) returns what the reference pool's
    ``_fused_read_sweep`` returns: ragged lengths, zero-length verbs and
    reads of a dead MN's replica included."""
    from repro.core import DMConfig, FuseeCluster

    cl = FuseeCluster(DMConfig(), num_clients=4, seed=3)
    for c in range(4):
        for k in range(6):
            cl.scheduler.submit(c, "insert", 10 * c + k, [c, k, 7, 1 << 63])
    cl.fleet().run()
    ref = cl.pool
    regions = np.array(sorted(ref.placement)[:10] * 2, np.int64)
    replicas = np.array([0] * 10 + [1] * 10, np.int64)
    offs = np.arange(20, dtype=np.int64) * 3
    ns = np.array([3, 0, 1, 7, 16] * 4, np.int64)
    port = port_pool_like(ref)
    dead = ref.placement[int(regions[0])][1]
    ref.crash_mn(dead)
    port.crash_mn(dead)
    want = ref._fused_read_sweep(regions, replicas, offs, ns)
    got, _w, _c, _f = port.exec_fused_tick(reads=(regions, replicas, offs,
                                                  ns))
    assert sum(w is None for w in want) > 0
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            assert g.dtype == np.uint64 and np.array_equal(w, g)
    assert np.array_equal(ref.mn_bytes, port.mn_bytes)
