"""The port's two kernels against the JAX package, on the CPU.

* RACE probe: ``hash32``, ``build_shadow`` and the plain ``race_lookup`` of
  ``repro_torch`` against ``repro.core.shadow``, ``race_lookup_ref`` and the
  Pallas kernel ``race_lookup_fwd`` in interpret mode, at the shapes of
  ``tests/test_kernels.py`` plus the edge keys 0, 2^31 and 2^32-1; the
  packed answer (``race_lookup_packed_plain`` and the probe path's
  ``core.api.probe_to_host``) on crafted tables: b2 colliding with b1, a
  fingerprint hash of 0, full rows, one fingerprint in both buckets.
* Fused-tick READ sweep: the plain ``fleet_read`` against ``fleet_read_ref``,
  ``fleet_read_fwd`` in interpret mode and ``DMPool._fused_read_sweep`` of a
  live reference pool.
* Decode attention's split plan: the CUDA kernel's algorithm (splits of
  ``split_plan``, four warps' online softmax over tiles of 8 positions, the
  in-CTA merge and the combine over splits) written out in torch, against
  ``paged_attention_plain``.

Integer paths: tolerance 0; the split plan's f32 arithmetic: 2e-5.  The
CUDA launches are in ``tests/test_torch_cuda.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shadow as ref_shadow
from repro.kernels.fleet_tick.kernel import fleet_read_fwd
from repro.kernels.fleet_tick.ref import fleet_read_ref
from repro.kernels.race_lookup.kernel import race_lookup_fwd
from repro.kernels.race_lookup.ref import race_lookup_ref
from repro_torch.core import api as port_api
from repro_torch.core import shadow as port_shadow
from repro_torch.kernels import (KERNELS, flash_attention, fleet_read,
                                 fleet_read_plain, leaf_probe,
                                 paged_attention, paged_attention_plain,
                                 race_lookup, race_lookup_plain,
                                 reset_launches)
from repro_torch.kernels.paged_attention.ops import SPLIT_CHUNK, split_plan
from repro_torch.kernels.race_lookup.ops import (MASK24,
                                                 race_lookup_packed_plain)

from _torch_parity import attn_bound, port_pool_like

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
    assert set(KERNELS) == {race_lookup, fleet_read, leaf_probe,
                            flash_attention, paged_attention}
    with pytest.raises(TypeError):
        race_lookup(keys.to(torch.int32), table)
    with pytest.raises(ValueError):
        race_lookup(keys[:, None], table)


def _probe_of(keys: np.ndarray, nb: int):
    """(b1, b2, fp) of uint32 keys as the reference computes them."""
    h = ref_shadow.hash32_np
    b1 = h(keys, 1) % nb
    b2 = h(keys, 2) % nb
    b2 = np.where(b2 == b1, (b1 + 1) % nb, b2)
    fp = h(keys, 7) >> np.uint32(24)
    return b1, b2, np.where(fp == 0, np.uint32(1), fp), h(keys, 7) >> 24


def _crafted_probe(spb: int, n: int, seed: int):
    """(keys (n,) uint32, table (nb, spb) uint32, expected ptr of each
    crafted key or None): a seeded table, half its slots empty, with keys
    laid out on rows no other crafted key touches — the edge keys 0, 2^31
    and 2^32-1 stored; a key whose b2 collides with b1, stored in row
    (b1 + 1) % nb; a key whose fingerprint hash is 0 (fingerprint 1),
    stored beside a slot of fingerprint 0; one fingerprint in both buckets
    (bucket 1's pointer must win); full rows in both buckets, once without
    and once with a match in b2's last slot — then stored and absent
    seeded keys."""
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1 << 31, (1 << 32) - 1], np.uint32)
    for nb in ((61, 67, 71, 73, 79) if n <= 64 else (1021, 1019, 1013)):
        e1, e2, _, _ = _probe_of(edges, nb)       # not a power of two,
        if len({*e1.tolist(), *e2.tolist()}) == 6:   # edge rows disjoint
            break
    table = rng.integers(0, 1 << 32, (nb, spb), dtype=np.uint64)
    table[rng.random((nb, spb)) < 0.5] = 0
    table = table.astype(np.uint32)
    pool = np.concatenate([edges, np.arange(1, 1 << 20, dtype=np.uint32)])
    b1s, b2s, fps, raw = _probe_of(pool, nb)
    used = set()
    keys, want = [], []

    def take(pred):
        for j in np.flatnonzero(pred):
            r = {int(b1s[j]), int(b2s[j])}
            if not r & used:
                used.update(r)
                return int(j)
        raise AssertionError("no key left for a crafted case")

    def other_fp(fp):
        return (int(fp) % 255) + 1                # another nonzero fp

    def row_of(j, b, fill, last=None):
        table[b] = [(other_fp(fps[j]) << 24) | (fill + s)
                    for s in range(spb)]
        if last is not None:
            table[b, spb - 1] = last

    idx = np.arange(pool.size)
    for j in (0, 1, 2):                           # edge keys, stored
        assert not {int(b1s[j]), int(b2s[j])} & used
        used.update({int(b1s[j]), int(b2s[j])})
        col = int(rng.integers(spb))
        table[b1s[j]][:col] = 0
        table[b1s[j], col] = (int(fps[j]) << 24) | (100 + j)
        keys.append(j)
        want.append(100 + j)
    collide = (ref_shadow.hash32_np(pool, 1) % nb
               == ref_shadow.hash32_np(pool, 2) % nb) & (idx > 2)
    j = take(collide)                             # b2 = (b1 + 1) % nb
    row_of(j, b1s[j], 0x10)
    row_of(j, b2s[j], 0x20, last=(int(fps[j]) << 24) | 200)
    keys.append(j)
    want.append(200)
    j = take((raw == 0) & (idx > 2))              # fingerprint hash 0
    table[b1s[j]] = 0
    table[b1s[j], 0] = 0x000123                   # fp 0: never a match
    table[b1s[j], spb - 1] = (1 << 24) | 300
    keys.append(j)
    want.append(300)
    j = take(idx > 2)                             # same fp in both rows
    row_of(j, b2s[j], 0x30)
    table[b2s[j], 0] = (int(fps[j]) << 24) | 401
    row_of(j, b1s[j], 0x40, last=(int(fps[j]) << 24) | 402)
    keys.append(j)
    want.append(402)
    j = take(idx > 2)                             # both rows full, a miss
    row_of(j, b1s[j], 0x50)
    row_of(j, b2s[j], 0x60)
    keys.append(j)
    want.append(0)
    j = take(idx > 2)                             # both full, b2's last
    row_of(j, b1s[j], 0x70)
    row_of(j, b2s[j], 0x80, last=(int(fps[j]) << 24) | 500)
    keys.append(j)
    want.append(500)
    crafted = pool[keys]
    rest = pool[rng.integers(3, pool.size, max(n - len(keys), 0))]
    return (np.concatenate([crafted, rest])[:n], table,
            want[:min(n, len(want))])


@pytest.mark.parametrize("n", [0, 1, 33, 4096])
@pytest.mark.parametrize("spb", [1, 7, 8, 16])
def test_packed_probe_matches_reference(spb, n):
    """The packed answer, ``found << 24 | ptr``, of the plain twin and of
    the probe path's ``probe_to_host`` (CPU: its staging buffers and the
    twin) against ``repro.core.shadow.race_lookup_np`` and the Pallas
    kernel in interpret mode, bit for bit, on crafted keys and tables."""
    reset_launches()
    q, table, want = _crafted_probe(spb, n, seed=spb * 7 + n)
    p_np, f_np = ref_shadow.race_lookup_np(q, table)
    assert list(p_np[:len(want)]) == want       # the crafted cases hold
    packed = (f_np.astype(np.int32) << 24) | p_np.astype(np.int32)
    t = torch.from_numpy(table.view(np.int32))
    plain = race_lookup_packed_plain(_t(q), t)
    assert plain.dtype == torch.int32
    assert np.array_equal(plain.numpy(), packed)
    host = port_api.probe_to_host(q.astype(np.uint64), t)
    assert host.dtype == np.int32 and np.array_equal(host, packed)
    ptr, found = host & MASK24, (host >> 24) == 1
    assert np.array_equal(ptr, p_np.astype(np.int32))
    assert np.array_equal(found, f_np)
    assert race_lookup.launches == 0
    if n:
        p_j, f_j = race_lookup_fwd(jnp.asarray(q.view(np.int32)),
                                   jnp.asarray(table.view(np.int32)),
                                   block_keys=min(n, 256), interpret=True)
        assert np.array_equal(np.asarray(p_j), ptr)
        assert np.array_equal(np.asarray(f_j), found)


def test_probe_answer_survives_the_next_probe():
    """``probe_to_host`` returns a fresh array: the next probe, which
    reuses the staging buffers, leaves it as it was."""
    q, table, _ = _crafted_probe(8, 4096, seed=3)
    t = torch.from_numpy(table.view(np.int32))
    first = port_api.probe_to_host(q, t)
    kept = first.copy()
    second = port_api.probe_to_host(q[::-1].copy(), t)
    third = port_api.probe_to_host(q[:100], t)
    assert np.array_equal(first, kept)
    assert np.array_equal(second, kept[::-1])
    assert np.array_equal(third, kept[:100])
    assert not np.shares_memory(first, second)


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


# ------------------------------------------- decode attention's split plan
WARPS, TILE = 4, 8                 # csrc/paged_attention.cu's kWarps, kTile


def _merge(ms, ls, os_):
    """Rescale online-softmax states (m, l, o) in log2 units to their
    common max and sum them, as the kernel's merges do (a state that saw
    no position has m = -inf and weighs 0)."""
    m = torch.stack(ms).amax(0)
    mref = torch.where(m == -math.inf, torch.zeros_like(m), m)
    w = [torch.exp2(mi - mref) for mi in ms]
    return (m, sum(wi * li for wi, li in zip(w, ls)),
            sum(wi[..., None] * oi for wi, oi in zip(w, os_)))


def _paged_split_kernel_in_torch(q, kc, vc, valid_len):
    """``csrc/paged_attention.cu`` step by step in f32: q pre-scaled by
    hd^-0.5 log2(e); per split of the plan, warp w runs an online softmax
    over tiles w, w + 4, ... of 8 positions; the CTA merges its warps; the
    combine merges the splits and divides by l."""
    nb, tb, B, KV, hd = kc.shape
    G = q.shape[1] // KV
    vl = min(valid_len, nb * tb)
    splits, chunk = split_plan(vl)
    k = kc.float().reshape(nb * tb, B, KV, hd)
    v = vc.float().reshape(nb * tb, B, KV, hd)
    qs = q.float().reshape(B, KV, G, hd) * (hd ** -0.5 * math.log2(math.e))
    parts = []
    for s in range(splits):
        p0, p1 = s * chunk, min(s * chunk + chunk, vl)
        assert p0 < vl                  # every split has a valid position
        ntiles = -(-(p1 - p0) // TILE)
        warps = []
        for w in range(WARPS):
            m = torch.full((B, KV, G), -math.inf)
            l, o = torch.zeros(B, KV, G), torch.zeros(B, KV, G, hd)
            for j in range(w, ntiles, WARPS):
                a, e = p0 + j * TILE, min(p0 + (j + 1) * TILE, p1)
                sc = torch.einsum("bkgd,tbkd->bkgt", qs, k[a:e])
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(sc - m_new[..., None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + torch.einsum("bkgt,tbkd->bkgd",
                                                        p, v[a:e])
                m = m_new
            warps.append((m, l, o))
        parts.append(_merge(*zip(*warps)))
    _m, l, o = _merge(*zip(*parts))
    return (o / l.clamp_min(1e-30)[..., None]).reshape(B, KV * G, hd)


@pytest.mark.parametrize("vl", [1, SPLIT_CHUNK - 1, SPLIT_CHUNK,
                                SPLIT_CHUNK + 1, 1167, 2048, 5000])
@pytest.mark.parametrize("B,KV,H,hd", [(2, 2, 8, 128), (1, 1, 8, 16),
                                       (2, 4, 4, 16)])
def test_paged_split_plan_and_combine_match_plain(vl, B, KV, H, hd):
    rng = np.random.default_rng(vl + hd)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 for s in ((B, H, hd), (2, 1024, B, KV, hd),
                           (2, 1024, B, KV, hd)))
    want = paged_attention_plain(q, kc, vc, vl)
    got = _paged_split_kernel_in_torch(q, kc, vc, vl)
    assert bool(((got - want).abs() <= attn_bound(want, None)).all())


def test_split_plan_covers_valid_len_exactly():
    """Splits tile [0, valid_len): none starts at or past it, the last
    ends at it, and the serve run's longest step gives >= 264 CTAs (2 per
    SM of an H100) over its 4 x 8 (batch, kv head) groups."""
    for vl in list(range(1, 1200)) + [2048, 5000, 16384, 1 << 20]:
        splits, chunk = split_plan(vl)
        assert chunk == SPLIT_CHUNK
        assert (splits - 1) * chunk < vl <= splits * chunk
    assert split_plan(1167)[0] * 4 * 8 >= 264
