"""Shared helpers of the ``test_torch_*`` files: the PyTorch port
(``repro_torch``) held against the JAX package (``repro``) on the CPU.

Integer paths compare exactly (tolerance 0).  State crosses between the two
packages only as numpy arrays and plain dicts.
"""
import dataclasses

import numpy as np
import pytest
import torch


def require_cuda():
    """Skip the calling test unless a CUDA device is present (decided at
    run time, never at import: every xdist worker collects the same
    tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no "
                    "interpret mode")


def port_config(ref_cfg):
    """The port's DMConfig with every field of a reference DMConfig."""
    from repro_torch.core import DMConfig
    return DMConfig(**dataclasses.asdict(ref_cfg))


def ref_state(pool) -> dict:
    """A reference pool's state as plain numpy arrays and dicts, in the
    keyword form of ``repro_torch`` ``DMPool.load_numpy_state``."""
    return dict(slab_words=pool.slab.buf.copy(),
                cells=dict(pool.slab.cells),
                placement={g: list(r) for g, r in pool.placement.items()},
                alive=[m.alive for m in pool.mns],
                members=list(pool.directory.members),
                epoch=pool.epoch,
                mn_bytes=pool.mn_bytes.copy(),
                versions=dict(pool.directory.versions))


def port_pool_like(ref_pool):
    """A CPU port pool holding a byte-for-byte copy of ``ref_pool``."""
    from repro_torch.core import DMPool
    pool = DMPool(port_config(ref_pool.cfg),
                  num_clients=ref_pool.num_clients, device="cpu")
    pool.load_numpy_state(**ref_state(ref_pool))
    return pool


def slab_u64(pool) -> np.ndarray:
    buf = pool.slab.buf
    if isinstance(buf, torch.Tensor):
        return buf.cpu().numpy().view(np.uint64)
    return buf


def norm(x):
    """A verb result as plain Python ints (None stays None)."""
    if x is None:
        return None
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if np.ndim(x) == 0:
        return int(x)
    return [int(v) for v in np.asarray(x, dtype=object).ravel()]


def norm_list(xs):
    return [norm(x) for x in xs]


def assert_same_typed(ref, got):
    """Unsigned results must come back as the reference's types: np.uint64
    scalars and np.uint64 arrays, so op histories agree on words >= 2^63."""
    for a, b in zip(ref, got):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and b.dtype == a.dtype
        elif isinstance(a, np.integer):
            assert type(b) is type(a)


# --------------------------------------------------------------- signatures
def pool_bytes(cl) -> bytes:
    out = []
    for mn in cl.pool.mns:
        for g in sorted(mn.regions):
            a = mn.regions[g]
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.ascontiguousarray(a)
            out.append(a.tobytes())
    return b"".join(out)


def health_signature(cl):
    h = cl.health()
    return (h.epoch, h.tick, h.crashed_ops, h.client_recoveries,
            h.mn_recoveries,
            tuple((m.mid, m.alive, m.primary_regions, m.hosted_regions,
                   m.bytes_served) for m in h.mns),
            tuple((c.cid, c.status, c.epoch, c.inflight, c.cache_entries,
                   c.completed_ops, c.crashed_ops) for c in h.clients))


def history_signature(cl):
    return tuple(
        (r.cid, r.op_id, r.kind, r.key, r.inv_tick, r.resp_tick, r.rtts,
         r.bg_rtts, r.result.status,
         tuple(r.result.value) if isinstance(r.result.value, list) else None)
        for r in cl.scheduler.history if r.result is not None)


FLEET_COUNTERS = ("ticks", "verbs", "array_calls", "master_calls",
                  "max_lanes", "index_probe_verbs", "probe_invocations",
                  "probe_keys", "probe_hits", "shadow_rebuilds",
                  "fused_ticks", "fallback_ticks", "verbs_read",
                  "verbs_write", "verbs_cas", "verbs_faa", "verbs_alloc",
                  "verbs_free")


def counter_signature(fleet):
    if fleet is None:
        return None
    st = fleet.stats()
    return {k: st[k] for k in FLEET_COUNTERS if k in st}


def signature(cl, fleet=None) -> dict:
    """Every path-independent fact of a run (the fused-tick oracle's
    signature minus the metrics registry, which the port does not carry
    yet)."""
    return {"pool_bytes": pool_bytes(cl),
            "health": health_signature(cl),
            "history": history_signature(cl),
            "counters": counter_signature(fleet),
            "mn_bytes": tuple(int(b) for b in cl.pool.mn_bytes)}


def assert_same_run(ref, port):
    for k in ref:
        assert ref[k] == port[k], f"port/reference divergence in {k}"
