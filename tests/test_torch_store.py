"""The port's store surface against the JAX package, on the CPU.

* ``repro_torch`` is self-contained: no file under ``src/repro_torch/``
  imports ``jax`` or ``repro`` (an AST scan), and neither does
  ``chip_smoke.py``.
* The ``device=`` contract: no device means CUDA, never a silent CPU.
* Leaf modules (codec, layout's crc8, rng, ring, race) agree bit for bit.
* A seeded step-mode op stream with a ``FaultPlan`` (client crash and
  recovery, MN crash and Alg-3 auto-recovery) gives the same pool bytes,
  health, op history and per-MN bytes in both packages.
* Features outside this slice fail loudly with their ROADMAP item.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import codec as ref_codec
from repro.core import layout as ref_layout
from repro.core import race as ref_race
from repro.core import ring as ref_ring
from repro_torch.core import codec as port_codec
from repro_torch.core import layout as port_layout
from repro_torch.core import race as port_race
from repro_torch.core import ring as port_ring

from _torch_parity import assert_same_run, signature

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------- self-containment
def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"forbidden imports: {bad}"


def test_cluster_device_contract():
    if torch.cuda.is_available():
        assert T.FuseeCluster(T.DMConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            T.FuseeCluster(T.DMConfig())
    cl = T.FuseeCluster(T.DMConfig(), device="cpu")
    assert cl.pool.slab.buf.device.type == "cpu"
    assert cl.pool.slab.buf.dtype == torch.int64


# ------------------------------------------------------------- leaf modules
@pytest.mark.parametrize("value", [
    b"", b"x", bytes(range(256)) * 7, b"\xff\xfe\x00\x80" * 99, "héllo",
    [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], [], None])
def test_codec_values_match_reference(value):
    a = ref_codec.encode_value(value)
    b = port_codec.encode_value(value)
    assert [int(w) for w in a] == [int(w) for w in b]
    assert ref_codec.decode_value(a) == port_codec.decode_value(b)


@pytest.mark.parametrize("key", [
    0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, b"", b"\x00\xffkey" * 16384,
    "clé", b"\xff\xfe"])
def test_codec_keys_match_reference(key):
    assert ref_codec.encode_key(key) == port_codec.encode_key(key)


def test_crc8_and_layout_match_reference():
    """crc8 folds long word lists in one vectorized pass in the port; it
    must equal the reference's bytewise loop on every length."""
    rng = np.random.default_rng(0)
    for n in list(range(0, 20)) + [63, 64, 123, 125, 128, 300]:
        words = [int(w) for w in rng.integers(0, 1 << 64, n,
                                              dtype=np.uint64)]
        if n > 2:
            words[1] = (1 << 64) - 1
            words[2] = 0
        assert ref_layout.crc8(words) == port_layout.crc8(words), n
    obj_r, sc_r = ref_layout.build_object(7, list(range(123)), 5, 9, 1)
    obj_t, sc_t = port_layout.build_object(7, list(range(123)), 5, 9, 1)
    assert sc_r == sc_t and [int(w) for w in obj_r] == [int(w) for w in obj_t]
    assert len(obj_t) == 128                  # a 1 KiB KV pair is 128 words
    pr, pt = ref_layout.parse_object(obj_r), port_layout.parse_object(obj_t)
    assert {k: (int(v) if not isinstance(v, list) else v)
            for k, v in pr.items()} == \
        {k: (int(v) if not isinstance(v, list) else v)
         for k, v in pt.items()}


def test_rng_ring_race_match_reference():
    a, b = R.SimRng(42), T.SimRng(42)
    for name in ("workload", "faults", "steps"):
        assert np.array_equal(a.stream(name).integers(0, 1 << 62, 64),
                              b.stream(name).integers(0, 1 << 62, 64))
    for g in range(40):
        assert ref_ring.ring_replicas(g, [0, 1, 3, 4], 2) == \
            port_ring.ring_replicas(g, [0, 1, 3, 4], 2)
    for key in (0, 1, 1 << 63, (1 << 64) - 1, 12345):
        assert ref_race.slot_offsets(key, 256, 7) == \
            port_race.slot_offsets(key, 256, 7)


# ---------------------------------------------------- step mode with faults
def _fault_stream(M, seed, **kw):
    n_clients = 6
    cl = M.FuseeCluster(M.DMConfig(num_mns=5, replication=2),
                        num_clients=n_clients, seed=seed, **kw)
    plan = M.FaultPlan()
    plan.crash_client(2, after_ops=25)
    plan.recover_client(2, reassign_to=3, after_ops=45)
    plan.crash_mn(1, after_ops=60)
    cl.inject(plan)
    stores = {c: cl.store(c) for c in range(n_clients)}
    wl = cl.rng.stream("workload")
    steps = cl.rng.stream("steps")
    futs = []
    for rnd in range(12):
        for c in range(n_clients):
            ops = []
            for j in range(4):
                r, key = wl.random(), int(wl.integers(40))
                ops.append(M.Op.put(key, [rnd, c, j, (1 << 64) - 1 - j])
                           if r < 0.45 else
                           M.Op.get(key) if r < 0.9 else M.Op.delete(key))
            try:
                futs += stores[c].submit_batch(ops)
            except M.ClientCrashed:
                pass
        for _ in range(40):
            cids = cl.scheduler.eligible_cids()
            if not cids:
                break
            cl.scheduler.step(cids[int(steps.integers(len(cids)))],
                              pick=int(steps.integers(4)))
    cl.drain()
    fast = sum(s.backend.stats()["batch_fast_hits"] for s in stores.values())
    return cl, futs, fast


def _res(fut):
    r = fut.result()
    return (r.status, r.value, r.rtts, r.bg_rtts, r.rule)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_step_mode_fault_stream_matches_reference(seed):
    ref, f_ref, fast_ref = _fault_stream(R, seed)
    port, f_port, fast_port = _fault_stream(T, seed, device="cpu")
    assert_same_run(signature(ref), signature(port))
    assert [_res(f) for f in f_ref] == [_res(f) for f in f_port]
    h = port.health()
    assert h.mn_recoveries == 1 and h.client_recoveries == 1
    assert not port.pool.mns[1].alive
    # batched GETs went through the race_lookup probe in both packages
    assert fast_ref == fast_port > 0


def test_round_robin_and_replay_match_reference():
    def run(M, **kw):
        cl = M.FuseeCluster(M.DMConfig(), num_clients=3, seed=9, **kw)
        kvs = [cl.store(c) for c in range(3)]
        for k in range(30):
            kvs[k % 3].submit(M.Op.put(k, [k, 1 << 63]))
        cl.scheduler.run_random()
        assert kvs[0].get(4) == [4, 1 << 63]
        assert kvs[1].delete(4).status == "OK"
        assert kvs[2].get(4) is None
        return cl
    a, b = run(R), run(T, device="cpu")
    assert_same_run(signature(a), signature(b))
    ta, tb = a.trace(), b.trace()
    assert (ta.seed, ta.decisions, ta.ticks) == \
        (tb.seed, tb.decisions, tb.ticks)


# ------------------------------------------------------------ out of slice
def test_features_outside_the_slice_raise():
    cl = T.FuseeCluster(T.DMConfig(), num_clients=2, device="cpu")
    kv = cl.store(0)
    with pytest.raises(NotImplementedError, match="A6"):
        kv.submit(T.Op("scan", 1, 4))
    for call, item in ((cl.attach_tracer, "A12"), (cl.race_findings, "A12"),
                       (cl.heap_audit, "A12"), (cl.metrics, "A11"),
                       (cl.profile, "A11")):
        with pytest.raises(NotImplementedError, match=item):
            call()
