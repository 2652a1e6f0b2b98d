"""The port's dense model and serve engine held against the JAX package's
at reduced size (``reduced(llama3_8b)``: 2 layers, d_model 64, 4 heads over
1 KV head, head_dim 16, vocab 128).

The port runs the JAX model's own parameters (``params_from_jax``).  The
JAX side uses ``use_kernels=False`` (its flash kernel does not run on the
installed jax, ROADMAP C), so prefill is held to the jnp flash twin and
decode to ``flash_decode_jnp``; the port goes through its kernels'
wrappers, which take the plain versions for these CPU tensors.  Logits
and cache pages agree within 2e-5 in float32 (summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RC
from repro.launch.mesh import make_host_mesh
from repro.models import build as ref_build
from repro.serving import (PoolConfig as RefPoolCfg, Request as RefRequest,
                           ServeEngine as RefEngine)
from repro_torch.configs import base as PC
from repro_torch.kernels import flash_attention, paged_attention
from repro_torch.models import Model, build, params_from_jax
from repro_torch.serving import PoolConfig, Request, ServeEngine
from repro_torch.serving.engine import _block_hashes as port_block_hashes
from repro.serving.engine import _block_hashes as ref_block_hashes

from _torch_parity import serve_scenario

F32 = 2e-5


def _ref_model(dtype="float32", seed=0):
    cfg = dataclasses.replace(RC.reduced(RC.get("llama3-8b")), dtype=dtype)
    m = ref_build(cfg, make_host_mesh((1, 1), ("data", "model")),
                  use_kernels=False)
    return m, m.init(jax.random.key(seed))


@pytest.fixture(scope="module")
def f32_pair():
    m, params = _ref_model()
    port = build(PC.reduced(PC.get("llama3-8b")), device="cpu")
    return m, params, port, params_from_jax(jax.tree.map(np.asarray, params),
                                            device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ------------------------------------------------------------- parameters
def test_configs_match_reference():
    assert dataclasses.asdict(PC.get("llama3-8b")) == \
        dataclasses.asdict(RC.get("llama3-8b"))
    assert dataclasses.asdict(PC.reduced(PC.get("llama3-8b"))) == \
        dataclasses.asdict(RC.reduced(RC.get("llama3-8b")))
    assert PC.get("llama3-8b").n_params() == RC.get("llama3-8b").n_params()
    moe = dict(family="moe", n_layers=4)
    port_moe = dataclasses.replace(
        PC.reduced(PC.get("llama3-8b")), **moe,
        moe=PC.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, moe_every=2,
                         dense_residual_d_ff=16))
    ref_moe = dataclasses.replace(
        RC.reduced(RC.get("llama3-8b")), **moe,
        moe=RC.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, moe_every=2,
                         dense_residual_d_ff=16))
    assert port_moe.n_params() == ref_moe.n_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_bit_identical(dtype):
    m, params = _ref_model(dtype)
    port = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    ref_leaves = dict(_leaves(params))
    port_leaves = dict(_leaves(port))
    assert ref_leaves.keys() == port_leaves.keys()
    want_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    for name, a in ref_leaves.items():
        t = port_leaves[name]
        assert t.dtype == want_dt and tuple(t.shape) == a.shape, name
        bits = np.int16 if dtype == "bfloat16" else np.int32
        assert np.array_equal(np.asarray(a).view(bits),
                              t.view(torch.int16 if dtype == "bfloat16"
                                     else torch.int32).numpy()), name


def test_port_init_has_reference_tree():
    """The port's own random init: the reference's tree, shapes and dtype,
    a pure function of the seed."""
    m, params = _ref_model()
    model = build(PC.reduced(PC.get("llama3-8b")), device="cpu")
    a, b = model.init(seed=5), model.init(seed=5)
    ref_shapes = {k: v.shape for k, v in _leaves(params)}
    assert {k: tuple(v.shape) for k, v in _leaves(a)} == ref_shapes
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(_leaves(a), _leaves(b)))
    assert all(v.dtype == torch.float32 for _, v in _leaves(a))


# ---------------------------------------------------------------- forward
def _prompt(B=2, S=80, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (B, S)) \
        .astype(np.int32)


def test_prefill_logits_and_cache_match_reference(f32_pair):
    m, params, port, tp = f32_pair
    toks = _prompt()
    before = flash_attention.launches
    lj, cj = m.prefill(params, jnp.asarray(toks), max_len=128)
    lt, ct = port.prefill(tp, torch.from_numpy(toks).long(), max_len=128)
    assert flash_attention.launches == before      # CPU: plain version
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=F32,
                               rtol=F32)
    assert ct["length"] == int(cj["length"]) == toks.shape[1]
    for a, b in zip(cj["layers"][0], ct["layers"][0]):   # (kc, vc) pages
        assert tuple(b.shape) == a.shape           # (L, nb, tb, B, KV, hd)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=F32,
                                   rtol=F32)


def test_six_decode_steps_match_reference(f32_pair):
    m, params, port, tp = f32_pair
    toks = _prompt(seed=2)
    _, cj = m.prefill(params, jnp.asarray(toks), max_len=128)
    _, ct = port.prefill(tp, torch.from_numpy(toks).long(), max_len=128)
    tok = toks[:, -1:]
    for _ in range(6):
        lj, cj = m.decode_step(params, cj, jnp.asarray(tok))
        lt, ct = port.decode_step(tp, ct, torch.from_numpy(tok).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=F32,
                                   rtol=F32)
        tok = np.asarray(lj[:, -1]).argmax(-1)[:, None].astype(np.int32)
    assert ct["length"] == int(cj["length"]) == toks.shape[1] + 6
    for a, b in zip(cj["layers"][0], ct["layers"][0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=F32,
                                   rtol=F32)


def test_model_rejects_unported_families_and_missing_gpu():
    moe = dataclasses.replace(
        PC.reduced(PC.get("llama3-8b")), family="moe",
        moe=PC.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32))
    with pytest.raises(NotImplementedError, match="A9"):
        Model(moe, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build(PC.reduced(PC.get("llama3-8b")))


# ----------------------------------------------------------------- engine
def test_engine_matches_reference(f32_pair):
    m, params, port, tp = f32_pair
    ref_eng, ref_done, ref_search = serve_scenario(
        RefEngine, RefRequest, RefPoolCfg, ref_block_hashes, m, params)
    before = paged_attention.launches
    eng, done, search = serve_scenario(ServeEngine, Request, PoolConfig,
                                       port_block_hashes, port, tp)
    assert paged_attention.launches == before      # CPU: plain version
    assert len(done) == 4 and all(len(q.out) == 4 for q in done)
    assert [(q.rid, q.out, q.prefix_hits) for q in done] == \
        [(q.rid, q.out, q.prefix_hits) for q in ref_done]
    assert sum(q.prefix_hits for q in done) >= 2
    assert eng.pool.check_replicas_converged()
    # per-key SEARCH results (the arrival draws differ, so slot placement
    # may; what each key resolves to may not)
    assert np.array_equal(search[0], ref_search[0])
    assert np.array_equal(search[1], ref_search[1])
    assert eng.steps == ref_eng.steps
    assert eng.health() == ref_eng.health()
    assert eng.metrics() == ref_eng.metrics()


def _crash_scale_run(Eng, Req, Pool, model, params, crashed_error):
    eng = Eng(model, params, max_batch=2, max_len=128,
              pool_cfg=Pool(n_pages=256, n_buckets=64, slots_per_bucket=4))
    eng.submit(Req(rid=0, prompt=_prompt(B=1, S=70)[0], max_new=2))
    eng.run(max_ticks=10)
    eng.crash_worker()
    with pytest.raises(crashed_error):
        eng.store.get(1)
    st = eng.recover_worker()
    assert st["chunks"] == 1 and st["redone"] == 0
    assert eng.scale_pool() == 4 and eng.health()["pool_shards"] == 5
    eng.submit(Req(rid=1, prompt=_prompt(B=1, S=70)[0], max_new=2))
    done = eng.run(max_ticks=10)
    assert [q.prefix_hits for q in done] == [0, 1]
    (key, _page), = eng.list_prefixes(0, 8)
    return [eng.list_prefixes(0, 8), eng.list_prefixes(key, 64),
            eng.list_prefixes(key + 1, 4), eng.list_prefixes(0, 0)]


def test_engine_worker_crash_recovery_and_scale_out(f32_pair):
    """Worker crash, recovery and pool scale-out, then ``list_prefixes``
    (SCAN over the backend's keydir): equal listings on both engines."""
    from repro.core import ClientCrashed as RefCrashed
    from repro_torch.core import ClientCrashed
    m, params, port, tp = f32_pair
    got = _crash_scale_run(ServeEngine, Request, PoolConfig, port, tp,
                           ClientCrashed)
    want = _crash_scale_run(RefEngine, RefRequest, RefPoolCfg, m, params,
                            RefCrashed)
    assert got == want
    assert got[1] == got[0] and got[2] == got[3] == []


def test_block_hashes_bit_identical():
    rng = np.random.default_rng(4)
    for n in (0, 63, 64, 200, 1152):
        p = rng.integers(0, 128256, n).astype(np.int32)
        assert np.array_equal(port_block_hashes(p), ref_block_hashes(p))
