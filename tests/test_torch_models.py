"""The port's dense model and serve engine held against the JAX package's
at reduced size (``reduced(llama3_8b)``: 2 layers, d_model 64, 4 heads over
1 KV head, head_dim 16, vocab 128), and the four other dense decoders'
prefill and decode at their reduced sizes: smollm-360m (tied embeddings),
qwen3-32b (qk-norm), mistral-large-123b and chameleon-34b (family ``vlm``).

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


DENSE = ["llama3-8b", "smollm-360m", "qwen3-32b", "mistral-large-123b",
         "chameleon-34b"]


def _ref_model(dtype="float32", seed=0, arch="llama3-8b"):
    cfg = dataclasses.replace(RC.reduced(RC.get(arch)), dtype=dtype)
    m = ref_build(cfg, make_host_mesh((1, 1), ("data", "model")),
                  use_kernels=False)
    return m, m.init(jax.random.key(seed))


_PAIRS = {}


def _pair(arch):
    """(reference model, its f32 parameters, port model, the same
    parameters as the port's tensors) at the reduced size of ``arch``."""
    if arch not in _PAIRS:
        m, params = _ref_model(arch=arch)
        port = build(PC.reduced(PC.get(arch)), device="cpu")
        _PAIRS[arch] = (m, params, port, params_from_jax(
            jax.tree.map(np.asarray, params), device="cpu"))
    return _PAIRS[arch]


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("llama3-8b")


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
ALL = DENSE + ["kimi-k2-1t-a32b", "arctic-480b", "jamba-1.5-large-398b",
               "xlstm-350m", "whisper-medium"]


@pytest.mark.parametrize("arch", ALL + ["fusee_paper"])
def test_configs_match_reference(arch):
    """Every ported config: the reference's fields, parameter counts (total
    and active), reduced twin and padded vocabulary."""
    if arch == "fusee_paper":
        from repro.configs import FuseePaperConfig as RefPaper
        from repro_torch.configs import FuseePaperConfig
        assert dataclasses.asdict(FuseePaperConfig()) == \
            dataclasses.asdict(RefPaper())
        return
    assert arch in PC.all_archs()
    assert dataclasses.asdict(PC.get(arch)) == dataclasses.asdict(RC.get(arch))
    assert dataclasses.asdict(PC.reduced(PC.get(arch))) == \
        dataclasses.asdict(RC.reduced(RC.get(arch)))
    assert sorted(PC.all_archs()) == sorted(RC.all_archs())
    for port_cfg, ref_cfg in ((PC.get(arch), RC.get(arch)),
                              (PC.reduced(PC.get(arch)),
                               RC.reduced(RC.get(arch)))):
        assert port_cfg.n_params() == ref_cfg.n_params()
        assert port_cfg.n_active_params() == ref_cfg.n_active_params()
    ref = ref_build(RC.get(arch), make_host_mesh((1, 1), ("data", "model")))
    assert Model(PC.get(arch), device="cpu").vocab_p == ref.vocab_p
    if arch != "llama3-8b":
        return
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


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-32b"])
def test_params_from_jax_handles_tied_and_qk_norm_trees(arch):
    """smollm's tied tree (no ``lm_head``) and qwen3's qk-norm tree
    (``q_norm`` / ``k_norm`` per layer) cross bit for bit, and the port's
    own init builds the same tree."""
    m, params, port, tp = _pair(arch)
    ref_leaves, port_leaves = dict(_leaves(params)), dict(_leaves(tp))
    assert ref_leaves.keys() == port_leaves.keys()
    assert ("/lm_head" in ref_leaves) == (arch != "smollm-360m")
    assert ("/layers/0/attn/q_norm" in ref_leaves) == (arch == "qwen3-32b")
    for name, a in ref_leaves.items():
        assert np.array_equal(np.asarray(a), port_leaves[name].numpy()), name
    assert {k: tuple(v.shape) for k, v in _leaves(port.init(seed=1))} == \
        {k: v.shape for k, v in ref_leaves.items()}


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


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_cache_match_reference(arch):
    m, params, port, tp = _pair(arch)
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


@pytest.mark.parametrize("arch", DENSE)
def test_six_decode_steps_match_reference(arch):
    m, params, port, tp = _pair(arch)
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


def _host_attn_decode(p, x, pos, rope, kc, vc, *, qk_norm):
    """``attention.attn_decode`` with its position on the host, as the
    step ran before its position moved to the device: the new K/V written
    at a Python index, ``paged_attention`` given a host int."""
    from repro_torch.models import attention as A
    nb, tb, B, KV, hd = kc.shape
    at = pos.count - 1
    q, k, v = A.project_qkv(p, x, rope, qk_norm)
    kc.view(nb * tb, B, KV, hd)[at] = k[:, 0]
    vc.view(nb * tb, B, KV, hd)[at] = v[:, 0]
    return A._out(p, paged_attention(q[:, 0], kc, vc, at + 1)[:, None])


def _decode_run(port, tp, toks, steps):
    """Prefill ``toks`` and ``steps`` greedy decode steps: the logits of
    each step, the tokens and the final cache."""
    logits, cache = port.prefill(tp, torch.from_numpy(toks).long(),
                                 max_len=128)
    outs, tokens = [], []
    for _ in range(steps):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        tokens.append(tok)
        logits, cache = port.decode_step(tp, cache, tok)
        outs.append(logits)
    return outs, torch.cat(tokens, 1), cache


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-32b"])
def test_device_position_decode_equals_the_host_position_step(arch,
                                                              monkeypatch):
    """The capture-safe decode step (its position a device tensor: RoPE
    from it, the K/V written by ``index_copy_``, ``paged_attention`` given
    a device-held length) is bit for bit the step with a host position,
    logits, greedy tokens and caches, over 24 steps from position 50
    across the 64-position split edge."""
    from repro_torch.models import attention as A
    _, _, port, tp = _pair(arch)
    toks = _prompt(S=50, seed=5)
    got = _decode_run(port, tp, toks, 24)
    monkeypatch.setattr(A, "attn_decode", _host_attn_decode)
    want = _decode_run(port, tp, toks, 24)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1])
    assert got[2]["length"] == want[2]["length"] == 74
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_leaves(got[2]["layers"]), _leaves(want[2]["layers"])))
    assert not port._graphed                # the CPU runs the step eagerly


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-32b", "xlstm-350m",
                                  "jamba-1.5-large-398b"])
def test_prefill_into_a_reused_cache_equals_a_fresh_one(arch):
    """``prefill(..., cache=old)`` zeroes and refills the old pages and
    states in place (their storage stays, as a captured decode step needs)
    and gives a fresh prefill's logits and cache bit for bit, after decode
    steps wrote into the old one; a cache of another batch is not reused."""
    port = build(PC.reduced(PC.get(arch)), device="cpu")
    tp = port.init(seed=1)
    a, b = (torch.from_numpy(_prompt(S=40, seed=s)).long() for s in (6, 7))
    logits, old = port.prefill(tp, a, max_len=128)
    for _ in range(3):
        logits, old = port.decode_step(
            tp, old, logits[:, -1].argmax(-1, keepdim=True))
    ptrs = [t.data_ptr() for _, t in _leaves(old["layers"])]
    got, cache = port.prefill(tp, b, max_len=128, cache=old)
    assert [t.data_ptr() for _, t in _leaves(cache["layers"])] == ptrs
    want, fresh = port.prefill(tp, b, max_len=128)
    assert torch.equal(got, want) and cache["length"] == fresh["length"]
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(_leaves(cache["layers"]), _leaves(fresh["layers"])))
    assert port.cache_fits(cache, 2, 40, 128)
    assert not port.cache_fits(cache, 1, 40, 128)
    _, one = port.prefill(tp, b[:1], max_len=128, cache=cache)
    assert all(t.data_ptr() not in ptrs for _, t in _leaves(one["layers"]))


def test_model_rejects_unported_families_and_missing_gpu():
    """Every registered config builds on the CPU, its reduced twin with
    the reference's superblock (positions and repeat count); with no
    device named, a model needs the CUDA card."""
    from repro.models.model import superblock as ref_superblock
    from repro_torch.models.model import superblock
    for arch in PC.all_archs():
        full = Model(PC.get(arch), device="cpu")
        assert full.abstract_params()["embed"].shape[0] == full.vocab_p
        cfg = PC.reduced(PC.get(arch))
        specs, n = superblock(cfg)
        ref_specs, ref_n = ref_superblock(RC.reduced(RC.get(arch)))
        assert n == ref_n and [dataclasses.astuple(x) for x in specs] == \
            [dataclasses.astuple(x) for x in ref_specs]
        assert build(cfg, device="cpu").n_super == n
    assert Model(PC.reduced(PC.get("chameleon-34b")), device="cpu").n_super \
        == 2
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


def test_engine_refills_one_cache_in_place(f32_pair, monkeypatch):
    """Every prefill of an engine after its first refills the first one's
    pages in place (the storage a captured decode step reads), and the
    served tokens are those of test_engine_matches_reference."""
    _, _, port, tp = f32_pair
    seen = []
    inner = port.prefill

    def prefill(*args, **kw):
        logits, cache = inner(*args, **kw)
        seen.append([t.data_ptr() for _, t in _leaves(cache["layers"])])
        return logits, cache
    monkeypatch.setattr(port, "prefill", prefill)
    eng, done, _ = serve_scenario(ServeEngine, Request, PoolConfig,
                                  port_block_hashes, port, tp)
    assert len(seen) >= 2 and all(s == seen[0] for s in seen)
    assert len(done) == 4 and all(len(q.out) == 4 for q in done)


def test_block_hashes_bit_identical():
    rng = np.random.default_rng(4)
    for n in (0, 63, 64, 200, 1152):
        p = rng.integers(0, 128256, n).astype(np.int32)
        assert np.array_equal(port_block_hashes(p), ref_block_hashes(p))


def _max_len_run(Eng, Req, Pool, model, params):
    eng = Eng(model, params, max_batch=1, max_len=64,
              pool_cfg=Pool(n_pages=64, n_buckets=32, slots_per_bucket=4))
    eng.submit(Req(rid=0, prompt=_prompt(B=1, S=64)[0], max_new=4))
    return eng, eng.run(max_ticks=10)


def test_prompt_of_exactly_max_len(f32_pair):
    """A deliberate difference (ROADMAP C): a prompt that fills ``max_len``.
    The reference's prefill writes the first new token past the slot's
    last position and raises ``IndexError``; the port's engine guards the
    write, returns exactly that one token and retires the request."""
    m, params, port, tp = f32_pair
    with pytest.raises(IndexError):
        _max_len_run(RefEngine, RefRequest, RefPoolCfg, m, params)
    eng, done = _max_len_run(ServeEngine, Request, PoolConfig, port, tp)
    assert [(q.rid, len(q.out)) for q in done] == [(0, 1)]
    assert not eng.active and not eng.queue and eng.steps == 1
