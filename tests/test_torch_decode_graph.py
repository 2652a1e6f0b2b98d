"""The dense decode step as one CUDA graph (``Model.decode_step``) on the
card: the graphed step against the eager one, bit for bit, on a reduced
dense config and on two-layer cuts of qwen3-32b (G 8) and
mistral-large-123b (G 12) at full width, over 24 steps across a split
edge; launch counts and the recorder's counters; a new capture for a
batch of another size; one capture an engine across its prefills; the
eager step of the MoE, jamba, xLSTM and whisper; and the device-length
entry of ``paged_attention`` against its plain version and the host-int
entry, eagerly and replayed in a graph.  Every test is marked ``cuda`` and
skips without a GPU.

This file imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest tests/test_torch_decode_graph.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get, reduced
from repro_torch.kernels import paged_attention, paged_attention_plain
from repro_torch.models import Model
from repro_torch.obs.serve import ServeTrace

from _torch_parity import attn_bound, require_cuda

pytestmark = pytest.mark.cuda


def _randn(rng, shape, dt):
    return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                        device="cuda").to(dt)


# ---------------------------------------------- the device-length entry
@pytest.mark.parametrize("vl", [1, 63, 64, 65, 2048])
@pytest.mark.parametrize("H", [64, 96])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_device_length_entry_matches_plain(vl, H, dt):
    """``paged_attention`` with a one-element int32 length on the card (its
    grid and scratch sized for all nb * tb = 2048 positions) within the
    attention bound of the plain version, bit for bit the host-int
    entry's output, one launch a call, and blind to garbage past the
    length."""
    require_cuda()
    rng = np.random.default_rng(H + vl)
    q = _randn(rng, (4, H, 128), dt)
    kc = _randn(rng, (2, 1024, 4, 8, 128), dt)
    vc = _randn(rng, (2, 1024, 4, 8, 128), dt)
    length = torch.tensor([vl], dtype=torch.int32, device="cuda")
    before = paged_attention.launches
    got = paged_attention(q, kc, vc, length, count_len=vl)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_plain(q, kc, vc, vl)
    bound = attn_bound(want, paged_attention_plain(q, kc, vc.abs(), vl))
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    assert torch.equal(got, paged_attention(q, kc, vc, vl))
    if vl < 2048:
        vc.view(2048, 4, 8, 128)[vl:] = float("nan")
        kc.view(2048, 4, 8, 128)[vl:] = 999.0
        assert torch.equal(paged_attention(q, kc, vc, length), got)


def test_device_length_entry_replays_in_a_graph_at_every_length():
    """One capture of the device-length call, replayed with the length
    filled in: each replay equals the host-int entry at that length."""
    require_cuda()
    rng = np.random.default_rng(3)
    q = _randn(rng, (4, 96, 128), torch.bfloat16)
    kc = _randn(rng, (2, 1024, 4, 8, 128), torch.bfloat16)
    vc = _randn(rng, (2, 1024, 4, 8, 128), torch.bfloat16)
    length = torch.ones(1, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention(q, kc, vc, length, count_len=1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = paged_attention(q, kc, vc, length, count_len=1)
    for vl in (1, 64, 65, 700, 1500, 2048, 5):
        length.fill_(vl)
        graph.replay()
        assert torch.equal(out, paged_attention(q, kc, vc, vl)), vl


# ------------------------------------------------------ the decode step
def _cut(arch):
    """``arch`` at full width with 2 layers."""
    return dataclasses.replace(get(arch), n_layers=2)


CONFIGS = {
    "llama3-8b-reduced": (lambda: reduced(get("llama3-8b")), 2, 128),
    "qwen3-32b-cut": (lambda: _cut("qwen3-32b"), 4, 2048),
    "mistral-large-123b-cut": (lambda: _cut("mistral-large-123b"), 4, 2048),
}


def _decode_run(model, params, toks, steps, max_len):
    """Prefill ``toks`` and ``steps`` greedy decode steps with a recorder
    on the model: each step's logits (copied), the tokens, the cache, the
    recorder's counters and the ``paged_attention`` launches of the
    steps."""
    model.trace = ServeTrace()
    logits, cache = model.prefill(params, toks, max_len=max_len)
    outs, tokens = [], []
    before = paged_attention.launches
    for _ in range(steps):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        tokens.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
        outs.append(logits.clone())
    torch.cuda.synchronize()
    launches = paged_attention.launches - before
    counters = model.trace.counters()
    model.trace = None
    return outs, torch.cat(tokens, 1), cache, counters, launches


def _kinds(counters):
    return {k.rsplit(".", 1)[1]: v for k, v in counters.items()
            if k.startswith("serve.decode.")}


def _same_cache(a, b):
    return all(torch.equal(x, y) for (xa, xb), (ya, yb) in
               zip(a["layers"], b["layers"])
               for x, y in ((xa, ya), (xb, yb)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graphed_decode_equals_eager(name):
    """24 decode steps from position 50 (across the 64-position split
    edge): the graphed model (one capture, 23 replays) against the same
    model with its graph turned off, bit for bit in logits, greedy tokens
    and caches; ``paged_attention``'s launches count layers x steps on
    both."""
    require_cuda()
    make, B, max_len = CONFIGS[name]
    cfg = make()
    graphed = Model(cfg, device="cuda")
    eager = Model(cfg, device="cuda")
    eager._graphed = False
    assert graphed._graphed
    params = graphed.init(seed=0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, 50)), dtype=torch.int64, device="cuda")
    want = _decode_run(eager, params, toks, 24, max_len)
    got = _decode_run(graphed, params, toks, 24, max_len)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1])
    assert got[2]["length"] == want[2]["length"] == 74
    assert _same_cache(got[2], want[2])
    assert got[4] == want[4] == cfg.n_layers * 24
    assert _kinds(want[3]) == {"eager": 24, "graph_captures": 0,
                               "graph_replays": 0}
    assert _kinds(got[3]) == {"eager": 0, "graph_captures": 1,
                              "graph_replays": 23}


def test_graph_recaptured_for_another_batch():
    """A batch of another size (a new cache and token shape) captures anew
    and equals the eager step; a prefill into that batch's cache refills
    its pages in place and replays the graph captured for it, with no new
    capture."""
    require_cuda()
    cfg = reduced(get("llama3-8b"))
    graphed = Model(cfg, device="cuda")
    eager = Model(cfg, device="cuda")
    eager._graphed = False
    params = graphed.init(seed=1)
    rng = np.random.default_rng(1)
    for B in (4, 2):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, 30)),
                               dtype=torch.int64, device="cuda")
        got = _decode_run(graphed, params, toks, 5, 128)
        want = _decode_run(eager, params, toks, 5, 128)
        assert _kinds(got[3]) == {"eager": 0, "graph_captures": 1,
                                  "graph_replays": 4}
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert _same_cache(got[2], want[2])
    cache = got[2]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 20)),
                           dtype=torch.int64, device="cuda")
    graphed.trace = ServeTrace()
    logits, cache2 = graphed.prefill(params, toks, max_len=128, cache=cache)
    assert cache2["layers"][0][0].data_ptr() == \
        cache["layers"][0][0].data_ptr()
    for _ in range(3):
        logits, cache2 = graphed.decode_step(
            params, cache2, logits[:, -1].argmax(-1, keepdim=True))
    assert _kinds(graphed.trace.counters()) == {
        "eager": 0, "graph_captures": 0, "graph_replays": 3}
    graphed.trace = None


def test_engine_captures_once_across_its_prefills():
    """A reduced llama3 engine on the card (four requests sharing a
    prefix, two slots, so two waves and two prefills): the second prefill
    refills the first one's pages in place, one capture, every later
    decode step replayed, and the served tokens of the same engine with
    its graph off."""
    require_cuda()
    from repro_torch.serving import PoolConfig, Request, ServeEngine

    def serve(graph: bool):
        model = Model(reduced(get("llama3-8b")), device="cuda")
        model._graphed = graph
        eng = ServeEngine(model, model.init(seed=2), max_batch=2,
                          max_len=128, pool_cfg=PoolConfig(
                              n_pages=256, n_buckets=64, slots_per_bucket=4))
        tr = eng.enable_trace()
        pages, inner = [], model.prefill

        def prefill(*args, **kw):           # the storage of each prefill
            out = inner(*args, **kw)
            pages.append(out[1]["layers"][0][0].data_ptr())
            return out
        model.prefill = prefill
        rng = np.random.default_rng(2)
        shared = rng.integers(0, 128, 64).astype(np.int32)
        for i in range(4):
            tail = rng.integers(0, 128, 16).astype(np.int32)
            eng.submit(Request(rid=i, prompt=np.concatenate([shared, tail]),
                               max_new=6))
        done = eng.run(max_ticks=60)
        c = tr.counters()
        assert len(pages) == 2 and pages[1] == pages[0]
        return ([(r.rid, r.out) for r in done], _kinds(c),
                len(tr.of("serve.decode")), len(tr.of("serve.prefill")),
                c["serve.launches.paged_attention"], tr)

    got, want = serve(True), serve(False)
    assert got[0] == want[0] and len(got[0]) == 4
    n = got[2]
    assert got[3] == 2 and n == want[2] > 2
    assert got[1] == {"eager": 0, "graph_captures": 1,
                      "graph_replays": n - 1}
    assert want[1] == {"eager": n, "graph_captures": 0, "graph_replays": 0}
    assert got[4] == want[4] == 2 * n          # 2 attention layers a step
    tr = got[5]                                # a replay takes no model span
    mix = {s.parent for s in tr.of("model.mix")}
    assert sum(s.index in mix for s in tr.of("serve.decode")) == 1


FAMILIES = ["kimi-k2-1t-a32b", "jamba-1.5-large-398b", "xlstm-350m",
            "whisper-medium"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_other_families_decode_eagerly(arch):
    """The MoE, jamba, the xLSTM and whisper keep the eager step on the
    card: every step counted ``eager``, no graph captured or replayed."""
    require_cuda()
    cfg = reduced(get(arch))
    model = Model(cfg, device="cuda")
    assert not model._graphed
    params = model.init(seed=3)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 24)),
                           dtype=torch.int64, device="cuda")
    frames = None
    if cfg.enc_dec:
        frames = torch.as_tensor(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model), dtype=np.float32), device="cuda")
    model.trace = ServeTrace()
    logits, cache = model.prefill(params, toks, frames=frames, max_len=128)
    for _ in range(3):
        logits, cache = model.decode_step(
            params, cache, logits[:, -1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    assert _kinds(model.trace.counters()) == {
        "eager": 3, "graph_captures": 0, "graph_replays": 0}
    assert model._graph is None and bool(torch.isfinite(logits).all())
