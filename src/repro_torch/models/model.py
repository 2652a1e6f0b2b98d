"""The LM of every configuration: the training forward and loss, and
prefill and decode against the page-major KV cache and the recurrent
states.

Every architecture is a *superblock*, a short repeating pattern of layers
(``superblock``: jamba's 8 positions, 1 attention and 7 mamba, MoE on the
odd ones; xlstm's 3 mLSTM and 1 sLSTM; one layer for the rest) repeated
``n_super`` times.  The parameter tree is the JAX package's, as plain
nested dicts of tensors: ``embed`` (Vp, D), ``final_norm`` (D,),
``lm_head`` (D, Vp) unless tied, ``layers`` (one tree per superblock
position, its leaves stacked over ``n_super``), and for the
encoder-decoder ``enc`` (``layers``, ``final_norm``, ``pos_embed``).
Methods take the tree explicitly, as the JAX ``Model`` does, so the tests
can run the JAX package's parameters (``models/convert.py``).  The
superblocks run in a Python loop.

Attention layers prefill through ``flash_attention`` and decode through
``paged_attention`` (``attention.py``); whisper's encoder and
cross-attention are non-causal ``flash_attention`` launches.  Mamba, mLSTM
and sLSTM layers, the MoE and the training forward are plain torch.

A dense decoder on the card replays its decode step as one CUDA graph
(``_DecodeGraph``): a step is some 1 000-4 000 small kernels, and eagerly
the host's launching of them paces the card.  The step reads its position
from the device (``attention.DecodePos``), so one body serves the graph
and the eager step of every other model and device.

Counterpart of the JAX package's ``models/model.py``.  The mesh and its
sharding constraints have no single-card use and are left out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.heap import resolve_device
from ..kernels import flash_attention, paged_attention
from . import attention as A
from . import ffn as F
from . import mamba as M
from . import xlstm as X
from .common import (ParamInit, dtype_of, embed_lookup, lm_head,
                     pad_to_multiple, rms_norm, rope_angles,
                     softmax_cross_entropy)

PAGE_TOKENS = 1024      # t_blk of the KV cache's pages


@dataclass(frozen=True)
class LayerSpec:
    mixer: str            # 'attn' | 'mamba' | 'mlstm' | 'slstm'
    ffn: str              # 'dense' | 'moe' | 'moe+dense' | 'none'
    cross: bool = False   # whisper decoder cross-attention


# attention + dense FFN: an encoder's layers, and a graphed step's
DENSE_SPEC = LayerSpec("attn", "dense")
GRAPH_LAUNCHED = (paged_attention, flash_attention)   # counted per replay


def superblock(cfg: ArchConfig) -> Tuple[List[LayerSpec], int]:
    """The repeating pattern of ``cfg``'s layers and its repeat count."""
    if cfg.family == "ssm":  # xlstm
        period = cfg.ssm.slstm_every or 1
        specs = [LayerSpec("mlstm", "none") for _ in range(period - 1)]
        specs += [LayerSpec("slstm", "none")]
        return specs, cfg.n_layers // period
    if cfg.family == "hybrid":  # jamba
        period = cfg.attn_every
        me = cfg.moe.moe_every if cfg.moe else 1
        specs = []
        for i in range(period):
            mixer = "attn" if i % cfg.attn_every == cfg.attn_phase else "mamba"
            ffn = "moe" if (cfg.moe and i % me == me - 1) else "dense"
            specs.append(LayerSpec(mixer, ffn))
        return specs, cfg.n_layers // period
    ffn = "dense"
    if cfg.moe is not None:
        ffn = "moe+dense" if cfg.moe.dense_residual_d_ff else "moe"
    return [LayerSpec("attn", ffn, cross=cfg.enc_dec)], cfg.n_layers


def _make_layer_params(pi: ParamInit, cfg: ArchConfig, spec: LayerSpec,
                       n: int) -> Dict[str, Any]:
    """One superblock position; every leaf has a leading (n,) dim."""
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": pi.param((n, d), init="ones")}
    if spec.mixer == "attn":
        p["attn"] = A.make_attn_params(pi, n, d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.hd, cfg.qk_norm)
    elif spec.mixer == "mamba":
        s = cfg.ssm
        p["mamba"] = M.make_mamba_params(pi, n, d, s.d_state, s.d_conv,
                                         s.expand)
    elif spec.mixer == "mlstm":
        p["mlstm"] = X.make_mlstm_params(pi, n, d, cfg.n_heads)
    elif spec.mixer == "slstm":
        p["slstm"] = X.make_slstm_params(pi, n, d, cfg.n_heads)
    if spec.cross:
        p["ln_x"] = pi.param((n, d), init="ones")
        p["cross"] = A.make_attn_params(pi, n, d, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd, False)
    if spec.ffn != "none":
        p["ln2"] = pi.param((n, d), init="ones")
    if spec.ffn == "dense":
        p["ffn"] = F.make_dense_ffn_params(pi, n, d, cfg.d_ff)
    elif spec.ffn in ("moe", "moe+dense"):
        m = cfg.moe
        p["moe"] = F.make_moe_params(pi, n, d, m.n_experts, m.d_ff_expert)
        if spec.ffn == "moe+dense":
            p["ffn"] = F.make_dense_ffn_params(pi, n, d,
                                               m.dense_residual_d_ff)
    return p


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [t for sub in tree if sub is not None for t in _leaves(sub)]


def _storage(tensors) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


class _DecodeGraph:
    """A dense decode step captured as one CUDA graph for one ``key``
    (the token's shape, the cache's and the parameters' storage): a
    static token and position (``DecodePos``) as its inputs, the step's
    logits as its output, and the kernel launches it holds, which every
    replay adds to those kernels' ``launches``.  The graph fixes the
    addresses of the parameters and the cache pages, so the key holds
    them and the cache is reused across prefills (``Model.prefill``)."""

    def __init__(self, key, token: torch.Tensor, device):
        self.key = key
        self.token = torch.empty_like(token)
        self.pos = A.DecodePos(
            torch.zeros(1, dtype=torch.int64, device=device),
            torch.ones(1, dtype=torch.int32, device=device), 1)
        self.graph = torch.cuda.CUDAGraph()
        self.logits = None
        self.launches = (0,) * len(GRAPH_LAUNCHED)

    def _set(self, token, pos: int) -> None:
        self.token.copy_(token)
        self.pos.index.fill_(pos)
        self.pos.valid.fill_(pos + 1)

    def capture(self, model, params, cache, token, pos: int, tr):
        """This step, run eagerly on a side stream (which also warms up
        what the capture records), then captured there; returns the eager
        run's logits."""
        self._set(token, pos)
        dp = self.pos._replace(count=pos + 1)
        cur = torch.cuda.current_stream(self.token.device)
        side = torch.cuda.Stream(device=self.token.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            logits = model._decode_body(params, cache, self.token, dp, tr)
        cur.wait_stream(side)
        logits.record_stream(cur)
        n0 = [k.launches for k in GRAPH_LAUNCHED]
        with torch.cuda.graph(self.graph, stream=side):
            self.logits = model._decode_body(params, cache, self.token, dp,
                                             None)
        self.launches = tuple(k.launches - n
                              for k, n in zip(GRAPH_LAUNCHED, n0))
        for k, n in zip(GRAPH_LAUNCHED, n0):     # the capture ran nothing
            k.launches = n
        return logits

    def replay(self, token, pos: int) -> torch.Tensor:
        self._set(token, pos)
        self.graph.replay()
        for k, n in zip(GRAPH_LAUNCHED, self.launches):
            k.launches += n
        return self.logits


class Model(torch.nn.Module):
    """A model on one device: pure-function API over an explicit
    parameter tree (it registers no parameters itself)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.specs, self.n_super = superblock(cfg)
        self.vocab_p = pad_to_multiple(cfg.vocab, 256)
        self.dtype = dtype_of(cfg.dtype)
        self.moe_ctx = (F.MoEContext(cfg.moe.n_experts, cfg.moe.top_k,
                                     cfg.moe.capacity_factor)
                        if cfg.moe is not None else None)
        self.trace = None       # ServeEngine.enable_trace sets a recorder
        # whether decode_step replays a graph (the tests clear it to run
        # the eager step on the card)
        self._graphed = (self.device.type == "cuda" and not cfg.enc_dec
                         and all(s == DENSE_SPEC for s in self.specs))
        self._graph: Optional[_DecodeGraph] = None

    # ----------------------------------------------------------- building --
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed`` on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._build(ParamInit(gen, self.dtype, self.device))

    def abstract_params(self) -> Dict[str, Any]:
        """The parameter tree as storage-less ``meta`` tensors (its
        structure, shapes and dtypes)."""
        return self._build(ParamInit(None, self.dtype, self.device))

    def _build(self, pi: ParamInit) -> Dict[str, Any]:
        cfg = self.cfg
        tree: Dict[str, Any] = {
            "embed": pi.param((self.vocab_p, cfg.d_model), init="embed",
                              scale=0.02),
            "final_norm": pi.param((cfg.d_model,), init="ones"),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = pi.param((cfg.d_model, self.vocab_p))
        tree["layers"] = [_make_layer_params(pi, cfg, s, self.n_super)
                          for s in self.specs]
        if cfg.enc_dec:
            tree["enc"] = {
                "layers": [_make_layer_params(pi, cfg, DENSE_SPEC,
                                              cfg.n_enc_layers)],
                "final_norm": pi.param((cfg.d_model,), init="ones"),
                "pos_embed": pi.param((cfg.enc_seq, cfg.d_model),
                                      init="embed", scale=0.02),
            }
        return tree

    # ------------------------------------------------------------- blocks --
    def _embed(self, params, tokens):
        return embed_lookup(params["embed"], tokens).to(self.dtype)

    def _head(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return lm_head(x, params["embed"], transpose=True)
        return lm_head(x, params["lm_head"], transpose=False)

    def _rope(self, positions):
        return rope_angles(positions, self.cfg.hd, self.cfg.rope_theta)

    def _mix(self, spec, p, h, mode, rope, j, cache, pos):
        """The mixer of one layer.  ``mode``: 'train' (causal, under
        autograd), 'encode' / 'encode_train' (non-causal, serving /
        training), 'prefill' (fills superblock ``j`` of this position's
        ``cache``), 'decode' (one token at ``pos``, a ``DecodePos``,
        against it)."""
        cfg = self.cfg
        if spec.mixer == "attn":
            a = p["attn"]
            if mode == "train":
                return A.attn_train(a, h, rope, qk_norm=cfg.qk_norm,
                                    q_chunk=cfg.attn_chunk_q)
            if mode in ("encode", "encode_train"):
                return A.attn_encode(a, h, rope, qk_norm=cfg.qk_norm,
                                     train=mode == "encode_train",
                                     q_chunk=cfg.attn_chunk_q)
            kc, vc = cache
            if mode == "prefill":
                return A.attn_prefill(a, h, rope, kc[j], vc[j],
                                      qk_norm=cfg.qk_norm)
            return A.attn_decode(a, h, pos, rope, kc[j], vc[j],
                                 qk_norm=cfg.qk_norm)
        p = p[spec.mixer]
        if mode == "decode":
            st = type(cache)(*(s[j] for s in cache))
            if spec.mixer == "mamba":
                out, new = M.mamba_decode(p, h, st)
            elif spec.mixer == "mlstm":
                out, new = X.mlstm_decode(p, h, st, n_heads=cfg.n_heads)
            else:
                out, new = X.slstm_decode(p, h, st)
        else:
            if spec.mixer == "mamba":
                out, new = M.mamba_chunked(p, h, chunk=cfg.ssm.chunk)
            elif spec.mixer == "mlstm":
                out, new = X.mlstm_chunked(p, h, chunk=cfg.ssm.chunk,
                                           n_heads=cfg.n_heads)
            else:
                out, new = X.slstm_seq(p, h)
            if mode != "prefill":
                return out
        for s, n in zip(cache, new):       # states keep their dtypes
            s[j].copy_(n)
        return out

    def _block(self, spec, p, x, mode, rope, j=0, cache=None, xkv=None,
               pos=None, tr=None, i=0):
        """Layer ``i`` of superblock ``j``; with a recorder ``tr``, its
        mixer and its FFN each in a span."""
        cfg = self.cfg
        if tr is not None:
            layer = j * len(self.specs) + i
            span = tr.begin("model.mix", layer)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + self._mix(spec, p, h, mode, rope, j, cache, pos)
        if spec.cross and xkv is not None:
            hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
            x = x + A.cross_attn(p["cross"], hx, xkv[0][j], xkv[1][j],
                                 train=mode == "train",
                                 q_chunk=cfg.attn_chunk_q)
        if tr is not None:
            tr.end(span)
        if spec.ffn != "none":
            if tr is not None:
                span = tr.begin("model.ffn", layer)
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            out = None
            if "moe" in spec.ffn:
                out = F.moe_ffn(self.moe_ctx, p["moe"], h2)
            if "dense" in spec.ffn:
                d = F.dense_ffn(p["ffn"], h2)
                out = d if out is None else out + d
            x = x + out
            if tr is not None:
                tr.end(span)
        return x

    def _superblock(self, layers, x, j, mode, rope, caches=None, xkv=None,
                    pos=None, tr=None):
        """Superblock ``j``: every position in order (in spans where a
        recorder ``tr`` is given: ``prefill`` and ``decode_step``)."""
        for i, spec in enumerate(self.specs):
            if tr is not None:
                span = tr.begin("model.select", j * len(self.specs) + i)
            p = _layer(layers[i], j)
            if tr is not None:
                tr.end(span)
            x = self._block(spec, p, x, mode, rope, j,
                            caches[i] if caches is not None else None,
                            xkv[i] if xkv is not None else None, pos, tr,
                            i)
        return x

    # ------------------------------------------------------ the encoder --
    def encode(self, params, frames: torch.Tensor,
               train: bool = False) -> torch.Tensor:
        """Whisper's encoder over precomputed frame embeddings (B, S_enc,
        D): non-causal self-attention through ``flash_attention`` (one
        launch a layer), or under autograd with ``train``."""
        enc = params["enc"]
        S = frames.shape[1]
        x = (frames + enc["pos_embed"][None, :S]).to(self.dtype)
        rope = self._rope(torch.arange(S, device=self.device))
        mode = "encode_train" if train else "encode"
        for j in range(self.cfg.n_enc_layers):
            x = self._block(DENSE_SPEC, _layer(enc["layers"][0], j), x, mode,
                            rope)
        return rms_norm(x, enc["final_norm"], self.cfg.norm_eps)

    def _cross_kv(self, params, enc_out):
        """Per superblock position: the cross K/V of every layer, each
        (n_super, B, S_enc, KV, hd), or None."""
        out = []
        for i, spec in enumerate(self.specs):
            if not spec.cross:
                out.append(None)
                continue
            cp = params["layers"][i]["cross"]
            dt = enc_out.dtype
            out.append(tuple(torch.einsum("bsd,ldhk->lbshk", enc_out,
                                          cp[w].to(dt))
                             for w in ("wk", "wv")))
        return out

    # ----------------------------------------------------------- training --
    def forward(self, params, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, Vp) in f32: the training forward,
        differentiable in ``params``; ``frames`` are the encoder's inputs
        of an encoder-decoder.  With ``cfg.remat == "block"`` each
        superblock's activations are recomputed in the backward pass
        (``checkpoint``), the counterpart of the reference's
        ``jax.checkpoint`` over its scanned superblock."""
        cfg = self.cfg
        S = tokens.shape[1]
        rope = self._rope(torch.arange(S, device=self.device))
        xkv = None
        if cfg.enc_dec:
            xkv = self._cross_kv(params, self.encode(params, frames,
                                                     train=True))
        remat = cfg.remat != "none" and torch.is_grad_enabled()
        x = self._embed(params, tokens)
        for j in range(self.n_super):
            args = (params["layers"], x, j, "train", rope, None, xkv)
            x = (checkpoint(self._superblock, *args, use_reentrant=False)
                 if remat else self._superblock(*args))
        return self._head(params, x)

    def loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` = {"tokens",
        "labels"[, "frames"]} (labels -1 are masked), in f32."""
        logits = self.forward(params, batch["tokens"], batch.get("frames"))
        return softmax_cross_entropy(logits, batch["labels"], self.cfg.vocab)

    # ----------------------------------------------------------- serving --
    def cache_blocks(self, max_len: int) -> int:
        return max(1, max_len // PAGE_TOKENS)

    def cache_len(self, seq: int, max_len: int) -> int:
        """The positions of the cache ``prefill`` builds for ``seq``
        prompt tokens at ``max_len``."""
        return max(max_len, pad_to_multiple(seq, PAGE_TOKENS))

    def cache_fits(self, cache, batch: int, seq: int, max_len: int) -> bool:
        """Whether ``cache`` holds the pages and states, in shape and
        dtype, that ``prefill`` of (batch, seq) tokens at ``max_len``
        would build (so it can refill them in place)."""
        if cache is None:
            return False
        want = self._layer_caches(batch, self.cache_len(seq, max_len),
                                  device="meta")
        have = _leaves(cache["layers"])
        dev = self.device           # "cuda" names the current card
        here = all(t.device.type == dev.type
                   and dev.index in (None, t.device.index) for t in have)
        return here and [(t.shape, t.dtype) for t in have] == \
            [(t.shape, t.dtype) for t in _leaves(want)]

    def _layer_caches(self, batch: int, max_len: int, device=None) -> list:
        """Zeroed per-position caches, leading dim n_super: attention
        pages (kc, vc), each (n_super, n_blocks, t_blk, B, KV, hd), or a
        recurrent state in the reference's ``init_cache`` shapes and
        dtypes (on ``device``, default the model's)."""
        cfg, n = self.cfg, self.n_super
        nb = self.cache_blocks(max_len)
        device = device or self.device

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)
        out = []
        for spec in self.specs:
            if spec.mixer == "attn":
                shp = (n, nb, max_len // nb, batch, cfg.n_kv_heads, cfg.hd)
                out.append((z(*shp, dtype=self.dtype),
                            z(*shp, dtype=self.dtype)))
            elif spec.mixer == "mamba":
                s = cfg.ssm
                d_in = s.expand * cfg.d_model
                nh = max(1, d_in // 128)
                out.append(M.MambaState(
                    h=z(n, batch, nh, d_in // nh, s.d_state),
                    conv=z(n, batch, s.d_conv - 1, d_in, dtype=self.dtype)))
            elif spec.mixer == "mlstm":
                P = int(cfg.d_model * 2.0) // cfg.n_heads
                out.append(X.MLSTMState(c=z(n, batch, cfg.n_heads, P, P),
                                        n=z(n, batch, cfg.n_heads, P),
                                        m=z(n, batch, cfg.n_heads)))
            else:
                out.append(X.SLSTMState(*(z(n, batch, cfg.d_model)
                                          for _ in range(4))))
        return out

    def init_cache(self, batch: int, max_len: int,
                   prompt_len: Optional[int] = None) -> Dict[str, Any]:
        """Zeroed decode cache: ``layers`` (``_layer_caches``), ``length``
        = tokens stored, ``cross`` = per position the cross K/V (n_super,
        B, S_enc, KV, hd) pair of an encoder-decoder, else None."""
        cfg = self.cfg
        cross = None
        if cfg.enc_dec:
            shp = (self.n_super, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
            cross = [tuple(torch.zeros(shp, dtype=self.dtype,
                                       device=self.device) for _ in range(2))
                     for _ in self.specs]
        return {"layers": self._layer_caches(batch, max_len),
                "length": prompt_len or 0, "cross": cross}

    def prefill(self, params, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None, max_len: int = 0,
                cache: Optional[Dict[str, Any]] = None):
        """tokens (B, S) -> (last-token logits (B, 1, Vp) f32, cache).

        ``max_len`` (>= prompt length) sizes the block-paged cache; it is
        at least the prompt length padded to the 1024-token page size.
        A ``cache`` of an earlier prefill whose pages fit (``cache_fits``)
        is zeroed and refilled in place, so its storage, which a captured
        decode step reads, stays where it is; else new pages are built.
        An encoder-decoder encodes ``frames`` first and carries the cross
        K/V in ``cache["cross"]``.  One ``flash_attention`` launch per
        attention layer on the card (and per encoder layer and cross-
        attention)."""
        B, S = tokens.shape
        max_len = self.cache_len(S, max_len)
        if self.cache_fits(cache, B, S, max_len):
            layers = cache["layers"]
            for t in _leaves(layers):
                t.zero_()
        else:
            layers = self._layer_caches(B, max_len)
        cache = {"layers": layers, "length": S, "cross": None}
        if self.cfg.enc_dec:
            cache["cross"] = self._cross_kv(params,
                                            self.encode(params, frames))
        rope = self._rope(torch.arange(S, device=self.device))
        tr = self.trace
        x = self._traced(tr, "model.embed", self._embed, params, tokens)
        for j in range(self.n_super):
            x = self._superblock(params["layers"], x, j, "prefill", rope,
                                 cache["layers"], cache["cross"], tr=tr)
        return (self._traced(tr, "model.head", self._head, params,
                             x[:, -1:]), cache)

    def decode_step(self, params, cache, token: torch.Tensor):
        """token (B, 1); cache from ``prefill``, updated in place and
        returned with ``length`` + 1.  One serve step: one
        ``paged_attention`` launch per attention layer on the card (and
        one ``flash_attention`` per cross-attention).

        A dense decoder on the card (``_graphed``: every layer attention
        and a dense FFN, no cross-attention) captures the step as a CUDA
        graph the first time it runs at a token shape, cache storage and
        parameter storage, and replays it at every later step with the
        token and the position copied in; the logits it returns are then
        the graph's output, overwritten by the next step.  Other models,
        and every CPU and ``meta`` run, run the same body eagerly.  With
        a recorder each step counts ``serve.decode.eager``,
        ``.graph_captures`` or ``.graph_replays``; the model's spans are
        taken on the steps that run eagerly (a capture's first run among
        them), not on a replay."""
        pos = int(cache["length"])
        self._check_room(cache, pos)
        tr = self.trace
        key = self._graph_key(params, cache, token)
        g = self._graph
        if key is None:
            dp = A.DecodePos(
                torch.full((1,), pos, dtype=torch.int64, device=self.device),
                torch.full((1,), pos + 1, dtype=torch.int32,
                           device=self.device), pos + 1)
            logits = self._decode_body(params, cache, token, dp, tr)
            kind = "eager"
        elif g is not None and g.key == key:
            logits = g.replay(token, pos)
            kind = "graph_replays"
        else:
            self._graph = None          # free the old graph's pool first
            self._graph = _DecodeGraph(key, token, self.device)
            logits = self._graph.capture(self, params, cache, token, pos, tr)
            kind = "graph_captures"
        if tr is not None:
            tr.count("serve.decode." + kind)
        cache["length"] = pos + 1
        return logits, cache

    def _check_room(self, cache, pos: int) -> None:
        """Raise unless position ``pos`` is inside the attention pages."""
        for spec, c in zip(self.specs, cache["layers"]):
            if spec.mixer == "attn":
                nb, tb = c[0].shape[1:3]
                if pos >= nb * tb:
                    raise ValueError(f"decode_step: position {pos} past "
                                     f"the cache's {nb * tb} slots")
                return

    def _graph_key(self, params, cache, token) -> Optional[tuple]:
        """What a captured step is valid for, or None where the step runs
        eagerly (not ``_graphed``, or under autograd)."""
        if not self._graphed:
            return None
        leaves = _leaves(params)
        if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
            return None
        return (tuple(token.shape), token.dtype, token.device,
                _storage(_leaves(cache["layers"])), _storage(leaves))

    def _decode_body(self, params, cache, token, pos: A.DecodePos, tr):
        """The decode step's kernels: the same eagerly and under capture
        (``tr``, the recorder, is None there)."""
        rope = self._rope(pos.index)
        x = self._traced(tr, "model.embed", self._embed, params, token)
        for j in range(self.n_super):
            x = self._superblock(params["layers"], x, j, "decode", rope,
                                 cache["layers"], cache.get("cross"), pos,
                                 tr)
        return self._traced(tr, "model.head", self._head, params, x)

    @staticmethod
    def _traced(tr, name: str, fn, *args):
        """``fn(*args)`` in span ``name`` when a recorder ``tr`` is set."""
        if tr is None:
            return fn(*args)
        span = tr.begin(name)
        out = fn(*args)
        tr.end(span)
        return out
