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


ENC_SPEC = LayerSpec("attn", "dense")


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
                "layers": [_make_layer_params(pi, cfg, ENC_SPEC,
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
        ``cache``), 'decode' (one token at ``pos`` against it)."""
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
               pos=0, tr=None, i=0):
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
                    pos=0, tr=None):
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
            x = self._block(ENC_SPEC, _layer(enc["layers"][0], j), x, mode,
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

    def _layer_caches(self, batch: int, max_len: int) -> list:
        """Zeroed per-position caches, leading dim n_super: attention
        pages (kc, vc), each (n_super, n_blocks, t_blk, B, KV, hd), or a
        recurrent state in the reference's ``init_cache`` shapes and
        dtypes."""
        cfg, n = self.cfg, self.n_super
        nb = self.cache_blocks(max_len)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)
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
                frames: Optional[torch.Tensor] = None, max_len: int = 0):
        """tokens (B, S) -> (last-token logits (B, 1, Vp) f32, cache).

        ``max_len`` (>= prompt length) sizes the block-paged cache; it is
        at least the prompt length padded to the 1024-token page size.
        An encoder-decoder encodes ``frames`` first and carries the cross
        K/V in ``cache["cross"]``.  One ``flash_attention`` launch per
        attention layer on the card (and per encoder layer and cross-
        attention)."""
        B, S = tokens.shape
        max_len = max(max_len, pad_to_multiple(S, PAGE_TOKENS))
        cache = {"layers": self._layer_caches(B, max_len), "length": S,
                 "cross": None}
        if self.cfg.enc_dec:
            cache["cross"] = self._cross_kv(params,
                                            self.encode(params, frames))
        rope = self._rope(torch.arange(S, device=self.device))
        x = self._traced("model.embed", self._embed, params, tokens)
        for j in range(self.n_super):
            x = self._superblock(params["layers"], x, j, "prefill", rope,
                                 cache["layers"], cache["cross"],
                                 tr=self.trace)
        return (self._traced("model.head", self._head, params, x[:, -1:]),
                cache)

    def decode_step(self, params, cache, token: torch.Tensor):
        """token (B, 1); cache from ``prefill``, updated in place and
        returned with ``length`` + 1.  One serve step: one
        ``paged_attention`` launch per attention layer on the card (and
        one ``flash_attention`` per cross-attention)."""
        pos = int(cache["length"])
        rope = self._rope(torch.tensor([pos], device=self.device))
        x = self._traced("model.embed", self._embed, params, token)
        for j in range(self.n_super):
            x = self._superblock(params["layers"], x, j, "decode", rope,
                                 cache["layers"], cache.get("cross"), pos,
                                 self.trace)
        cache["length"] = pos + 1
        return self._traced("model.head", self._head, params, x), cache

    def _traced(self, name: str, fn, *args):
        """``fn(*args)`` in span ``name`` when a recorder is set."""
        if self.trace is None:
            return fn(*args)
        span = self.trace.begin(name)
        out = fn(*args)
        self.trace.end(span)
        return out
