"""The dense decoder LM: the training forward and loss, and prefill and
decode against the page-major KV cache.

The parameter tree is the JAX package's, as plain nested dicts of tensors:
``embed`` (Vp, D), ``final_norm`` (D,), ``lm_head`` (D, Vp) unless tied,
and ``layers[0]``, one superblock position whose leaves are stacked over
the ``n_super`` layers.  Methods take the tree explicitly, as the JAX
``Model`` does, so the tests can run the JAX package's parameters
(``models/convert.py``).  Layers run in a Python loop over the stack.

Which configurations run the dense stack follows the reference's
``superblock``: a family that is neither ``ssm`` nor ``hybrid``, with no
MoE and no encoder-decoder, is one attention + dense-FFN layer repeated
``n_layers`` times.  That covers ``dense`` and ``vlm`` (chameleon's
early-fusion backbone: its image tokens are ordinary vocabulary ids).

Counterpart of the dense-family paths of the JAX package's
``models/model.py``.  Not ported yet (ROADMAP A9.2): the other families
(MoE, mamba, xlstm, whisper's encoder-decoder).  The mesh and its
sharding constraints have no single-card use and are left out.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.heap import resolve_device
from . import attention as A
from . import ffn as F
from .common import (ParamInit, dtype_of, embed_lookup, lm_head,
                     pad_to_multiple, rms_norm, rope_angles,
                     softmax_cross_entropy)

PAGE_TOKENS = 1024      # t_blk of the KV cache's pages


def runs_dense_stack(cfg: ArchConfig) -> bool:
    """The reference's ``superblock`` rule for the dense stack: neither
    recurrent family, no MoE FFN, no encoder-decoder."""
    return (cfg.family not in ("ssm", "hybrid") and cfg.moe is None
            and not cfg.enc_dec)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class Model(torch.nn.Module):
    """A dense-family model on one device: pure-function API over an
    explicit parameter tree (it registers no parameters itself)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if not runs_dense_stack(cfg):
            raise NotImplementedError(
                f"{cfg.arch_id}: only the dense stack (families dense and "
                "vlm) is ported; MoE, mamba, xlstm and encoder-decoder "
                "models wait (ROADMAP A9.2)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_super = cfg.n_layers
        self.vocab_p = pad_to_multiple(cfg.vocab, 256)
        self.dtype = dtype_of(cfg.dtype)

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
        cfg, n = self.cfg, self.n_super
        tree: Dict[str, Any] = {
            "embed": pi.param((self.vocab_p, cfg.d_model), init="embed",
                              scale=0.02),
            "final_norm": pi.param((cfg.d_model,), init="ones"),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = pi.param((cfg.d_model, self.vocab_p))
        tree["layers"] = [{
            "ln1": pi.param((n, cfg.d_model), init="ones"),
            "attn": A.make_attn_params(pi, n, cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.hd, cfg.qk_norm),
            "ln2": pi.param((n, cfg.d_model), init="ones"),
            "ffn": F.make_dense_ffn_params(pi, n, cfg.d_model, cfg.d_ff),
        }]
        return tree

    # ------------------------------------------------------------ forward --
    def _embed(self, params, tokens):
        return embed_lookup(params["embed"], tokens).to(self.dtype)

    def _head(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return lm_head(x, params["embed"], transpose=True)
        return lm_head(x, params["lm_head"], transpose=False)

    def _ffn(self, p, x):
        return x + F.dense_ffn(p["ffn"], rms_norm(x, p["ln2"],
                                                  self.cfg.norm_eps))

    # ----------------------------------------------------------- training --
    def _train_block(self, p, x, rope):
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + A.attn_train(p["attn"], h, rope, qk_norm=cfg.qk_norm,
                             q_chunk=cfg.attn_chunk_q)
        return self._ffn(p, x)

    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, Vp) in f32: the training forward,
        differentiable in ``params``.  With ``cfg.remat == "block"`` each
        layer's activations are recomputed in the backward pass
        (``checkpoint``), the counterpart of the reference's
        ``jax.checkpoint`` over its scanned layer."""
        cfg = self.cfg
        S = tokens.shape[1]
        rope = rope_angles(torch.arange(S, device=self.device), cfg.hd,
                           cfg.rope_theta)
        remat = cfg.remat != "none" and torch.is_grad_enabled()
        x = self._embed(params, tokens)
        for i in range(self.n_super):
            p = _layer(params["layers"][0], i)
            if remat:
                x = checkpoint(self._train_block, p, x, rope,
                               use_reentrant=False)
            else:
                x = self._train_block(p, x, rope)
        return self._head(params, x)

    def loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` = {"tokens",
        "labels"} (labels -1 are masked), in f32."""
        logits = self.forward(params, batch["tokens"])
        return softmax_cross_entropy(logits, batch["labels"], self.cfg.vocab)

    # ----------------------------------------------------------- serving --
    def cache_blocks(self, max_len: int) -> int:
        return max(1, max_len // PAGE_TOKENS)

    def init_cache(self, batch: int, max_len: int,
                   prompt_len: Optional[int] = None) -> Dict[str, Any]:
        """Zeroed decode cache: ``layers[0]`` = (kc, vc), each
        (n_super, n_blocks, t_blk, B, KV, hd); ``length`` = tokens stored."""
        cfg = self.cfg
        nb = self.cache_blocks(max_len)
        shp = (self.n_super, nb, max_len // nb, batch, cfg.n_kv_heads,
               cfg.hd)
        mk = lambda: torch.zeros(shp, dtype=self.dtype, device=self.device)
        return {"layers": [(mk(), mk())], "length": prompt_len or 0}

    def prefill(self, params, tokens: torch.Tensor, max_len: int = 0):
        """tokens (B, S) -> (last-token logits (B, 1, Vp) f32, cache).

        ``max_len`` (>= prompt length) sizes the block-paged cache; it is
        at least the prompt length padded to the 1024-token page size.
        One ``flash_attention`` launch per layer on the card."""
        cfg = self.cfg
        B, S = tokens.shape
        max_len = max(max_len, pad_to_multiple(S, PAGE_TOKENS))
        cache = self.init_cache(B, max_len, prompt_len=S)
        kc, vc = cache["layers"][0]
        rope = rope_angles(torch.arange(S, device=self.device), cfg.hd,
                           cfg.rope_theta)
        x = self._embed(params, tokens)
        for i in range(self.n_super):
            p = _layer(params["layers"][0], i)
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + A.attn_prefill(p["attn"], h, rope, kc[i], vc[i],
                                   qk_norm=cfg.qk_norm)
            x = self._ffn(p, x)
        return self._head(params, x[:, -1:]), cache

    def decode_step(self, params, cache, token: torch.Tensor):
        """token (B, 1); cache from ``prefill``, updated in place and
        returned with ``length`` + 1.  One serve step: one
        ``paged_attention`` launch per layer on the card."""
        cfg = self.cfg
        pos = int(cache["length"])
        rope = rope_angles(torch.tensor([pos], device=self.device), cfg.hd,
                           cfg.rope_theta)
        kc, vc = cache["layers"][0]
        x = self._embed(params, token)
        for i in range(self.n_super):
            p = _layer(params["layers"][0], i)
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + A.attn_decode(p["attn"], h, pos, rope, kc[i], vc[i],
                                  qk_norm=cfg.qk_norm)
            x = self._ffn(p, x)
        cache["length"] = pos + 1
        return self._head(params, x), cache
