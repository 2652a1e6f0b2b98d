"""GQA attention for serving: prefill through the ``flash_attention``
kernel, decode through the ``paged_attention`` kernel over the page-major
KV cache.

The decode cache of a layer is laid out ``(n_blocks, t_blk, B, KV, hd)``:
the leading block axis is the FUSEE "memory pool" axis, and a (block,
slot) pair is a page address exactly like a FUSEE pointer.  Cache position
``pos`` is block ``pos // t_blk``, slot ``pos % t_blk``, so a layer's pages
viewed as ``(n_blocks * t_blk, B, KV, hd)`` are indexed by position.

Decode follows the JAX package's kernel route (``attn_decode`` with
``use_kernel=True``): the new token's K/V is committed into its page, then
``paged_attention`` runs with ``valid_len = pos + 1``.  The JAX engine's
default decode folds the new token into the softmax instead
(``attn_decode_readonly``); both compute the same function.  The cache is
updated in place.  The position and the length live on the device
(``DecodePos``), so a decode step reads no host number and can be
captured once as a CUDA graph (``Model.decode_step``).

Training runs ``attn_train``: plain torch ops under autograd, the
counterpart of the JAX package's ``flash_attention_jnp`` (no kernel runs
there, as none does in the reference's training path; the hand-written
``flash_attention`` has no backward).

Whisper's encoder self-attention and its decoder's cross-attention over
the encoder's K/V are non-causal: ``flash_attention(..., causal=False)``
when serving (one launch a layer, also at Sq = 1 in decode), and
``flash_attention_train(causal=False)`` in the training forward.

Counterpart of the JAX package's ``models/attention.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention
from .common import ParamInit, apply_rope, rms_norm

NEG_INF = -1e30                     # masked score, as in the reference


def make_attn_params(pi: ParamInit, n: int, d_model: int, n_heads: int,
                     n_kv: int, head_dim: int, qk_norm: bool):
    """``n`` stacked layers of GQA projections in the reference layout:
    wq (D, H, hd), wk/wv (D, KV, hd), wo (H, hd, D)."""
    p = {
        "wq": pi.param((n, d_model, n_heads, head_dim), fan_in=d_model),
        "wk": pi.param((n, d_model, n_kv, head_dim), fan_in=d_model),
        "wv": pi.param((n, d_model, n_kv, head_dim), fan_in=d_model),
        "wo": pi.param((n, n_heads, head_dim, d_model),
                       fan_in=n_heads * head_dim),
    }
    if qk_norm:
        p["q_norm"] = pi.param((n, head_dim), init="ones")
        p["k_norm"] = pi.param((n, head_dim), init="ones")
    return p


def project_qkv(p, x, rope, qk_norm: bool):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd), rope applied.
    ``rope`` = ``rope_angles`` of the S positions, computed once per
    forward pass by the model (every layer shares it)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _q_chunk_attn(qc, k, v, q0: int, causal: bool):
    """One query chunk: qc (B, qc, H, hd) at positions q0.., k/v (B, Skv,
    H, hd) already repeated to H heads.  Scores and the P V product in f32
    (bf16 operands are exact in f32, as the reference's
    ``preferred_element_type``), P rounded to q's dtype first."""
    dt = qc.dtype
    hd = qc.shape[-1]
    n, skv = qc.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bshd->bhqs", qc.float(), k.float()) * hd ** -0.5
    if causal:
        q_pos = q0 + torch.arange(n, device=qc.device)
        kv_pos = torch.arange(skv, device=qc.device)
        s = s.masked_fill(~(q_pos[:, None] >= kv_pos[None, :]), NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqs,bshd->bqhd", p.to(dt).float(), v.float())
    return (o / l.clamp_min(1e-30).transpose(1, 2)).to(dt)


def flash_attention_train(q, k, v, *, causal: bool, q_chunk: int):
    """Chunked attention for training, under autograd: the JAX package's
    ``flash_attention_jnp``.  q (B, Sq, H, hd); k/v (B, Skv, KV, hd)
    repeated to H heads; queries in chunks of ``q_chunk`` (halved until it
    divides Sq), each chunk recomputed in the backward pass
    (``checkpoint``) instead of keeping its score panel, as the reference's
    ``jax.checkpoint`` over its query scan does."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    q_chunk = min(q_chunk, Sq)
    while Sq % q_chunk:
        q_chunk //= 2
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_q_chunk_attn, qc, k, v, q0, causal,
                                   use_reentrant=False))
        else:
            outs.append(_q_chunk_attn(qc, k, v, q0, causal))
    return torch.cat(outs, dim=1)


def attn_train(p, x, rope, *, qk_norm: bool, q_chunk: int):
    """Causal self-attention of the training forward (every position's
    output), through ``flash_attention_train``."""
    q, k, v = project_qkv(p, x, rope, qk_norm)
    return _out(p, flash_attention_train(q, k, v, causal=True,
                                         q_chunk=q_chunk))


def _out(p, o):
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


def cache_from_prefill(k, v, kc, vc):
    """Write a prompt's K/V (B, S, KV, hd) into a layer's zeroed pages
    (n_blocks, t_blk, B, KV, hd), positions 0..S-1, in place."""
    nb, tb, B, KV, hd = kc.shape
    S = k.shape[1]
    kc.view(nb * tb, B, KV, hd)[:S] = k.transpose(0, 1)
    vc.view(nb * tb, B, KV, hd)[:S] = v.transpose(0, 1)


def attn_prefill(p, x, rope, kc, vc, *, qk_norm: bool):
    """Causal attention over the prompt (``flash_attention``), and the
    prompt's K/V written into this layer's pages."""
    q, k, v = project_qkv(p, x, rope, qk_norm)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True).transpose(1, 2)
    cache_from_prefill(k, v, kc, vc)
    return _out(p, o)


class DecodePos(NamedTuple):
    """A decode step's cache position on the model's device: ``index``
    (1,) int64, where the token's K/V is written, and ``valid`` (1,)
    int32 = index + 1, the positions ``paged_attention`` attends over.
    ``count`` is ``valid`` as a host int when the step's body runs, read
    only where a count needs a number (``boundary.plain`` on ``meta``)."""
    index: torch.Tensor
    valid: torch.Tensor
    count: int


def attn_decode(p, x, pos: DecodePos, rope, kc, vc, *, qk_norm: bool):
    """x: (B, 1, D) at cache position ``pos`` (``rope`` holds its angles;
    the caller checks that the position is inside the pages).  Commits
    the token's K/V into its page, then attends over ``pos.valid``
    positions (``paged_attention``)."""
    nb, tb, B, KV, hd = kc.shape
    q, k, v = project_qkv(p, x, rope, qk_norm)
    kc.view(nb * tb, B, KV, hd).index_copy_(0, pos.index, k.transpose(0, 1))
    vc.view(nb * tb, B, KV, hd).index_copy_(0, pos.index, v.transpose(0, 1))
    o = paged_attention(q[:, 0], kc, vc, pos.valid,
                        count_len=pos.count)[:, None]
    return _out(p, o)


def attn_encode(p, x, rope, *, qk_norm: bool, train: bool, q_chunk: int):
    """Non-causal self-attention of the encoder (every frame sees every
    frame): ``flash_attention`` when serving, ``flash_attention_train``
    in the training forward."""
    q, k, v = project_qkv(p, x, rope, qk_norm)
    return _out(p, _noncausal(q, k, v, train, q_chunk))


def _noncausal(q, k, v, train: bool, q_chunk: int):
    """q (B, Sq, H, hd) over k/v (B, Skv, KV, hd), no mask."""
    if train:
        return flash_attention_train(q, k, v, causal=False, q_chunk=q_chunk)
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=False).transpose(1, 2)


# ------------------------------------------------------ whisper cross-attn --
def cross_attn_kv(p, enc_out):
    """Cross-attention K/V (B, S_enc, KV, hd) from the encoder's output,
    computed once a request; no rope."""
    dt = enc_out.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt))
    return k, v


def cross_attn(p, x, k, v, *, train: bool, q_chunk: int):
    """Non-causal attention of decoder states x (B, S, D) over the
    encoder's K/V."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    return _out(p, _noncausal(q, k, v, train, q_chunk))
