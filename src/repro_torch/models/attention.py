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
updated in place.

Counterpart of the serving half of the JAX package's
``models/attention.py``; cross-attention and the training path are not
ported yet (ROADMAP A9).
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention
from .common import ParamInit, apply_rope, rms_norm


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


def attn_decode(p, x, pos: int, rope, kc, vc, *, qk_norm: bool):
    """x: (B, 1, D) at cache position ``pos`` (``rope`` holds its angles).
    Commits the token's K/V into its page, then attends over ``pos + 1``
    positions (``paged_attention``)."""
    nb, tb, B, KV, hd = kc.shape
    if pos >= nb * tb:
        raise ValueError(f"attn_decode: position {pos} past the cache's "
                         f"{nb * tb} slots")
    q, k, v = project_qkv(p, x, rope, qk_norm)
    kc.view(nb * tb, B, KV, hd)[pos] = k[:, 0]
    vc.view(nb * tb, B, KV, hd)[pos] = v[:, 0]
    o = paged_attention(q[:, 0], kc, vc, pos + 1)[:, None]
    return _out(p, o)
