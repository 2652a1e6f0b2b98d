"""Shared model components: parameter init, RMSNorm, RoPE, embeddings, the
LM head, the training loss, dtype policy, and ``sampled``, the counted
form of a sequential loop.

Parameters are plain nested dicts of tensors in the JAX package's layout
(``models/convert.py`` maps its trees over one to one).  Init draws from an
explicit ``torch.Generator`` on the parameters' device, so a model's
weights are a function of its seed; they are not the JAX package's draws
(``jax.random`` and torch give different numbers from one seed).

Counterpart of the JAX package's ``models/common.py``; the logical-axes
bookkeeping for sharding has no single-card use and is left out.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class ParamInit:
    """Draws parameters of one dtype on one device from a seeded
    generator, with the JAX package's init rules (normal with std
    ``scale / sqrt(fan_in)``, ones, zeros, scaled-normal embeddings).
    With no generator it draws nothing and returns storage-less tensors on
    the ``meta`` device: a tree's structure, shapes and dtypes (what a
    checkpoint restore needs)."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        self.gen = generator
        self.dtype = dtype
        self.device = device

    def param(self, shape: Sequence[int], init: str = "normal",
              scale: float = 1.0, fan_in: Optional[int] = None):
        shape = tuple(shape)
        if self.gen is None:
            return torch.empty(shape, dtype=self.dtype, device="meta")
        if init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if init == "normal":
            if fan_in is None:
                fan_in = shape[-2] if len(shape) > 1 else max(shape[0], 1)
            std = scale / math.sqrt(fan_in)
        elif init == "embed":
            std = scale
        else:
            raise ValueError(init)
        val = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                          device=self.device)
        return val.mul_(std).to(self.dtype)


# ---------------------------------------------------------- counted loops --
LOOP_SCALES: List[int] = []     # trip counts of the sampled loops running
SAMPLING = [False]              # set by ``launch.roofline.count``


def sampled(steps: range, device: torch.device, *,
            own_graph: bool = False) -> Iterator[int]:
    """The steps of a sequential loop whose bodies all cost the same.

    All of ``steps``, except on ``meta`` while a counter samples loops
    (``launch.roofline.count``): then only the first runs, with
    ``len(steps)`` pushed on ``LOOP_SCALES`` so that the counter scales the
    costs of its ops by the trip count, the counterpart of the JAX
    package's ``trip_count`` x body.  The caller gives the steps that did
    not run empty outputs of their shape (``fill``).

    A loop whose autograd graph crosses its steps runs in full unless its
    body's backward also runs inside the body (``own_graph``): a backward
    after the loop would be counted once, and the gradients the full loop
    accumulates across steps would be missing."""
    n = len(steps)
    if not (SAMPLING[0] and n > 1 and device.type == "meta"
            and (own_graph or not torch.is_grad_enabled())):
        yield from steps
        return
    LOOP_SCALES.append(n)
    try:
        yield steps[0]
    finally:
        LOOP_SCALES.pop()


def fill(outs: list, n: int) -> list:
    """``outs`` padded to ``n`` entries with an empty tensor of its first
    entry's shape: the outputs of a loop's steps that ``sampled`` did not
    run (nothing to pad when every step ran)."""
    if len(outs) == n:
        return outs
    return outs + [torch.empty_like(outs[0])] * (n - len(outs))


# ---------------------------------------------------------------- numerics --
def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * gain.float()).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, hd//2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- embeddings --
def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def lm_head(x: torch.Tensor, table: torch.Tensor, transpose: bool):
    """x: (B,S,D) -> logits (B,S,Vp) in f32.  The product runs in x's dtype
    with f32 accumulation (cuBLAS and the CPU's bf16 GEMMs accumulate in
    f32); bf16 logits are widened after rounding."""
    w = table.to(x.dtype)
    if transpose:
        return torch.einsum("bsd,vd->bsv", x, w).float()
    return torch.einsum("bsd,dv->bsv", x, w).float()


# ------------------------------------------------------------------- loss --
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab: int) -> torch.Tensor:
    """logits (B, S, Vp); labels (B, S) with -1 = masked.  ``vocab`` is the
    true vocabulary size: the padded logit columns are masked.  The mean
    negative log-likelihood over the unmasked labels, in f32."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp != vocab:
        pad = torch.arange(vp, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    valid = labels >= 0
    labels_c = labels.clamp(0, vocab - 1).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels_c[..., None])[..., 0]
    nll = (lse - picked) * valid
    return nll.sum() / valid.sum().clamp_min(1)
