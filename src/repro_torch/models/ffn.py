"""Feed-forward layers: dense SwiGLU and the routed mixture of experts.

Counterpart of the JAX package's ``models/ffn.py``.  Its MoE runs its
routing inside a ``shard_map`` over the mesh's expert axes and merges the
expert shards' partial outputs with a ``psum``; one card holds every
expert, so here the expert-parallel extent is 1 (``ep = 1``): no mesh
resolution in ``MoEContext``, no ``all_gather``, no ``psum``.  The math of
the reference's gather layout is kept: f32 router softmax, ``top_k``,
gates renormalised, a capacity of ``max(1, ceil(T k / E cf))`` slots an
expert, each (token, slot) pair's place in its expert's buffer from a
cumulative count over the flat (T k) order (token-major, slot-minor), a
drop row for the pairs past capacity, and a scatter-add into
``(E + 1, cap + 1, D)`` buffers.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ParamInit


def make_dense_ffn_params(pi: ParamInit, n: int, d_model: int, d_ff: int):
    """``n`` stacked layers: w_gate/w_up (D, F), w_down (F, D)."""
    return {
        "w_gate": pi.param((n, d_model, d_ff)),
        "w_up": pi.param((n, d_model, d_ff)),
        "w_down": pi.param((n, d_ff, d_model)),
    }


def dense_ffn(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    return (F.silu(g) * u) @ p["w_down"].to(dt)


def make_moe_params(pi: ParamInit, n: int, d_model: int, n_experts: int,
                    d_ff_expert: int):
    """``n`` stacked layers: router (D, E); experts' w_gate/w_up (E, D, F)
    and w_down (E, F, D)."""
    return {
        "router": pi.param((n, d_model, n_experts), scale=1.0),
        "experts": {
            "w_gate": pi.param((n, n_experts, d_model, d_ff_expert)),
            "w_up": pi.param((n, n_experts, d_model, d_ff_expert)),
            "w_down": pi.param((n, n_experts, d_ff_expert, d_model)),
        },
    }


class MoEContext(NamedTuple):
    """The routing constants of a model's MoE layers."""
    n_experts: int
    top_k: int
    capacity_factor: float


class Routing(NamedTuple):
    """Where each (token, slot) pair goes: expert ``idx`` (T, k), its
    place ``pos`` in that expert's buffer, ``keep`` (pos < cap), the
    renormalised ``gate`` weights (f32) and the capacity ``cap``."""
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    cap: int


def moe_route(ctx: MoEContext, router: torch.Tensor,
              xt: torch.Tensor) -> Routing:
    """Routing of the tokens ``xt`` (T, D).  Ties in the router's
    probabilities go to the lower expert, as ``lax.top_k`` breaks them."""
    T = xt.shape[0]
    E, k = ctx.n_experts, ctx.top_k
    cap = max(1, int(math.ceil(T * k / E * ctx.capacity_factor)))
    logits = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = srt[:, :k], order[:, :k]                        # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # one-hot (T k, E), as F.one_hot but with the same ops on every device
    # (on the CPU F.one_hot first checks the ids' range, on meta it cannot)
    flat = (idx.reshape(T * k, 1) ==
            torch.arange(E, device=idx.device)).long()
    pos = ((flat.cumsum(0) - 1) * flat).sum(-1).reshape(T, k)
    return Routing(idx, pos, pos < cap, gate, cap)


def moe_ffn(ctx: MoEContext, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  The expert products are batched
    matmuls over the capacity buffers."""
    B, S, D = x.shape
    T, E, k = B * S, ctx.n_experts, ctx.top_k
    xt = x.reshape(T, D)
    r = moe_route(ctx, p["router"], xt)
    le = torch.where(r.keep, r.idx, E)                          # E: drop row
    lp = torch.where(r.keep, r.pos, r.cap)
    buf = xt.new_zeros(E + 1, r.cap + 1, D)
    buf.index_put_((le.reshape(-1), lp.reshape(-1)),
                   xt.repeat_interleave(k, dim=0), accumulate=True)
    buf = buf[:E, :r.cap]
    e, dt = p["experts"], xt.dtype
    g = torch.bmm(buf, e["w_gate"].to(dt))
    u = torch.bmm(buf, e["w_up"].to(dt))
    y = torch.bmm(F.silu(g) * u, e["w_down"].to(dt))            # (E, cap, D)
    y = F.pad(y, (0, 0, 0, 1, 0, 1))
    picked = y[le, lp]                                          # (T, k, D)
    w = r.gate.to(dt) * r.keep.to(dt)
    out = torch.einsum("tkd,tk->td", picked, w)
    return out.reshape(B, S, D)
