"""Dense SwiGLU feed-forward layer.

Counterpart of the dense half of the JAX package's ``models/ffn.py``; the
expert-parallel MoE is not ported yet (ROADMAP A9).
"""
from __future__ import annotations

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
