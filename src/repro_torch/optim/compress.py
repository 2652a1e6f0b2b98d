"""Cross-pod gradient compression (int8 + error feedback).

In the JAX package the cross-pod all-reduce runs under a ``shard_map``
over the mesh's ``pod`` axis: each pod quantizes its gradient plus the
carried error to int8, the codes and row scales are all-gathered over
``pod`` (1 byte an element on the wire) and summed after dequantization,
and the residual ``g - dequant(q)`` is carried to the next step (error
feedback).

One card has no ``pod`` axis, so ``pod_compressed_mean`` here is the
one-pod case of that math: quantize g + e, the merge is its dequantized
value (the sum over one pod, divided by one), and the residual is carried.
As in the reference on a mesh without ``pod``, the trainer never calls it.
"""
from __future__ import annotations

import torch

from .optimizer import tree_map


def _quant(x: torch.Tensor):
    """f32 -> (int8, f32 scales over the last axis; a 0-d x is its own
    row)."""
    amax = x.abs().amax(dim=-1, keepdim=True) if x.dim() else x.abs()
    scale = amax.clamp_min(1e-20) / 127.0
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def pod_compressed_mean(grads, err):
    """Per-pod gradients -> the int8-compressed mean over the one pod.

    grads: gradient tree (any float dtype).  err: error-feedback tree (f32).
    Returns (merged grads, new err)."""
    def one(g, e):
        g = g.float() + e
        q, s = _quant(g)
        deq = q.float() * s
        return deq, g - deq

    out = tree_map(one, grads, err)
    is_pair = lambda t: isinstance(t, tuple) and len(t) == 2 and \
        isinstance(t[0], torch.Tensor)
    return (tree_map(lambda t: t[0], out, is_leaf=is_pair),
            tree_map(lambda t: t[1], out, is_leaf=is_pair))


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
