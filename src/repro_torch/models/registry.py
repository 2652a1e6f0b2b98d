"""Model registry: build an architecture by id or config on a device, and
count a model's parameters from its tree.

Counterpart of ``build`` and ``param_stats`` in the JAX package's
``models/registry.py``; its dry-run input specs and sharding presets have
no single-card use.
"""
from __future__ import annotations

import math
from typing import Dict

from ..configs import base as C
from .model import Model


def build(arch: "str | C.ArchConfig", device=None) -> Model:
    """The model of ``arch`` on ``device`` (``None``: the CUDA card; pass
    ``"cpu"`` to run on the CPU).  Attention goes through the kernels'
    wrappers, which launch the CUDA kernels on the card and take their
    plain versions only for CPU tensors."""
    cfg = C.get(arch) if isinstance(arch, str) else arch
    return Model(cfg, device=device)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def param_stats(model: Model) -> Dict[str, float]:
    """Exact parameter counts from the abstract tree: ``total``, ``active``
    (a leaf under ``experts`` counts top_k / n_experts of its size),
    ``embed`` (``embed``, ``lm_head``, ``pos_embed``) and the non-embedding
    shares of both."""
    total = active = embed = 0
    for path, leaf in _walk(model.abstract_params()):
        n = math.prod(leaf.shape)
        total += n
        if {"embed", "lm_head", "pos_embed"} & set(path):
            embed += n
            active += n
        elif "experts" in path:
            m = model.cfg.moe
            active += n * m.top_k / m.n_experts
        else:
            active += n
    return {"total": total, "active": active, "embed": embed,
            "non_embed": total - embed,
            "active_non_embed": active - embed}
