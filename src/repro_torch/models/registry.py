"""Model registry: build an architecture by id or config on a device.

Counterpart of ``build`` in the JAX package's ``models/registry.py``; its
dry-run input specs and sharding presets have no single-card use.
"""
from __future__ import annotations

from ..configs import base as C
from .model import Model


def build(arch: "str | C.ArchConfig", device=None) -> Model:
    """The model of ``arch`` on ``device`` (``None``: the CUDA card; pass
    ``"cpu"`` to run on the CPU).  Attention goes through the kernels'
    wrappers, which launch the CUDA kernels on the card and take their
    plain versions only for CPU tensors."""
    cfg = C.get(arch) if isinstance(arch, str) else arch
    return Model(cfg, device=device)
