"""The JAX package's model parameters, as numpy arrays, to the port's
trees (same nesting, same layouts, same values).

``params_from_jax(jax.tree.map(np.asarray, params), device="cpu")`` gives
the port a model that computes what the JAX model computes, for every
family's tree (tied embeddings with no ``lm_head``, qk-norm layers,
``moe`` routers and ``experts``, ``mamba``, ``mlstm`` and ``slstm``
mixers, whisper's ``cross`` attention and ``enc`` encoder);
``optim.opt_state_from_jax`` does the same for an optimizer state.  Imports no JAX: the caller turns JAX arrays into numpy
first (bfloat16 arrays arrive with numpy's ``bfloat16`` extension dtype
and keep their bits).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.heap import resolve_device


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")          # a copy: JAX's buffers are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Any, device=None) -> Any:
    """Map a tree of numpy arrays (dicts, lists, tuples) to tensors on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _tensor(np.asarray(x), dev)

    return conv(tree)

