"""Optimizers from scratch: AdamW / Lion / SGD-momentum, with optional
int8-quantized moments (8-bit Adam) for the >=100B architectures.

State and parameters are plain nested dicts and lists of tensors, as the
JAX package's pytrees; every update is functional (new tensors, nothing
written in place) and runs in f32 on the parameters' device.  int8
moments use blockwise absmax quantization over the last axis (block =
whole row; dequant-update-requant per step with f32 scales).

Counterpart of the JAX package's ``optim/optimizer.py``: the same math,
the same state tree (``count`` int32, ``m`` and ``v`` trees of
``Moment``), so a checkpoint of either package's state loads in the
other.  ``state_specs`` (mesh partition specs) has no single-card use.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core.heap import resolve_device


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # 'adamw' | 'lion' | 'sgdm'
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments: str = "fp32"            # 'fp32' | 'int8'
    # schedule
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class Moment(NamedTuple):
    """A possibly-quantized moment tensor."""
    value: torch.Tensor                # f32 or int8
    scale: Optional[torch.Tensor]      # None for f32


# ------------------------------------------------------------------ trees --
def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure): dicts, lists and tuples are nodes, a
    ``Moment`` or anything ``is_leaf`` accepts is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Moment):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in the JAX package's flattening order:
    dict keys sorted, sequences in order, a ``Moment``'s value then its
    scale (a ``None`` scale is no leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def opt_state_from_jax(tree, device=None):
    """The JAX package's optimizer state (``count``, and ``m`` / ``v``
    trees of its ``Moment``), as numpy arrays, to this package's, on
    ``device`` (``None``: the CUDA card): the int8 codes, f32 scales and
    f32 moments bit for bit, so both packages can start from one state."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if getattr(x, "_fields", None) == ("value", "scale"):
            return Moment(conv(x.value),
                          None if x.scale is None else conv(x.scale))
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        # a copy: JAX's buffers are read-only
        return torch.from_numpy(np.array(x, order="C")).to(dev)

    return conv(tree)


def _is_moment(x) -> bool:
    return isinstance(x, Moment)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in f32 (``step`` an
    int or an integer tensor; the result lies on its device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


# ------------------------------------------------------- int8 moment codec --
def _quant(x: torch.Tensor):
    """f32 -> (int8, f32 row scales)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-20) / 127.0
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _moment_init(p: torch.Tensor, quantized: bool) -> Moment:
    if quantized and p.dim() >= 1:
        z = torch.zeros(p.shape, dtype=torch.int8, device=p.device)
        s = torch.zeros((*p.shape[:-1], 1), dtype=torch.float32,
                        device=p.device)
        return Moment(z, s)
    return Moment(torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), None)


def _moment_get(m: Moment, sqrt_domain: bool = False) -> torch.Tensor:
    if m.scale is None:
        return m.value
    v = _dequant(m.value, m.scale)
    return v.square() if sqrt_domain else v


def _moment_set(m: Moment, x: torch.Tensor,
                sqrt_domain: bool = False) -> Moment:
    """``sqrt_domain``: store sqrt(x) (x >= 0).  Linear int8 cannot span the
    dynamic range of Adam's second moment (g^2): small-v rows quantize to 0
    and m/(sqrt(0)+eps) explodes.  sqrt halves the dynamic range (|g|), the
    standard fix for 8-bit second moments."""
    if m.scale is None:
        return Moment(x.to(torch.float32), None)
    q, s = _quant(x.sqrt() if sqrt_domain else x)
    return Moment(q, s)


# ---------------------------------------------------------------- updates --
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * factor, grads), norm


class Optimizer:
    """Functional optimizer: ``init`` builds the state tree, ``update``
    returns new parameters and state."""

    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params) -> Dict[str, Any]:
        q = self.cfg.moments == "int8"
        mk = lambda p: _moment_init(p, q)
        dev = tree_leaves(params)[0].device
        state: Dict[str, Any] = {
            "count": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.cfg.name == "adamw":
            state["m"] = tree_map(mk, params)
            state["v"] = tree_map(mk, params)
        elif self.cfg.name in ("lion", "sgdm"):
            state["m"] = tree_map(mk, params)
        else:
            raise ValueError(self.cfg.name)
        return state

    def update(self, grads, state, params):
        """Returns (new_params, new_state, metrics)."""
        cfg = self.cfg
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        count = state["count"] + 1
        lr = schedule(cfg, count)
        metrics = {"grad_norm": gnorm, "lr": lr}

        if cfg.name == "adamw":
            cf = count.to(torch.float32)
            bc1 = 1 - torch.pow(cfg.b1, cf)
            bc2 = 1 - torch.pow(cfg.b2, cf)

            def upd(p, g, m, v):
                mf = cfg.b1 * _moment_get(m) + (1 - cfg.b1) * g
                vf = (cfg.b2 * _moment_get(v, sqrt_domain=True)
                      + (1 - cfg.b2) * g.square())
                step = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
                decay = cfg.weight_decay * p.float()
                new_p = p.float() - lr * (step + decay)
                return (new_p.to(p.dtype), _moment_set(m, mf),
                        _moment_set(v, vf, sqrt_domain=True))

            out = tree_map(upd, params, grads, state["m"], state["v"])
            pick = lambda i: tree_map(lambda t: t[i], out,
                                      is_leaf=lambda t: isinstance(t, tuple)
                                      and len(t) == 3 and _is_moment(t[1]))
            return pick(0), {"count": count, "m": pick(1),
                             "v": pick(2)}, metrics

        if cfg.name == "lion":
            def upd(p, g, m):
                mf = _moment_get(m)
                step = torch.sign(cfg.b1 * mf + (1 - cfg.b1) * g)
                new_m = cfg.b2 * mf + (1 - cfg.b2) * g
                decay = cfg.weight_decay * p.float()
                new_p = p.float() - lr * (step + decay)
                return new_p.to(p.dtype), _moment_set(m, new_m)
        elif cfg.name == "sgdm":
            def upd(p, g, m):
                new_m = cfg.b1 * _moment_get(m) + g
                new_p = p.float() - lr * new_m
                return new_p.to(p.dtype), _moment_set(m, new_m)
        else:
            raise ValueError(cfg.name)
        out = tree_map(upd, params, grads, state["m"])
        pick = lambda i: tree_map(lambda t: t[i], out,
                                  is_leaf=lambda t: isinstance(t, tuple)
                                  and len(t) == 2 and _is_moment(t[1]))
        return pick(0), {"count": count, "m": pick(1)}, metrics
