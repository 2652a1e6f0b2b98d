"""RACE shadow-index machinery in torch: ``hash32``, the plain batched
probe ``race_lookup_plain`` (both defined beside the CUDA kernel's wrapper
in ``kernels/race_lookup/ops.py``) and the vectorized shadow-index builder.

Counterpart of the JAX package's ``core/shadow.py``.  Unsigned 32-bit lanes
are carried in ``int64`` tensors and masked with ``& 0xFFFFFFFF`` after every
step: torch has no unsigned arithmetic for ``+``/``>>``/``%``, and signed
wrap-around of the int64 product leaves the low 32 bits exact.  The shadow
table is an ``int32`` tensor of ``fp:8 | ptr:24`` slots (uint32 bit
patterns), built on the keys' device so it never round-trips to the host.

``hash32_np`` is the same hash on uint32 numpy lanes, for host code that
must not launch a device op per call: the obs hub's heat sketch hashes each
flush's keys with it (``obs/flight.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.race_lookup.ops import (MASK24, MASK32,  # noqa: F401
                                       bucket_pair, fingerprint32, hash32,
                                       race_lookup_plain)


def hash32_np(x: np.ndarray, seed: int) -> np.ndarray:
    """``hash32`` on uint32 numpy lanes (uint32 out)."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint32) + np.uint32((0x9E3779B9 * (seed + 1))
                                            & 0xFFFFFFFF)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        return (x ^ (x >> np.uint32(16))).astype(np.uint32)


def _rank_within(sorted_groups: torch.Tensor) -> torch.Tensor:
    first = torch.searchsorted(sorted_groups, sorted_groups, right=False)
    return torch.arange(sorted_groups.numel(),
                        device=sorted_groups.device) - first


def build_shadow(keys32: torch.Tensor, *, spb: int = 8,
                 min_buckets: int = 16) -> torch.Tensor:
    """Shadow RACE index over ``keys32`` (entry i stored as
    ``fp << 24 | i + 1``), on the keys' device.  Cuckoo-lite placement with
    no per-entry loop: pass 1 ranks entries within their first-choice bucket
    (stable argsort); overflow retries in the second-choice bucket on top of
    pass-1 occupancy; residual overflow is unreachable through the fast
    path (callers fall back to a full SEARCH), never wrong."""
    keys32 = keys32.to(torch.int64)
    dev = keys32.device
    n = keys32.numel()
    nb = min_buckets
    while nb * spb < 4 * n:
        nb *= 2
    shadow = torch.zeros((nb, spb), dtype=torch.int64, device=dev)
    if n == 0:
        return shadow.to(torch.int32)
    fp = fingerprint32(keys32)
    b1, b2 = bucket_pair(keys32, nb)
    slot = (fp << 24) | (torch.arange(1, n + 1, device=dev) & MASK24)

    order1 = torch.argsort(b1, stable=True)
    rank1 = _rank_within(b1[order1])
    fit1 = rank1 < spb
    placed1 = order1[fit1]
    shadow[b1[placed1], rank1[fit1]] = slot[placed1]

    spill = order1[~fit1]
    if spill.numel():
        base = torch.clamp(torch.bincount(b1, minlength=nb), max=spb)
        order2 = spill[torch.argsort(b2[spill], stable=True)]
        col = _rank_within(b2[order2]) + base[b2[order2]]
        fit2 = col < spb
        placed2 = order2[fit2]
        shadow[b2[placed2], col[fit2]] = slot[placed2]
    # uint32 bit patterns as int32 (the kernel's slot type)
    return torch.where(shadow >= 1 << 31, shadow - (1 << 32),
                       shadow).to(torch.int32)
