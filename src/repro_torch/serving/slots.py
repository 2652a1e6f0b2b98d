"""The serving pool's 32-bit slot layout, on int32 tensors.

A slot names a *page* of the on-device KV pool:

    | fp : 8 | page_ptr : 24 |          (fp 0 reserved = empty)

Slots are uint32 bit patterns held in int32 tensors (the index replicas'
dtype); hashing is the xorshift-multiply ``hash32`` shared with the
``race_lookup`` kernel (``kernels/race_lookup/ops.py``), whose lanes are
int64 holding uint32 values.  The numpy twins serve the sequential oracles
and the host-side log walk of recovery.

Counterpart of the JAX package's ``serving/slots_jax.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.race_lookup.ops import (MASK24, bucket_pair, fingerprint32,
                                       hash32)

__all__ = ["MASK24", "bucket_pair", "fingerprint32", "hash32", "pack_slot",
           "slot_fp", "slot_ptr", "pack_slot_np", "slot_fp_np", "slot_ptr_np"]

_MASK32 = 0xFFFFFFFF


def _to_int32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit patterns."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def pack_slot(fp: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """fp (…,) in [1, 255]; ptr (…,) in [0, 2^24) -> int32 slots."""
    u = ((fp.to(torch.int64) & 0xFF) << 24) | (ptr.to(torch.int64) & MASK24)
    return _to_int32(u)


def slot_fp(slot: torch.Tensor) -> torch.Tensor:
    return ((slot.to(torch.int64) & _MASK32) >> 24).to(torch.int32)


def slot_ptr(slot: torch.Tensor) -> torch.Tensor:
    return (slot.to(torch.int64) & MASK24).to(torch.int32)


# numpy twins (oracles and host-side recovery)
def pack_slot_np(fp, ptr):
    return ((np.uint32(fp) << np.uint32(24))
            | (np.uint32(ptr) & np.uint32(MASK24))).astype(np.uint32) \
        .view(np.int32)


def slot_fp_np(slot):
    return ((np.asarray(slot).view(np.uint32) >> 24) & 0xFF).astype(np.int32)


def slot_ptr_np(slot):
    return (np.asarray(slot).view(np.uint32) & np.uint32(MASK24)) \
        .astype(np.int32)
