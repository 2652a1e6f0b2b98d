"""Batched RACE probe: the CUDA kernel's wrapper and its plain torch version.

``race_lookup(keys, table)`` probes uint32 keys (int64 tensor) against a
shadow slot table ((nb, spb) int32 tensor of ``fp:8 | ptr:24`` slots) and
returns ``(ptr (N,) int32, found (N,) bool)`` on the inputs' device.  The
tensors' device decides the path: CPU tensors take ``race_lookup_plain``;
CUDA tensors launch ``csrc/race_lookup.cu`` (replacing the JAX package's
``kernels/race_lookup/kernel.py::race_lookup_fwd``) or raise.  Every kernel
launch adds one to ``race_lookup.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

__all__ = ["race_lookup", "race_lookup_plain", "hash32"]

MASK24 = (1 << 24) - 1
MASK32 = 0xFFFFFFFF


def hash32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """xorshift-multiply hash of uint32 lanes held in int64 -> int64 in
    [0, 2^32)."""
    x = (x.to(torch.int64) + ((0x9E3779B9 * (seed + 1)) & MASK32)) & MASK32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def fingerprint32(keys: torch.Tensor) -> torch.Tensor:
    """Top 8 bits of the seed-7 hash; 0 is reserved for empty, so it maps
    to 1."""
    fp = hash32(keys, 7) >> 24
    return torch.where(fp == 0, torch.ones_like(fp), fp)


def bucket_pair(keys: torch.Tensor, nb: int):
    b1 = hash32(keys, 1) % nb
    b2 = hash32(keys, 2) % nb
    return b1, torch.where(b2 == b1, (b1 + 1) % nb, b2)


def race_lookup_plain(keys: torch.Tensor, table: torch.Tensor):
    """The batched RACE probe in plain torch: scan row b1 then row b2 of the
    (nb, spb) slot table, first fingerprint match wins.

    keys: (N,) int64 uint32 values; table: (nb, spb) int32 slots.
    Returns (ptr (N,) int32, 0 on a miss; found (N,) bool)."""
    nb = table.shape[0]
    b1, b2 = bucket_pair(keys, nb)
    fp = fingerprint32(keys)
    rows = torch.cat([table[b1], table[b2]], dim=1).to(torch.int64) & MASK32
    match = (rows >> 24) == fp[:, None]
    found = match.any(dim=1)
    first = match.to(torch.int8).argmax(dim=1)
    picked = rows.gather(1, first[:, None])[:, 0]
    ptr = torch.where(found, picked & MASK24, torch.zeros_like(picked))
    return ptr.to(torch.int32), found


def _check_inputs(keys: torch.Tensor, table: torch.Tensor):
    if keys.dim() != 1 or table.dim() != 2:
        raise ValueError(f"race_lookup: keys must be (N,), table (nb, spb); "
                         f"got {tuple(keys.shape)} and {tuple(table.shape)}")
    if keys.dtype != torch.int64 or table.dtype != torch.int32:
        raise TypeError(f"race_lookup: keys int64 and table int32 expected, "
                        f"got {keys.dtype} and {table.dtype}")
    if keys.device != table.device:
        raise ValueError(f"race_lookup: keys on {keys.device}, "
                         f"table on {table.device}")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of ``csrc/race_lookup.cu``, built and typed on
    first use."""
    fn = build.load("race_lookup").race_lookup_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def race_lookup(keys: torch.Tensor, table: torch.Tensor):
    """Batched RACE probe on the inputs' device (see module docstring)."""
    _check_inputs(keys, table)
    if keys.device.type == "cpu":
        return race_lookup_plain(keys, table)
    if keys.device.type != "cuda":
        raise ValueError(f"race_lookup: unsupported device {keys.device}")
    if table.shape[0] == 0 or table.shape[1] == 0:
        raise ValueError("race_lookup: empty shadow table")
    keys = keys.contiguous()
    table = table.contiguous()
    n = keys.numel()
    nb, spb = table.shape
    ptr = torch.empty(n, dtype=torch.int32, device=keys.device)
    found = torch.empty(n, dtype=torch.bool, device=keys.device)
    if n == 0:
        return ptr, found                       # nothing to launch
    err = _launcher()(keys.data_ptr(), table.data_ptr(), n, nb, spb,
                      ptr.data_ptr(), found.data_ptr(),
                      build.stream_ptr(keys.device))
    build.check(err, "race_lookup")
    race_lookup.launches += 1
    return ptr, found


race_lookup.launches = 0
