"""Batched RACE probe: the CUDA kernel's wrapper and its plain torch version.

``race_lookup(keys, table)`` probes uint32 keys (int64 tensor) against a
shadow slot table ((nb, spb) int32 tensor of ``fp:8 | ptr:24`` slots) and
returns ``(ptr (N,) int32, found (N,) bool)`` on the inputs' device.  The
tensors' device decides the path: CPU tensors take ``race_lookup_plain``;
CUDA tensors launch ``csrc/race_lookup.cu`` (replacing the JAX package's
``kernels/race_lookup/kernel.py::race_lookup_fwd``) or raise.  Every kernel
launch adds one to ``race_lookup.launches``.

``race_lookup_probe`` is the probe path's own entry to the same kernel,
with the answer packed into one int32 word a key, ``found << 24 | ptr``
(``race_lookup_packed_plain`` on a CPU table): the keys go up from a
pinned buffer and the kernel writes the answers into pinned host memory,
in one ctypes call that ends in a sync of the stream.  It checks nothing:
the caller's staging buffers are contiguous and on the table's device,
and the caller checks its memoized table once, with ``check_table``, when
it builds it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

__all__ = ["race_lookup", "race_lookup_plain", "race_lookup_packed_plain",
           "race_lookup_probe", "check_table", "hash32"]

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


def race_lookup_packed_plain(keys: torch.Tensor, table: torch.Tensor
                             ) -> torch.Tensor:
    """``race_lookup_plain``'s answer packed into one int32 word a key,
    ``found << 24 | ptr`` (exact: ptr < 2^24)."""
    ptr, found = race_lookup_plain(keys, table)
    return ptr | (found.to(torch.int32) << 24)


def check_table(table: torch.Tensor) -> None:
    """Raise unless ``table`` is a contiguous, non-empty (nb, spb) int32
    slot table on the CPU or a CUDA device."""
    if table.dim() != 2:
        raise ValueError(f"race_lookup: table must be (nb, spb), got "
                         f"{tuple(table.shape)}")
    if table.dtype != torch.int32:
        raise TypeError(f"race_lookup: int32 table expected, got "
                        f"{table.dtype}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"race_lookup: unsupported device {table.device}")
    if table.device.type == "cuda" and (
            table.shape[0] == 0 or table.shape[1] == 0
            or not table.is_contiguous()):
        raise ValueError("race_lookup: the table on the card must be "
                         "contiguous and non-empty")


def _check_inputs(keys: torch.Tensor, table: torch.Tensor):
    if keys.dim() != 1:
        raise ValueError(f"race_lookup: keys must be (N,), got "
                         f"{tuple(keys.shape)}")
    if keys.dtype != torch.int64:
        raise TypeError(f"race_lookup: int64 keys expected, got "
                        f"{keys.dtype}")
    if keys.device != table.device:
        raise ValueError(f"race_lookup: keys on {keys.device}, "
                         f"table on {table.device}")


@functools.lru_cache(maxsize=None)
def _launchers():
    """The C entry points of ``csrc/race_lookup.cu``, built and typed on
    first use: (race_lookup_launch, race_lookup_probe)."""
    lib = build.load("race_lookup")
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    launch, probe = lib.race_lookup_launch, lib.race_lookup_probe
    launch.argtypes = [P, P, LL, I, I, P, P, P, P]
    probe.argtypes = [P, P, P, LL, I, I, P, P]
    launch.restype = probe.restype = I
    return launch, probe


def race_lookup(keys: torch.Tensor, table: torch.Tensor):
    """Batched RACE probe on the inputs' device (see module docstring)."""
    if table.device.type == "cuda":
        table = table.contiguous()
    check_table(table)
    _check_inputs(keys, table)
    if keys.device.type == "cpu":
        return race_lookup_plain(keys, table)
    keys = keys.contiguous()
    n = keys.numel()
    nb, spb = table.shape
    ptr = torch.empty(n, dtype=torch.int32, device=keys.device)
    found = torch.empty(n, dtype=torch.bool, device=keys.device)
    if n == 0:
        return ptr, found                       # nothing to launch
    err = _launchers()[0](keys.data_ptr(), table.data_ptr(), n, nb, spb,
                          ptr.data_ptr(), found.data_ptr(), None,
                          build.stream_ptr(keys.device))
    build.check(err, "race_lookup")
    race_lookup.launches += 1
    return ptr, found


def race_lookup_probe(h_keys: torch.Tensor, d_keys: torch.Tensor,
                      table: torch.Tensor, n: int, out: torch.Tensor) -> None:
    """The probe path's entry (see module docstring): the first ``n``
    int64 keys of the pinned buffer ``h_keys`` are copied into the device
    buffer ``d_keys`` and probed against ``table``, and the kernel writes
    their packed answers into ``out``, pinned host memory, across the bus;
    the stream is synchronised before it returns.  On a CPU table ``out``
    gets ``race_lookup_packed_plain`` of ``h_keys``."""
    if table.device.type == "cpu":
        out[:n] = race_lookup_packed_plain(h_keys[:n], table)
        return
    if n == 0:
        return                                  # nothing to launch
    nb, spb = table.shape
    err = _launchers()[1](h_keys.data_ptr(), d_keys.data_ptr(),
                          table.data_ptr(), n, nb, spb, out.data_ptr(),
                          build.stream_ptr(table.device))
    build.check(err, "race_lookup")
    race_lookup.launches += 1


race_lookup.launches = 0
