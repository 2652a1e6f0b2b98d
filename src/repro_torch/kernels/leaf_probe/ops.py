"""Batched ordered-keydir leaf probe: the CUDA kernel's wrapper and its
plain torch version.

``leaf_probe(starts, lows)`` takes uint64 keys as int64 bit patterns —
``starts`` (N,) and ``lows`` (M,), the lows sorted ascending as uint64,
duplicates allowed, M may be 0 — and returns (N,) int32 on their device:
for each start the index of the rightmost low <= start under the unsigned
order, i.e. ``count(lows <= start) - 1``, and -1 where every low exceeds
the start.  The tensors' device decides the path: CPU tensors take
``leaf_probe_plain``; CUDA tensors launch ``csrc/leaf_probe.cu``
(replacing the JAX package's ``kernels/leaf_probe/kernel.py::
leaf_probe_fwd``) or raise.  Every kernel launch adds one to
``leaf_probe.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

__all__ = ["leaf_probe", "leaf_probe_plain", "flip_sign"]

_SIGN = -(1 << 63)          # int64 with only the sign bit set
_CHUNK = 1 << 22            # compare elements per chunk of starts


def flip_sign(x: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns of uint64 words, re-coded so that the signed
    order of the result is the unsigned order of the words."""
    return x ^ _SIGN


def leaf_probe_plain(starts: torch.Tensor, lows: torch.Tensor
                     ) -> torch.Tensor:
    """The leaf probe in plain torch: ``count(lows <= start) - 1`` as a
    compare-and-count on sign-flipped int64 (the unsigned order), over
    chunks of starts so that memory stays bounded."""
    s = flip_sign(starts)
    lw = flip_sign(lows)
    out = torch.empty(starts.numel(), dtype=torch.int32,
                      device=starts.device)
    step = max(1, _CHUNK // max(lw.numel(), 1))
    for i in range(0, s.numel(), step):
        le = lw[None, :] <= s[i:i + step, None]
        out[i:i + step] = le.sum(dim=1, dtype=torch.int32) - 1
    return out


def _check_inputs(starts: torch.Tensor, lows: torch.Tensor):
    if starts.dim() != 1 or lows.dim() != 1:
        raise ValueError(f"leaf_probe: starts and lows must be 1-D, got "
                         f"{tuple(starts.shape)} and {tuple(lows.shape)}")
    if starts.dtype != torch.int64 or lows.dtype != torch.int64:
        raise TypeError(f"leaf_probe: int64 starts and lows expected, got "
                        f"{starts.dtype} and {lows.dtype}")
    if starts.device != lows.device:
        raise ValueError(f"leaf_probe: starts on {starts.device}, "
                         f"lows on {lows.device}")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of ``csrc/leaf_probe.cu``, built and typed on
    first use."""
    fn = build.load("leaf_probe").leaf_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def leaf_probe(starts: torch.Tensor, lows: torch.Tensor) -> torch.Tensor:
    """Batched leaf probe on the inputs' device (see module docstring)."""
    _check_inputs(starts, lows)
    if starts.device.type == "cpu":
        return leaf_probe_plain(starts, lows)
    if starts.device.type != "cuda":
        raise ValueError(f"leaf_probe: unsupported device {starts.device}")
    starts = starts.contiguous()
    lows = lows.contiguous()
    n = starts.numel()
    out = torch.empty(n, dtype=torch.int32, device=starts.device)
    if n == 0:
        return out                              # nothing to launch
    err = _launcher()(starts.data_ptr(), lows.data_ptr(), n, lows.numel(),
                      out.data_ptr(), build.stream_ptr(starts.device))
    build.check(err, "leaf_probe")
    leaf_probe.launches += 1
    return out


leaf_probe.launches = 0
