"""Batched ordered-keydir leaf probe: the CUDA kernel's wrapper and its
plain torch version.

``leaf_probe(starts, lows)`` takes uint64 keys as int64 bit patterns —
``starts`` (N,) and ``lows`` (M,), the lows sorted ascending as uint64,
duplicates allowed, M may be 0 — and returns (N,) int32 on their device:
for each start the index of the rightmost low <= start under the unsigned
order, i.e. ``count(lows <= start) - 1``, and -1 where every low exceeds
the start.  The device of ``lows`` decides the path: CPU lows take
``leaf_probe_plain``; CUDA lows launch ``csrc/leaf_probe.cu`` (replacing
the JAX package's ``kernels/leaf_probe/kernel.py::leaf_probe_fwd``) or
raise.  The kernel runs one warp per start, a 32-ary search.  ``out``,
where given, is the (N,) int32 tensor the result is written into.  Beside
CUDA lows, ``starts`` and ``out`` may also be contiguous pinned host
tensors: the kernel then writes the result in place over the bus (pinned
memory is mapped into the card's address space) and reads the starts
there too, except that one host start is read when the call is made and
passed to the kernel by value; this spares a one-key locate two copies.  Every kernel launch adds one to
``leaf_probe.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

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


def _check_inputs(starts: torch.Tensor, lows: torch.Tensor, out):
    if starts.dim() != 1 or lows.dim() != 1:
        raise ValueError(f"leaf_probe: starts and lows must be 1-D, got "
                         f"{tuple(starts.shape)} and {tuple(lows.shape)}")
    if starts.dtype != torch.int64 or lows.dtype != torch.int64:
        raise TypeError(f"leaf_probe: int64 starts and lows expected, got "
                        f"{starts.dtype} and {lows.dtype}")
    if out is not None and (out.dtype != torch.int32
                            or out.shape != starts.shape):
        raise ValueError(f"leaf_probe: out must be a {tuple(starts.shape)} "
                         f"int32 tensor")
    for name, t in (("starts", starts), ("out", out)):
        if t is None or t.device == lows.device:
            continue
        if lows.device.type != "cuda" or t.device.type != "cpu" \
                or not (t.is_contiguous() and t.is_pinned()):
            raise ValueError(f"leaf_probe: {name} on {t.device}, lows on "
                             f"{lows.device} (only contiguous pinned host "
                             f"memory may stand in for the card's)")
    if out is not None and not out.is_contiguous():
        raise ValueError("leaf_probe: out must be contiguous")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of ``csrc/leaf_probe.cu``, built and typed on
    first use."""
    fn = build.load("leaf_probe").leaf_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def leaf_probe(starts: torch.Tensor, lows: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched leaf probe on the device of ``lows`` (see module
    docstring)."""
    _check_inputs(starts, lows, out)
    if lows.device.type == "cpu":
        res = leaf_probe_plain(starts, lows)
        return res if out is None else out.copy_(res)
    if lows.device.type != "cuda":
        raise ValueError(f"leaf_probe: unsupported device {lows.device}")
    starts = starts.contiguous()
    lows = lows.contiguous()
    n = starts.numel()
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=lows.device)
    if n == 0:
        return out                              # nothing to launch
    err = _launcher()(starts.data_ptr(), starts.device.type == "cpu",
                      lows.data_ptr(), n, lows.numel(), out.data_ptr(),
                      build.stream_ptr(lows.device))
    build.check(err, "leaf_probe")
    leaf_probe.launches += 1
    return out


leaf_probe.launches = 0
