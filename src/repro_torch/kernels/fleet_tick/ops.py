"""Fused fleet-tick READ sweep: the CUDA kernel's wrapper and its plain
torch version.

``fleet_read(slab, base, start, total)`` gathers, for every read verb v of a
tick, the contiguous words ``slab[base[v] : base[v] + len_v]`` into
``out[start[v] : start[v + 1]]`` — one flat int64 vector of ``total`` words
that the pool splits back into per-verb rows.  ``base`` holds global word
addresses (``cell * region_words + offset``) and ``start`` the CSR offsets of
the ragged lengths (zero-length verbs allowed).  The slab's device decides
the path: CPU tensors take ``fleet_read_plain``; CUDA tensors launch
``csrc/fleet_read.cu`` (replacing the JAX package's
``kernels/fleet_tick/kernel.py::fleet_read_fwd``) or raise.  Every kernel
launch adds one to ``fleet_read.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

__all__ = ["fleet_read", "fleet_read_plain"]


def fleet_read_plain(slab: torch.Tensor, base: torch.Tensor,
                     start: torch.Tensor, total: int) -> torch.Tensor:
    """The ragged gather in plain torch: repeat/cumsum addressing, one
    index."""
    ln = start[1:] - start[:-1]
    addrs = (torch.repeat_interleave(base - start[:-1], ln,
                                     output_size=total)
             + torch.arange(total, device=slab.device))
    return slab[addrs]


def _check_inputs(slab, base, start, total):
    if slab.dim() != 1 or base.dim() != 1 or start.dim() != 1:
        raise ValueError("fleet_read: slab, base and start must be 1-D")
    if start.numel() != base.numel() + 1:
        raise ValueError(f"fleet_read: start must hold len(base) + 1 CSR "
                         f"offsets, got {start.numel()} for {base.numel()}")
    for name, t in (("slab", slab), ("base", base), ("start", start)):
        if t.dtype != torch.int64:
            raise TypeError(f"fleet_read: {name} must be int64, got {t.dtype}")
        if t.device != slab.device:
            raise ValueError(f"fleet_read: {name} on {t.device}, "
                             f"slab on {slab.device}")
    if total < 0:
        raise ValueError(f"fleet_read: negative total {total}")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of ``csrc/fleet_read.cu``, built and typed on
    first use."""
    fn = build.load("fleet_read").fleet_read_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fleet_read(slab: torch.Tensor, base: torch.Tensor, start: torch.Tensor,
               total: int) -> torch.Tensor:
    """Ragged read sweep on the slab's device (see module docstring)."""
    _check_inputs(slab, base, start, total)
    if slab.device.type == "cpu":
        return fleet_read_plain(slab, base, start, total)
    if slab.device.type != "cuda":
        raise ValueError(f"fleet_read: unsupported device {slab.device}")
    if not slab.is_contiguous():
        raise ValueError("fleet_read: the slab must be contiguous")
    base = base.contiguous()
    start = start.contiguous()
    out = torch.empty(total, dtype=torch.int64, device=slab.device)
    if base.numel() == 0:
        return out                              # nothing to launch
    err = _launcher()(slab.data_ptr(), base.data_ptr(), start.data_ptr(),
                      base.numel(), out.data_ptr(),
                      build.stream_ptr(slab.device))
    build.check(err, "fleet_read")
    fleet_read.launches += 1
    return out


fleet_read.launches = 0
