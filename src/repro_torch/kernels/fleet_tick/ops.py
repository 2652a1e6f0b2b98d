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

``fleet_read_tick`` is the pool's own entry to the same kernel: ``base``
and ``start`` are slices of the tick's upload buffer, the words land at an
offset of the pool's staging buffer, and it checks nothing (the pool builds
those buffers contiguous, int64 and on the slab's device).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

__all__ = ["fleet_read", "fleet_read_plain", "fleet_read_tick"]


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
def _launchers():
    """The C entry points of ``csrc/fleet_read.cu``, built and typed on
    first use: (fleet_read_launch, fleet_read_tick)."""
    lib = build.load("fleet_read")
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    launch, tick = lib.fleet_read_launch, lib.fleet_read_tick
    launch.argtypes = [P, P, P, LL, LL, P, P]
    tick.argtypes = [P, P, LL, LL, LL, LL, P, LL, P]
    launch.restype = tick.restype = ctypes.c_int
    return launch, tick


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
    if total == 0:
        return out                              # nothing to launch
    err = _launchers()[0](slab.data_ptr(), base.data_ptr(), start.data_ptr(),
                          base.numel(), total, out.data_ptr(),
                          build.stream_ptr(slab.device))
    build.check(err, "fleet_read")
    fleet_read.launches += 1
    return out


def fleet_read_tick(slab: torch.Tensor, buf: torch.Tensor, base: slice,
                    start: slice, total: int, out: torch.Tensor,
                    out_off: int, device: torch.device) -> None:
    """The fused tick's READ sweep: ``buf[base]`` and ``buf[start]`` are
    the sweep's coordinates, and its ``total`` (> 0) words land in
    ``out[out_off : out_off + total]``; ``device`` is the pool's (the
    slab's)."""
    if device.type == "cpu":
        out[out_off:out_off + total] = fleet_read_plain(
            slab, buf[base], buf[start], total)
        return
    err = _launchers()[1](slab.data_ptr(), buf.data_ptr(), base.start,
                          start.start, base.stop - base.start, total,
                          out.data_ptr(), out_off, build.stream_ptr(device))
    build.check(err, "fleet_read")
    fleet_read.launches += 1


fleet_read.launches = 0
