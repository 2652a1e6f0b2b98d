"""A hand-written kernel as a count sees it (``launch.roofline.count``).

On CPU and ``meta`` tensors each attention wrapper runs its kernel's plain
version, which makes copies and score panels that the kernel keeps on
chip, and does the masked work that the kernel skips.  So while a counter
runs, the wrapper hands it the call through ``plain`` with the work of the
kernel itself on these inputs: the counter counts the kernel once, at its
boundary, and the plain version's ops only in ``hbm_bytes_raw``.
"""
from __future__ import annotations

from typing import Callable, List

COUNTERS: List = []     # the counters running (``launch.roofline``)


def plain(name: str, fn: Callable, flops: int, nbytes: int):
    """``fn()``: the plain version of kernel ``name``, which on the same
    inputs does ``flops`` FLOPs and moves ``nbytes`` bytes."""
    if not COUNTERS:
        return fn()
    return COUNTERS[-1].kernel(name, fn, flops, nbytes)
