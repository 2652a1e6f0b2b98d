"""A device buffer and its pinned host mirror, for the host-device traffic
the port repeats on every tick and every locate.

``Staging(device, dtype)`` holds one buffer on ``device`` and one in pinned
host memory (on a CPU device both are one tensor), each grown
geometrically and reused:

* ``upload(arr)`` writes a numpy array into the mirror and copies it to the
  device with one non-blocking copy; it returns a view of the device
  buffer, valid until the next upload.  It first waits for the previous
  upload to have left the mirror;
* ``buffer(n)`` is the device buffer (at least ``n`` elements) for a
  kernel to write, and ``download(n)`` brings its first ``n`` elements back
  with one non-blocking copy and one sync of the current stream, as a
  fresh numpy array the caller may keep;
* ``host(n)`` is the mirror's first ``n`` elements as a tensor and a numpy
  view of the same memory, for a kernel that reads or writes pinned memory
  in place; the caller syncs before it reads them or writes them again.

Used by the pool's tick results (core/heap.py), a client's fence lows
(core/fences.py) and the locate's starts and answers (core/ordered.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import build

__all__ = ["Staging"]


def _cap(n: int) -> int:
    return max(64, 1 << max(n - 1, 0).bit_length())


class Staging:
    """A reused device buffer and its pinned host mirror (see module
    docstring)."""

    def __init__(self, device, dtype: torch.dtype = torch.int64):
        self.device = torch.device(device)
        self.dtype = dtype
        self._cuda = self.device.type == "cuda"
        self._host: Optional[torch.Tensor] = None
        self._host_np: Optional[np.ndarray] = None
        self._dev: Optional[torch.Tensor] = None
        self._view = None            # (n, tensor, ndarray) of the last host(n)
        self._uploaded: Optional[torch.cuda.Event] = None

    def host(self, n: int) -> Tuple[torch.Tensor, np.ndarray]:
        """The mirror's first ``n`` elements: a tensor and a numpy view."""
        if self._host is None or self._host.numel() < n:
            self._host = torch.empty(_cap(n), dtype=self.dtype,
                                     pin_memory=self._cuda)
            self._host_np = self._host.numpy()
            self._view = None
            if not self._cuda:
                self._dev = self._host
        if self._view is None or self._view[0] != n:
            self._view = (n, self._host[:n], self._host_np[:n])
        return self._view[1], self._view[2]

    def buffer(self, n: int) -> torch.Tensor:
        """The device buffer, of at least ``n`` elements."""
        if not self._cuda:
            self.host(n)
        elif self._dev is None or self._dev.numel() < n:
            self._dev = torch.empty(_cap(n), dtype=self.dtype,
                                    device=self.device)
        return self._dev

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the device: a view of the device buffer."""
        n = arr.size
        if self._uploaded is not None:
            self._uploaded.synchronize()     # the last upload left the mirror
        h, h_np = self.host(n)
        h_np[:] = arr
        d = self.buffer(n)[:n]
        if self._cuda:
            d.copy_(h, non_blocking=True)
            if self._uploaded is None:
                self._uploaded = torch.cuda.Event()
            self._uploaded.record(build.current_stream(self.device))
        return d

    def download(self, n: int) -> np.ndarray:
        """The device buffer's first ``n`` elements as a fresh array."""
        h, h_np = self.host(n)
        if self._cuda:
            h.copy_(self.buffer(n)[:n], non_blocking=True)
            build.current_stream(self.device).synchronize()
        return h_np.copy()
