"""A client's ordered-keydir fence cache: ``leaf_id -> low`` as a dict that
also keeps its fences sorted, and a copy of the sorted lows on the pool's
device.

``FenceCache`` is what ``FuseeClient.ord_fences`` holds.  As a mapping it
is the reference's plain dict (equality with it is what the parity tests
compare); besides it keeps

* ``version``: bumped on every real change (a new fence, a different low
  for a lid, a delete, a clear of a non-empty cache) and on nothing else;
* the fences in ``(low as uint64, lid)`` order — exactly the order of
  ``sorted((low, lid) for lid, low in cache.items())``, ties between equal
  lows broken by lid — as numpy arrays ``lows`` (uint64) and ``ids``
  (int64), read through ``sorted_view()`` and rebuilt by one numpy sort at
  the first read after a change;
* ``device_lows(device)``: the sorted lows as int64 bit patterns on the
  device, uploaded through a pinned mirror (``core/staging.py``) only when
  the version has moved since the last upload.

Every mutating method of ``dict`` is overridden (``__setitem__``,
``__delitem__``, ``update``, ``setdefault``, ``pop``, ``popitem``,
``clear``, ``__ior__``), so no change goes unseen.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .staging import Staging

__all__ = ["FenceCache"]

_MISSING = object()


class FenceCache(dict):
    """``leaf_id -> low`` fence cache with a sorted view and a device copy
    of its lows (see module docstring)."""

    def __init__(self, *args, **kw):
        super().__init__()
        self.version = 0
        self._view = (np.zeros(0, np.uint64), np.zeros(0, np.int64))
        self._view_version = 0
        self._staging: Optional[Staging] = None
        self._dev: Optional[torch.Tensor] = None
        self._dev_version = -1
        if args or kw:
            self.update(*args, **kw)

    def sorted_view(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(lows, ids)``: the fences in (low, lid) order, valid until the
        next change."""
        if self._view_version != self.version:
            m = len(self)
            ids = np.fromiter(self.keys(), np.int64, count=m)
            lows = np.fromiter(self.values(), np.uint64, count=m)
            order = np.lexsort((ids, lows))
            self._view = (lows[order], ids[order])
            self._view_version = self.version
        return self._view

    def rank(self, lid) -> int:
        """Position of ``lid``'s fence in ``sorted_view()``."""
        lows, ids = self.sorted_view()
        low = np.uint64(dict.__getitem__(self, lid))
        lo = int(lows.searchsorted(low))
        hi = int(lows.searchsorted(low, "right"))
        return lo + int(ids[lo:hi].searchsorted(lid))

    def device_lows(self, device: torch.device) -> torch.Tensor:
        """The sorted lows as int64 bit patterns on ``device``: a view of a
        buffer refreshed in place when the fences change, valid until the
        next change."""
        if self._staging is None or self._staging.device != device:
            self._staging = Staging(device)
            self._dev_version = -1
        if self._dev_version != self.version:
            lows, _ids = self.sorted_view()
            self._dev = self._staging.upload(lows.view(np.int64))
            self._dev_version = self.version
        return self._dev

    # ------------------------------------------------- dict's mutators
    def __setitem__(self, lid, low):
        old = dict.get(self, lid, _MISSING)
        if old is not _MISSING and old == low:
            return
        dict.__setitem__(self, lid, low)
        self.version += 1

    def __delitem__(self, lid):
        dict.__delitem__(self, lid)
        self.version += 1

    def update(self, *args, **kw):
        for lid, low in dict(*args, **kw).items():
            self[lid] = low

    def __ior__(self, other):
        self.update(other)
        return self

    def setdefault(self, lid, default=None):
        if lid not in self:
            self[lid] = default
        return dict.__getitem__(self, lid)

    def pop(self, lid, *default):
        if lid not in self:
            return dict.pop(self, lid, *default)
        low = dict.__getitem__(self, lid)
        del self[lid]
        return low

    def popitem(self):
        lid, low = dict.popitem(self)
        self.version += 1
        return lid, low

    def clear(self):
        if not self:
            return
        dict.clear(self)
        self.version += 1
