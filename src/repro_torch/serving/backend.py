"""Device backend for the unified store API (core/api.py).

Maps ``Op`` batches onto the device-resident pool (kvpool.py): GETs become
one batched ``race_lookup`` probe, INSERT/UPDATEs one page allocation +
page write + SNAPSHOT epoch group, DELETEs one epoch — the batch-native
substrate the serving engine runs on.  Futures resolve eagerly (device ops
are synchronous host calls); the surface is the one ``SimBackend`` offers.

Keys are folded to the pool's 32-bit key space; values (optional, small)
are retained host-side per page so ``get`` round-trips them.  The page id
backing a key is reported on ``OpResult.page`` — the serving engine uses
it for KV-cache page accounting.

Counterpart of the JAX package's ``serving/backend.py``.  SCAN and RANGE
need the ordered keydir and the ``leaf_probe`` kernel, which are not
ported yet (ROADMAP A6): submitting one raises ``NotImplementedError``,
and the backend keeps no keydir.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core import codec
from ..core.api import KVFuture, Op
from ..core.events import FULL, NOT_FOUND, OK, OpResult
from ..core.faults import ClientCrashed
from .kvpool import KVPool, OP_INSERT, OP_UPDATE, PoolConfig


def _key32(key) -> int:
    k = codec.encode_key(key)
    k = (k ^ (k >> 32)) & 0x7FFFFFFF
    return k if k != 0 else 1


class DeviceBackend:
    """Batch-native backend over the device-resident FUSEE pool."""

    def __init__(self, cfg: Optional[PoolConfig] = None, *, cid: int = 0,
                 pool: Optional[KVPool] = None, seed: int = 0, device=None):
        self.pool = pool if pool is not None else KVPool(
            cfg or PoolConfig(), seed=seed, device=device)
        self.cid = cid
        self.crashed = False                 # set by ServeEngine.crash_worker
        self._values: Dict[int, Any] = {}    # page -> encoded value words

    # ------------------------------------------------------------- submit
    def submit_many(self, ops: Sequence[Op]) -> List[KVFuture]:
        if self.crashed:
            raise ClientCrashed(self.cid)
        futs = [KVFuture(self) for _ in ops]
        # execute maximal same-kind runs as one device batch, preserving
        # cross-kind program order
        i = 0
        while i < len(ops):
            j = i
            while j < len(ops) and ops[j].kind == ops[i].kind:
                j += 1
            self._exec_group(ops[i].kind, list(range(i, j)), ops, futs)
            i = j
        return futs

    def _exec_group(self, kind: str, idxs: List[int], ops, futs):
        if kind == "search":
            keys = np.array([_key32(ops[i].key) for i in idxs], np.int32)
            ptr, found = self.pool.search(keys)
            for n, i in enumerate(idxs):
                if found[n]:
                    page = int(ptr[n])
                    futs[i]._resolve(OpResult(OK, page=page,
                                              value=self._values.get(page)))
                else:
                    futs[i]._resolve(OpResult(NOT_FOUND))
        elif kind in ("insert", "update"):
            # Duplicate keys within one batch are concurrent upserts of the
            # same key: exactly one page is written (last writer's value
            # wins) and every duplicate resolves to that one result — the
            # pool would otherwise supersede-and-free a page whose OK
            # future the caller still holds.
            first: Dict[int, int] = {}      # key32 -> position of its op
            for n, i in enumerate(idxs):
                first[_key32(ops[i].key)] = n
            uniq = sorted(first.values())
            keys = np.array([_key32(ops[idxs[n]].key) for n in uniq],
                            np.int32)
            pages = self.pool.alloc_pages(self.cid, len(uniq))
            if (pages < 0).any() and self.pool.reclaim(self.cid):
                # slab ran dry but bitmap-freed pages (superseded upserts,
                # released surplus) were reclaimable: retry the dead slots
                dead = pages < 0
                pages[dead] = self.pool.alloc_pages(self.cid,
                                                    int(dead.sum()))
            live = pages >= 0
            if live.any():
                opcode = OP_INSERT if kind == "insert" else OP_UPDATE
                self.pool.write_pages(self.cid, pages[live], keys[live],
                                      opcode=opcode)
                ok = self.pool.insert_batch(self.cid, keys[live], pages[live],
                                            opcode=opcode)
            else:
                ok = np.zeros(0, bool)
            results: Dict[int, OpResult] = {}
            k = 0
            for m, n in enumerate(uniq):
                key = int(keys[m])
                if not live[m]:
                    results[key] = OpResult(FULL, page=-1)
                    continue
                page = int(pages[m])
                won = bool(ok[k]); k += 1
                self._values[page] = codec.encode_value(ops[idxs[n]].value)
                results[key] = OpResult(OK if won else FULL, page=page,
                                        value=self._values[page])
            for i in idxs:
                futs[i]._resolve(results[_key32(ops[i].key)])
        elif kind == "delete":
            keys = np.array([_key32(ops[i].key) for i in idxs], np.int32)
            ok = self.pool.delete_batch(self.cid, keys)
            for n, i in enumerate(idxs):
                futs[i]._resolve(OpResult(OK if ok[n] else NOT_FOUND))
        elif kind in ("scan", "range"):
            raise NotImplementedError(
                f"{kind.upper()} on the device pool needs the ordered keydir "
                "and the leaf_probe kernel, not ported yet (ROADMAP A6)")
        elif kind == "reclaim":
            n = self.pool.reclaim(self.cid)
            for i in idxs:
                futs[i]._resolve(OpResult(OK, value=[n]))
        else:
            raise ValueError(kind)

    # --------------------------------------------------- page management
    def release_pages(self, pages: np.ndarray):
        """Free surplus pages (index no longer references them) back to the
        pool's free bitmap — the engine's retire path."""
        pages = np.asarray(pages, np.int32)
        if len(pages):
            self.pool.free_pages(pages)
            for p in pages.tolist():
                self._values.pop(int(p), None)

    # ------------------------------------------------------------- driving
    def drive(self, fut: KVFuture):     # futures resolve eagerly
        if not fut.done():              # pragma: no cover - defensive
            raise RuntimeError("device future left unresolved")

    def drain(self):
        pass

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        return {"backend": "device", "cid": self.cid, "inflight": 0,
                "crashed": self.crashed,
                "pages_valued": len(self._values), **self.pool.stats}
