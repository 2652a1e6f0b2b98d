"""The FUSEE-managed disaggregated KV-cache pool (internal substrate).

Clients go through the unified ``core.api.KVStore`` over
``serving.backend.DeviceBackend``, which lowers Op batches onto the pool
below; whitebox tests import it directly.

The *metadata* of a paged KV-cache prefix store — the RACE hash index
mapping ``prefix_hash -> page``, and the memory-management information —
lives in replicated device tensors and is manipulated by serving workers
(clients) with CAS epochs, not by a metadata server:

* RACE index (§4.2): ``(r, n_buckets * slots_per_bucket)`` int32 replicas
  on the pool's device; SEARCH = one batched probe through the
  ``race_lookup`` kernel on replica 0 (the primary); INSERT/UPDATE/DELETE
  = SNAPSHOT epochs (``snapshot.py``).
* Two-level memory management (§4.4): "memory nodes" (pool shards) grant
  coarse chunks of ``chunk_pages`` pages from a per-shard grant table (a
  cursor bump, recorded per client, on the host); clients carve single
  pages out of their chunks with local free lists (slab, on the host).
  Frees set bits in a device free bitmap (FAA analog); owners reclaim in
  batches.
* Embedded operation log (§4.5): every page carries a log record (old slot
  value, opcode, key, used/invalid bits) written together with the page;
  per-client allocation order forms the recovery chain.
* Recovery (§5.3): ``recover_client`` re-owns a crashed client's chunks
  from the grant table, walks its log, reclaims unused pages, and redoes
  in-flight index updates.

The CAS arrival order of each epoch is drawn from the pool's own CPU
``torch.Generator`` (seeded by ``seed``) and moved to the device, so a pool
on ``cuda`` and one on ``cpu`` take identical decisions.  Counterpart of
the JAX package's ``serving/kvpool.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.heap import resolve_device
from ..kernels.race_lookup import race_lookup
from . import slots as SL
from .snapshot import snapshot_epoch

OP_INSERT, OP_UPDATE, OP_DELETE = 1, 2, 3
_COMMITTED = 1 << 30        # log word 0: the index write of this page landed


@dataclass
class PoolConfig:
    n_pages: int = 4096          # pool pages per shard group
    n_buckets: int = 1024        # RACE combined buckets
    slots_per_bucket: int = 8
    replicas: int = 3            # index replication factor r
    chunk_pages: int = 64        # coarse grant unit (the "16MB block")
    n_shards: int = 4            # "memory nodes" granting chunks


@dataclass
class ClientSlab:
    """Client-side fine-grained allocator (one uniform size class)."""
    free: List[int] = field(default_factory=list)   # FIFO page free list
    chunks: List[int] = field(default_factory=list)
    last_alloc: int = 0


class KVPool:
    """Host-coordinated, device-resident FUSEE pool.

    Device state (torch, on ``device``): index replicas, page log, chain,
    free bitmap.  Host state (numpy): grant table and shard cursors, the
    per-client slabs — coarse state at MNs, fine state at clients."""

    def __init__(self, cfg: PoolConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        M = cfg.n_buckets * cfg.slots_per_bucket
        self.index = torch.zeros((cfg.replicas, M), dtype=torch.int32,
                                 device=dev)
        # page log: [old_value, opcode, key, flags(used|invalid<<1)]
        self.log = torch.zeros((cfg.n_pages, 4), dtype=torch.int32,
                               device=dev)
        # next/prev allocation-order chain per page (+1; 0 = nil)
        self.chain = torch.zeros((cfg.n_pages, 2), dtype=torch.int32,
                                 device=dev)
        self.free_bitmap = torch.zeros(cfg.n_pages, dtype=torch.int8,
                                       device=dev)
        # coarse level: grant table (page-chunk -> client+1), shard cursors
        n_chunks = cfg.n_pages // cfg.chunk_pages
        self.grant = np.zeros((n_chunks,), np.int32)
        self.shard_of_chunk = np.arange(n_chunks) % cfg.n_shards
        self.cursor = np.zeros((cfg.n_shards,), np.int32)
        self.slabs: Dict[int, ClientSlab] = {}
        self.gen = torch.Generator().manual_seed(seed)
        self.stats = {"alloc_rpcs": 0, "epochs": 0, "search_batches": 0}

    def _draw_prios(self, n_writers: int) -> torch.Tensor:
        """Per-replica CAS arrival priorities of one epoch's writers."""
        return torch.rand((self.cfg.replicas, n_writers),
                          generator=self.gen).to(self.device)

    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------ two-level allocation --
    def _grant_chunk(self, cid: int) -> Optional[int]:
        """MN-side ALLOC (compute-light): grab the next free chunk on the
        client's home shard (round-robin over shards on exhaustion)."""
        cfg = self.cfg
        for probe in range(cfg.n_shards):
            sh = (cid + probe) % cfg.n_shards
            mine = np.where((self.shard_of_chunk == sh) & (self.grant == 0))[0]
            if len(mine):
                c = int(mine[0])
                self.grant[c] = cid + 1
                self.stats["alloc_rpcs"] += 1
                return c
        return None

    def add_shard(self) -> int:
        """Elastic grant-shard scale-out: a new "memory node" joins the
        grant ring; every still-ungranted chunk re-homes onto the grown
        ring round-robin.  Granted chunks (live pages) never move."""
        self.cfg = cfg = dataclasses.replace(self.cfg,
                                             n_shards=self.cfg.n_shards + 1)
        self.cursor = np.concatenate([self.cursor, np.zeros(1, np.int32)])
        free = self.grant == 0
        self.shard_of_chunk[free] = \
            np.arange(int(free.sum())) % cfg.n_shards
        return cfg.n_shards - 1

    def _slab(self, cid: int) -> ClientSlab:
        return self.slabs.setdefault(cid, ClientSlab())

    def alloc_pages(self, cid: int, n: int) -> np.ndarray:
        """Client-side fine allocation of n pages (slab pop; grants chunks
        as needed).  Returns page ids (-1 = pool exhausted)."""
        sl = self._slab(cid)
        out = []
        for _ in range(n):
            if not sl.free:
                c = self._grant_chunk(cid)
                if c is None:
                    out.append(-1)
                    continue
                base = c * self.cfg.chunk_pages
                sl.free.extend(range(base, base + self.cfg.chunk_pages))
                sl.chunks.append(c)
            out.append(sl.free.pop(0))
        return np.array(out, np.int32)

    def write_pages(self, cid: int, pages: np.ndarray, keys: np.ndarray,
                    opcode: int):
        """Write the pages' embedded log entries in one device op (the
        paper's single-RDMA_WRITE log embedding).  Chain pointers come from
        the deterministic slab order (pre-positioned)."""
        sl = self._slab(cid)
        pages = np.asarray(pages, np.int32)
        nxt = np.array([sl.free[0] + 1 if sl.free else 0] * len(pages),
                       np.int32)
        for i in range(len(pages) - 1):
            nxt[i] = pages[i + 1] + 1
        prv = np.concatenate([[sl.last_alloc], pages[:-1] + 1]).astype(np.int32)
        if len(pages):
            sl.last_alloc = int(pages[-1]) + 1
        n = len(pages)
        entries = np.stack([np.zeros(n, np.int32), np.full(n, opcode, np.int32),
                            np.asarray(keys, np.int32), np.ones(n, np.int32)],
                           axis=1)
        pg = self._tensor(pages)
        self.log[pg] = self._tensor(entries, torch.int32)
        self.chain[pg] = self._tensor(np.stack([nxt, prv], axis=1),
                                      torch.int32)

    def free_pages(self, pages):
        """Any client: set free bits (the RDMA_FAA on the free bitmap)."""
        if not isinstance(pages, torch.Tensor):
            pages = self._tensor(pages)
        self.free_bitmap[pages.to(torch.int64)] = 1

    def reclaim(self, cid: int) -> int:
        """Owner-side batched reclaim of freed pages in own chunks (§4.4)."""
        sl = self._slab(cid)
        bm = self.free_bitmap.cpu().numpy()
        cp = self.cfg.chunk_pages
        n = 0
        for c in sl.chunks:
            for p in range(c * cp, (c + 1) * cp):
                if bm[p]:
                    sl.free.append(p)
                    n += 1
        if n:
            idx = self._tensor([p for c in sl.chunks
                                for p in range(c * cp, (c + 1) * cp)])
            self.free_bitmap[idx] = 0
            self.log[idx, 3] = 0
        return n

    # -------------------------------------------------------------- index --
    def search(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Batched SEARCH on the primary replica (``race_lookup`` kernel),
        with the RACE data-access integrity check: the key stored on the
        pointed page must match, or the probe is a fingerprint collision ->
        miss."""
        cfg = self.cfg
        self.stats["search_batches"] += 1
        keys = np.asarray(keys, np.int32)
        idx2d = self.index[0].reshape(cfg.n_buckets, cfg.slots_per_bucket)
        kt = self._tensor(keys)
        ptr, found = race_lookup(kt & 0xFFFFFFFF, idx2d)
        page_keys = self.log[ptr.to(torch.int64), 2]
        verified = found & (page_keys == kt)
        host = torch.stack([ptr, found.to(torch.int32),
                            verified.to(torch.int32)]).cpu().numpy()
        ptr, found, verified = host[0], host[1] != 0, host[2] != 0
        shadowed = found & ~verified
        if shadowed.any():
            # collision path (read amplification): probe ALL candidate
            # slots of both buckets and verify keys, as RACE prescribes
            p2, f2 = self._search_all_candidates(keys[shadowed])
            ptr = ptr.copy()
            ptr[shadowed] = p2
            verified = verified.copy()
            verified[shadowed] = f2
        return np.where(verified, ptr, 0), verified

    def _search_all_candidates(self, keys: np.ndarray):
        kt = self._tensor(keys)
        offs, fp = self._candidates(kt)
        rows = self.index[0][offs].cpu().numpy()
        fpv = fp.cpu().numpy()
        log_keys = self.log[:, 2].cpu().numpy()
        ptr = np.zeros(len(keys), np.int32)
        found = np.zeros(len(keys), bool)
        for i in range(len(keys)):
            for w in rows[i]:
                if w == 0:
                    continue
                if ((int(w) >> 24) & 0xFF) == fpv[i] and \
                        log_keys[int(w) & 0xFFFFFF] == keys[i]:
                    ptr[i] = int(w) & 0xFFFFFF
                    found[i] = True
                    break
        return ptr, found

    def _candidates(self, keys: torch.Tensor):
        """Flat slot offsets of both candidate buckets, (W, 2*spb), bucket-1
        slots first, and each key's fingerprint."""
        cfg = self.cfg
        spb = cfg.slots_per_bucket
        b1, b2 = SL.bucket_pair(keys & 0xFFFFFFFF, cfg.n_buckets)
        ar = torch.arange(spb, device=self.device)
        offs = torch.cat([b1[:, None] * spb + ar, b2[:, None] * spb + ar],
                         dim=1)
        return offs, SL.fingerprint32(keys & 0xFFFFFFFF)

    def _match_rows(self, keys: torch.Tensor, offs, fp):
        """The primary's candidate slots, and which hold this key (fp match
        verified against the page's key, so a colliding entry is never
        taken for it)."""
        rows = self.index[0][offs]
        page_keys = self.log[SL.slot_ptr(rows).to(torch.int64), 2]
        is_match = ((SL.slot_fp(rows) == fp[:, None]) & (rows != 0)
                    & (page_keys == keys[:, None]))
        return rows, is_match

    def insert_batch(self, cid: int, keys: np.ndarray, pages: np.ndarray,
                     opcode: int = OP_INSERT) -> np.ndarray:
        """INSERT/UPDATE a batch of prefix keys -> pages via one (or more)
        SNAPSHOT epochs.  Returns success mask."""
        kt = self._tensor(np.asarray(keys, np.int32))
        pt = self._tensor(np.asarray(pages, np.int32))
        offs, fp = self._candidates(kt)
        v_new = SL.pack_slot(fp, pt)
        done = np.zeros(len(keys), bool)
        for _attempt in range(2 * self.cfg.slots_per_bucket):
            # target slot per key: existing same-key slot else first empty
            rows, is_match = self._match_rows(kt, offs, fp)
            is_empty = rows == 0
            has_match = is_match.any(dim=1)
            cand = torch.where(has_match,
                               is_match.to(torch.int8).argmax(dim=1),
                               is_empty.to(torch.int8).argmax(dim=1))
            ok = has_match | is_empty.any(dim=1)
            slot = offs.gather(1, cand[:, None])[:, 0]
            v_old = rows.gather(1, cand[:, None])[:, 0]
            act = self._tensor(~done, torch.bool) & ok
            res = snapshot_epoch(self.index, torch.where(act, slot, -1),
                                 v_old, v_new, self._draw_prios(len(keys)))
            self.index = res.index
            self.stats["epochs"] += 1
            # commit logs of winners (old value into the embedded entry)
            win = res.win
            self.log[pt[win], 0] = v_old[win] | _COMMITTED
            # a winner that overwrote a same-key slot superseded that key's
            # old page: free it (any-client bitmap free, §4.4) so upserts
            # don't leak pool capacity
            self.free_pages(SL.slot_ptr(v_old[win & (v_old != 0)]))
            done |= win.cpu().numpy()
            if done.all():
                break
        return done

    def delete_batch(self, cid: int, keys: np.ndarray) -> np.ndarray:
        """DELETE: SNAPSHOT-write slot -> 0 (plus temp log page, elided)."""
        _ptr, found = self.search(keys)
        kt = self._tensor(np.asarray(keys, np.int32))
        offs, fp = self._candidates(kt)
        rows, is_match = self._match_rows(kt, offs, fp)
        first = is_match.to(torch.int8).argmax(dim=1)[:, None]
        slot = offs.gather(1, first)[:, 0]
        v_old = rows.gather(1, first)[:, 0]
        act = self._tensor(found, torch.bool) & is_match.any(dim=1)
        res = snapshot_epoch(self.index, torch.where(act, slot, -1), v_old,
                             torch.zeros_like(v_old),
                             self._draw_prios(len(keys)))
        self.index = res.index
        self.stats["epochs"] += 1
        # free the deleted pages (any-client free via bitmap)
        self.free_pages(SL.slot_ptr(v_old[res.win]))
        return res.win.cpu().numpy()

    # ----------------------------------------------------------- recovery --
    def crash_client(self, cid: int):
        self.slabs.pop(cid, None)

    def recover_client(self, cid: int, reassign_to: Optional[int] = None
                       ) -> Dict[str, int]:
        """§5.3 for the serving pool: re-own chunks from the grant table,
        walk the embedded log, reclaim unused pages, redo uncommitted winner
        index writes."""
        cfg = self.cfg
        stats = {"chunks": 0, "used_pages": 0, "reclaimed": 0, "redone": 0}
        chunks = np.where(self.grant == cid + 1)[0]
        stats["chunks"] = len(chunks)
        log = self.log.cpu().numpy()
        new_owner = reassign_to if reassign_to is not None else cid
        sl = self._slab(new_owner)
        for c in chunks:
            self.grant[c] = new_owner + 1
            if c not in sl.chunks:
                sl.chunks.append(int(c))
            base = c * cfg.chunk_pages
            for p in range(base, base + cfg.chunk_pages):
                used = log[p, 3] & 1
                if not used:
                    if p not in sl.free:
                        sl.free.append(p)
                    stats["reclaimed"] += 1
                    continue
                stats["used_pages"] += 1
                committed = bool(log[p, 0] & _COMMITTED)
                if not committed and log[p, 1] in (OP_INSERT, OP_UPDATE):
                    # redo: re-run the index write for this page (§5.3 c1)
                    ok = self.insert_batch(new_owner,
                                           np.array([log[p, 2]], np.int32),
                                           np.array([p], np.int32),
                                           opcode=int(log[p, 1]))
                    stats["redone"] += int(ok[0])
        return stats

    # --------------------------------------------------------- invariants --
    def check_replicas_converged(self) -> bool:
        idx = self.index.cpu().numpy()
        return bool((idx[1:] == idx[0]).all()) if self.cfg.replicas > 1 else True
