"""Continuous-batching serve engine over a FUSEE-managed KV pool.

Requests stream in; the engine packs up to ``max_batch`` of them into fixed
decode slots, prefills new arrivals, decodes the active set each step, and
retires finished sequences.  The FUSEE pool provides:

* prefix-cache metadata: prompt token-blocks are hashed; block hashes are
  SEARCHed in the RACE index (``race_lookup`` kernel) — hits are counted
  as reusable prefix pages (the disaggregated prefix cache), misses are
  INSERTed via SNAPSHOT epochs;
* page accounting for each slot's cache blocks via the two-level allocator
  (chunk grants from pool shards -> client slab);
* crash recovery of engine workers via the embedded page log.

The engine keeps the reference's semantics: one scalar cache length shared
by all slots, prompts right-padded to the longest one on every (re)prefill,
and the whole active batch re-prefilled whenever membership changes.  It
runs eagerly on the model's device, one decode step per tick.

Counterpart of the JAX package's ``serving/engine.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.api import KVStore, Op
from ..core.events import OK
from ..kernels import flash_attention, paged_attention, race_lookup
from ..obs.serve import ServeTrace
from .backend import DeviceBackend
from .kvpool import PoolConfig

BLOCK_TOKENS = 64   # prefix-hash granularity


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    slot: int = -1
    pages: Optional[np.ndarray] = None
    surplus: Optional[np.ndarray] = None  # allocated pages that lost insert
    prefix_hits: int = 0


def _block_hashes(prompt: np.ndarray) -> np.ndarray:
    """Rolling content hash per BLOCK_TOKENS block (prefix identity)."""
    nb = len(prompt) // BLOCK_TOKENS
    out = np.zeros(max(nb, 0), np.int64)
    h = 1469598103  # FNV-style rolling hash in Python ints (no overflow)
    for b in range(nb):
        blk = prompt[b * BLOCK_TOKENS:(b + 1) * BLOCK_TOKENS]
        for x in (b, *(int(t) for t in blk[::7])):
            h = ((h ^ x) * 1099511628211) & 0x7FFFFFFF
        out[b] = h
    return out.astype(np.int32)


class ServeEngine:
    """Serves ``Request``s with ``model`` (``models.Model``) and its
    parameter tree; the prefix-cache pool lives on the model's device."""

    def __init__(self, model, params, *, max_batch: int = 4,
                 max_len: int = 256, pool_cfg: Optional[PoolConfig] = None,
                 cid: int = 0, seed: int = 0):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = model.device
        # unified store API over the device-resident pool
        self._backend = DeviceBackend(pool_cfg or PoolConfig(), cid=cid,
                                      seed=seed, device=self.device)
        self.store = KVStore(self._backend)
        self.cid = cid
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self.cache = None
        self.slots_free = list(range(max_batch))
        self.slot_tokens = np.zeros((max_batch, max_len), np.int32)
        self.slot_len = np.zeros((max_batch,), np.int32)
        self.steps = 0
        self.trace: Optional[ServeTrace] = None

    def enable_trace(self) -> ServeTrace:
        """Record this engine's and its model's spans and counters from
        now on (``obs/serve.py``), with a CUDA event pair around each
        model call on a CUDA device.  Returns the recorder."""
        self.trace = ServeTrace(
            events=self.device.type == "cuda",
            launched=(race_lookup, paged_attention, flash_attention))
        self.model.trace = self.trace
        return self.trace

    @property
    def pool(self):
        """The device pool behind the store (stats / recovery / tests)."""
        return self._backend.pool

    def submit(self, req: Request):
        if self.trace is not None:
            self.trace.submitted(req)
        self.queue.append(req)

    # -------------------------------------------------- worker recovery --
    def crash_worker(self, cid: Optional[int] = None):
        """Crash-stop an engine worker: its slab state is dropped and, if
        it is THIS engine's worker, further store submits raise the typed
        ``ClientCrashed``."""
        cid = self.cid if cid is None else cid
        self.pool.crash_client(cid)
        if cid == self.cid:
            self._backend.crashed = True

    def recover_worker(self, cid: Optional[int] = None,
                       reassign_to: Optional[int] = None) -> Dict[str, int]:
        """§5.3 recovery from the embedded page log: re-own chunks, reclaim
        unused pages, redo uncommitted winner index writes.  Recovering
        this engine's own worker (or reassigning onto it) reopens its
        store for submits."""
        cid = self.cid if cid is None else cid
        st = self.pool.recover_client(cid, reassign_to=reassign_to)
        new_owner = reassign_to if reassign_to is not None else cid
        if new_owner == self.cid:
            self._backend.crashed = False
        return st

    # ------------------------------------------------ pool elasticity --
    def scale_pool(self) -> int:
        """Elastic scale-out of the prefix-cache pool: a fresh grant shard
        joins the ring and ungranted page chunks re-home onto it.  Returns
        the new shard id."""
        return self.pool.add_shard()

    def health(self) -> Dict:
        """Slot occupancy + pool/backend counters."""
        return {
            "active": len(self.active), "queued": len(self.queue),
            "finished": len(self.finished), "slots_free": len(self.slots_free),
            "steps": self.steps, "pool_shards": self.pool.cfg.n_shards,
            **self._backend.stats(),
        }

    def metrics(self) -> Dict:
        """Registry-style snapshot: engine/backend counters under
        ``serve.*`` dotted names, in the sectioned layout of the JAX
        package's ``metrics()``."""
        counters = {
            "serve.active": len(self.active),
            "serve.queued": len(self.queue),
            "serve.finished": len(self.finished),
            "serve.steps": self.steps,
        }
        for k, v in self._backend.stats().items():
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
                counters["serve." + k] = int(v)
        return {"counters": counters,
                "gauges": {"serve.slots_free": len(self.slots_free),
                           "serve.pool_shards": self.pool.cfg.n_shards},
                "histograms": {}, "series": {}, "heat": {}}

    def list_prefixes(self, start: int = 0, count: int = 64) -> List[tuple]:
        """Ordered listing of live prefix-cache entries: the next
        ``count`` block-hash keys >= ``start`` in key order, each with its
        backing page id — the serving twin of the simulator's SCAN
        (located by the ``leaf_probe`` kernel, validated against the
        device index in one batched ``race_lookup`` probe)."""
        res = self.store.submit(Op.scan(start, count)).result()
        keys = [k for (k, _v) in (res.value or [])]
        if not keys:
            return []
        ptr, found = self.pool.search(np.array(keys, np.int64)
                                      .astype(np.int32))
        return [(int(k), int(p)) for k, p, f in
                zip(keys, ptr, found) if f]

    # ------------------------------------------------------------- ticks --
    def _admit(self):
        """Admit every queued request a free slot allows, then serve ALL
        their prefix lookups with one batched GET wave (one pool.search ->
        race_lookup launch per admit tick) and all their misses with one
        batched INSERT wave."""
        tr = self.trace
        if tr is not None:
            span = tr.begin("serve.admit")
        admitted: List[Request] = []
        while self.queue and self.slots_free:
            req = self.queue.pop(0)
            req.slot = self.slots_free.pop(0)
            admitted.append(req)
        if not admitted:
            if tr is not None:
                tr.end(span, admitted=0)
            return False
        if tr is not None:
            tr.admitted(admitted)
            sub = tr.begin("serve.admit.hash")
        hashes = [_block_hashes(req.prompt) for req in admitted]
        flat = [int(h) for hs in hashes for h in hs]
        if tr is not None:
            tr.end(sub)
        found = ins = None
        epochs = 0
        if flat:
            if tr is not None:
                sub = tr.begin("serve.admit.search")
            res = [f.result() for f in self.store.submit_batch(
                [Op.get(h) for h in flat])]
            found = np.array([r.status == OK for r in res], bool)
            if tr is not None:
                tr.end(sub)
            miss_idx = [i for i in range(len(flat)) if not found[i]]
            ins_res = {}
            if miss_idx:
                if tr is not None:
                    sub = tr.begin("serve.admit.insert")
                    epochs0 = self.pool.stats["epochs"]
                # duplicate hashes across requests collapse to one page in
                # the device batch (concurrent upserts of one key)
                ins = [f.result() for f in self.store.submit_batch(
                    [Op.insert(flat[i], None) for i in miss_idx])]
                ins_res = dict(zip(miss_idx, ins))
                if tr is not None:
                    epochs = self.pool.stats["epochs"] - epochs0
                    tr.end(sub, keys=len(miss_idx), epochs=epochs)
            pos = 0
            for req, hs in zip(admitted, hashes):
                fnd = found[pos:pos + len(hs)]
                req.prefix_hits = int(fnd.sum())
                rs = [ins_res[pos + j] for j in range(len(hs)) if not fnd[j]]
                if rs:
                    req.pages = np.array(
                        [r.page if r.page is not None else -1 for r in rs],
                        np.int32)
                    # a page whose insert lost (another worker's page won
                    # the slot) is unreferenced by the index: remember it
                    # for release at retire
                    req.surplus = np.array(
                        [r.page for r in rs
                         if r.status != OK and r.page is not None
                         and r.page >= 0], np.int32)
                pos += len(hs)
        for req in admitted:
            self.slot_tokens[req.slot, :len(req.prompt)] = req.prompt
            self.slot_len[req.slot] = len(req.prompt)
            self.active[req.slot] = req
        if tr is not None:
            tr.end(span, admitted=len(admitted),
                   prompt_tokens=sum(len(r.prompt) for r in admitted),
                   **tr.admission(found, ins, epochs))
        return True

    def _prefill_all(self):
        """(Re)prefill the whole active batch into the cache: the pages of
        the last prefill, zeroed and refilled in place where they fit
        (``Model.cache_fits``; a captured decode step reads them where
        they are), else fresh pages.

        Fixed-slot batching: the batch tensor always has max_batch rows;
        empty slots hold a pad prompt of length 1."""
        L = int(self.slot_len.max()) if self.active else 1
        L = max(L, 1)
        toks = torch.as_tensor(self.slot_tokens[:, :L], dtype=torch.int64,
                               device=self.device)
        reuse, self.cache = self.cache, None
        if not self.model.cache_fits(reuse, toks.shape[0], L, self.max_len):
            reuse = None            # free the old pages before the new ones
        tr = self.trace
        if tr is not None:
            span = tr.begin("serve.prefill", device=True)
        logits, self.cache = self.model.prefill(self.params, toks,
                                                max_len=self.max_len,
                                                cache=reuse)
        del reuse
        if tr is not None:
            tr.end(span, batch=toks.shape[0], seq=toks.shape[1])
        return logits

    def _emit(self, logits):
        """Append each active slot's greedy next token (a slot at max_len
        keeps its tokens; it retires this tick)."""
        tr = self.trace
        if tr is not None:
            span = tr.begin("serve.emit")
            sync = tr.begin("serve.emit.sync")
        nxt = logits[:, -1].argmax(dim=-1).cpu().numpy()
        if tr is not None:
            tr.end(sync)
        for s, req in self.active.items():
            tok = int(nxt[s])
            req.out.append(tok)
            pos = int(self.slot_len[s])
            if pos < self.max_len:
                self.slot_tokens[s, pos] = tok
                self.slot_len[s] = pos + 1
        if tr is not None:
            tr.end(span)

    def step(self) -> int:
        """One engine tick: admit + (re)prefill if membership changed, else
        decode one token for every active slot.  Returns #active."""
        tr = self.trace
        if tr is not None:
            step = tr.begin_step()
        changed = self._admit()
        if not self.active:
            if tr is not None:
                tr.end_step(step, "idle")
            return 0
        prefill = changed or self.cache is None
        if prefill:
            self._emit(self._prefill_all())
        else:
            token = torch.as_tensor(
                self.slot_tokens[np.arange(self.max_batch),
                                 np.maximum(self.slot_len - 1, 0)][:, None],
                dtype=torch.int64, device=self.device)
            if tr is not None:
                span = tr.begin("serve.decode", device=True)
            logits, self.cache = self.model.decode_step(self.params,
                                                        self.cache, token)
            if tr is not None:
                tr.end(span, batch=token.shape[0],
                       valid=self.cache["length"])
            self._emit(logits)
        self.steps += 1
        # retire finished
        for s in list(self.active):
            req = self.active[s]
            if len(req.out) >= req.max_new or self.slot_len[s] >= self.max_len:
                self.finished.append(req)
                del self.active[s]
                self.slots_free.append(s)
                self.slot_tokens[s] = 0
                self.slot_len[s] = 0
                if req.surplus is not None and len(req.surplus):
                    # pages this request allocated that LOST their insert
                    # race are unreachable — free them back to the pool
                    self._backend.release_pages(req.surplus)
        if tr is not None:
            tr.end_step(step, "prefill" if prefill else "decode")
        return len(self.active)

    def run(self, max_ticks: int = 1000) -> List[Request]:
        while (self.queue or self.active) and self.steps < max_ticks:
            self.step()
        return self.finished
