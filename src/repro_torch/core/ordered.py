"""Ordered secondary index on DM: a replicated, client-managed keydir.

FUSEE's RACE hash index cannot answer range queries, which closes the
whole YCSB-E / prefix-listing workload class.  This module adds a second,
*ordered* index beside the RACE shards: a B+-tree-style keydir of fat,
cache-line-multiple leaves living in its own epoch-versioned region
(``DMConfig.ordered_index=True``; heap.py hosts + places it on the ring
like any other region), mutated with the same client-centric one-sided
verbs and repaired by the master with the same Alg-3 adopt-backup rule.

Layout (word-addressed, ``LEAF_WORDS`` = 16 words = 128 B = two cache
lines)::

    word 0                    leaf-alloc cursor (next free leaf id; FAA)
    word LEAF_BASE + i*16     leaf i:
        w0   low fence key (raw 64-bit; immutable for the leaf's lifetime)
        w1   | magic:8 | ver:16 | next_leaf:20 | reserved:12 | crc:8 |
        w2   prev leaf id   (the embedded *split record*: which leaf
             spawned this one; crc in w1 covers (low, prev) and acts as
             the record's commit mark)
        w3.. LEAF_ENTRIES entry words, each ``key+1`` (0 = empty slot)

Protocol (all client-side, generator-yielded phases, exactly the
one-sided discipline of client.py):

* **locate** — clients cache ``(low, leaf_id)`` fences (append-only
  facts: a leaf's low never changes and leaves are never merged), pick
  the rightmost fence <= key via the vectorized ``leaf_probe`` entry
  point (Pallas on TPU, the bit-exact numpy mirror below elsewhere), and
  B-link *move right* along next pointers for leaves split since.
* **ensure** (ordered half of INSERT, after the RACE commit) — claim an
  empty entry word with CAS on the primary (unique winner), broadcast the
  word to backups, then re-read the leaf version in the same QP (FIFO
  after the claim) — a version bumped by a concurrent split means the
  claim may straddle the split's fence, so it is undone and retried.
* **split** — FAA the cursor to allocate a leaf id, write the new leaf
  (movers = keys >= median, low = median, embedded prev record) to all
  replicas while it is still unreachable, link it with a CAS on the old
  leaf's meta word (primary winner election, version bump), then re-read
  the old leaf and move any straggler claims that raced the first pass
  before clearing movers (backups first, primary last — the "backups are
  never older than the primary" invariant Alg-3 repair relies on).
* **clear** (ordered half of DELETE, after the RACE commit) — CAS the
  entry to 0 (backups first), then re-check the key against the RACE
  index: if a concurrent re-insert committed, the entry is re-ensured.
  Erring toward a *present* entry is always safe — scans validate every
  candidate against the RACE index, so a spurious entry is filtered, but
  a missing entry would hide a committed key.
* **scan / range** — sweep the leaf chain in batched multi-leaf reads
  (``ORD_SWEEP`` leaves per doorbell batch = 1 RTT), select in-range
  entries, then fetch + validate the values through the RACE index in two
  batched phases (bucket reads, object reads) for the whole candidate
  set.  The naive baseline (``batched=False``) reads one leaf per RTT and
  verifies one key per 2 RTTs — the scan benchmark's >=4x ops/RTT claim.

Failure contract: by the time an op acks, every replica holds its ordered
mutation, so the master's word-wise adopt-backup repair can never revert
an acknowledged entry.  ``repair_ordered`` (run by Alg-3 MN recovery, the
migration cutover, and §5.3 client recovery) additionally (1) discards
written-but-never-linked leaves via their embedded split records (the
half-split case), and (2) re-homes entries stranded outside their leaf's
fence range by a crashed splitter.  Scans after recovery + quiescence
return exactly the committed keys (tests/test_ordered.py).

Counterpart of the JAX package's ``core/ordered.py``: the client protocol
is the same host Python, verb for verb.  Two things differ, neither in
what is computed:

* every locate goes through the ``leaf_probe`` kernel on the pool's device
  (``kernels/leaf_probe``; the plain torch version on a CPU pool);
* the master-side helpers (``repair_ordered``, ``ensure_entry_direct``,
  ``ordered_keys_direct``) run the reference's word-level code on one host
  copy of each alive replica and write back only the words that changed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import layout as L
from . import race
from .events import FULL, NOT_FOUND, OK, MasterCall, OpResult, Phase, Verb
from .heap import as_i64_bits, set_word, to_u64
from ..kernels.leaf_probe import leaf_probe

__all__ = ["LEAF_WORDS", "LEAF_ENTRIES", "leaf_probe_np", "init_region",
           "op_scan", "op_range", "ord_ensure", "ord_clear",
           "repair_ordered", "ensure_entry_direct", "ordered_keys_direct"]

MASK64 = (1 << 64) - 1

# ---------------------------------------------------------------- geometry
LEAF_WORDS = 16          # 128 B: fat, cache-line-multiple leaves
LEAF_HDR = 3
LEAF_ENTRIES = LEAF_WORDS - LEAF_HDR
LEAF_BASE = 8            # words 0..7: cursor + reserved header
CURSOR_OFF = 0
ORD_MAGIC = 0xB7

ORD_SWEEP = 32           # leaves per batched chain-sweep phase (1 RTT)
ORD_VBATCH = 64          # scan candidates validated per phase pair
MAX_ORD_RETRIES = 64     # bounded retry, mirrors client.MAX_OP_RETRIES


def leaf_off(leaf_id: int) -> int:
    return LEAF_BASE + leaf_id * LEAF_WORDS


def entry_off(leaf_id: int, j: int) -> int:
    return leaf_off(leaf_id) + LEAF_HDR + j


def max_leaves(region_words: int) -> int:
    return (region_words - LEAF_BASE) // LEAF_WORDS


def stored(key: int) -> int:
    """Entry encoding: key+1, so 0 unambiguously means "empty".  The one
    unrepresentable key (2^64-1) is reserved while the ordered index is
    enabled (hashed byte keys land there with probability 2^-64)."""
    return (int(key) + 1) & MASK64


def unstored(word: int) -> int:
    return (int(word) - 1) & MASK64


def pack_meta(ver: int, next_id: int, crc: int) -> int:
    return ((ORD_MAGIC << 56) | ((ver & 0xFFFF) << 40)
            | ((next_id & 0xFFFFF) << 20) | (crc & 0xFF))


def meta_magic(w) -> int:
    return (int(w) >> 56) & 0xFF


def meta_ver(w) -> int:
    return (int(w) >> 40) & 0xFFFF


def meta_next(w) -> int:
    return (int(w) >> 20) & 0xFFFFF


def meta_crc(w) -> int:
    return int(w) & 0xFF


def leaf_crc(low: int, prev: int) -> int:
    return L.crc8([int(low), int(prev)])


def build_leaf(low: int, ver: int, next_id: int, prev: int,
               entries: List[int]) -> List[int]:
    """Full word list of a leaf (entries already in stored encoding)."""
    assert len(entries) <= LEAF_ENTRIES  # lint: allow-assert (internal geometry; callers split first)
    words = [int(low), pack_meta(ver, next_id, leaf_crc(low, prev)),
             int(prev)] + [int(e) for e in entries]
    words += [0] * (LEAF_WORDS - len(words))
    return words


def parse_leaf(words) -> Dict:
    """Header + entries of one leaf's word list; ``valid`` = the embedded
    (low, prev, crc) record committed, i.e. the leaf was fully written."""
    words = [int(w) for w in words]
    low, meta, prev = words[0], words[1], words[2]
    return dict(
        low=low, ver=meta_ver(meta), next=meta_next(meta), prev=prev,
        meta=meta, entries=words[LEAF_HDR:],
        valid=(meta_magic(meta) == ORD_MAGIC
               and meta_crc(meta) == leaf_crc(low, prev)),
    )


# ------------------------------------------------- vectorized leaf probe --
def leaf_probe_np(starts: np.ndarray, lows: np.ndarray):
    """NumPy statement of the leaf probe: for each start key, the index of
    the rightmost fence low <= start (``-1`` when every low exceeds the
    start — impossible against a chain rooted at low 0).

    ``lows`` must be sorted ascending.  The tests hold the ``leaf_probe``
    kernel's plain version to it, and it to the JAX package's."""
    starts = np.asarray(starts, np.uint64)
    lows = np.asarray(lows, np.uint64)
    return np.searchsorted(lows, starts, side="right").astype(np.int32) - 1


def _lows_tensor(lows, device) -> torch.Tensor:
    """Sorted uint64 lows as the int64 bit patterns the kernel takes."""
    arr = np.asarray(lows, np.uint64)
    return torch.from_numpy(arr.view(np.int64)).to(device)


def _leaf_probe(starts, lows: torch.Tensor) -> np.ndarray:
    """One ``leaf_probe`` call for ``starts`` (uint64 values) against the
    sorted ``lows`` on their device; the result as host int32."""
    st = torch.from_numpy(np.asarray(starts, np.uint64).view(np.int64))
    return leaf_probe(st.to(lows.device), lows).cpu().numpy()


def locate_leaves(client, starts: List[int]) -> List[int]:
    """Map start keys to covering-leaf-id hints from the client's fence
    cache, via one ``leaf_probe`` call on the pool's device.  Returns -1
    hints when the cache is cold — the scan bootstraps."""
    fences = client.ord_fences
    if not fences:
        return [-1] * len(starts)
    ids_by_low = sorted((low, lid) for lid, low in fences.items())
    lows = _lows_tensor([low for low, _lid in ids_by_low], client.pool.device)
    idx = _leaf_probe(starts, lows)
    return [ids_by_low[int(i)][1] if i >= 0 else ids_by_low[0][1]
            for i in idx]


# ------------------------------------------------------ region bootstrap --
def init_region(pool, region: int):  # lint: allow-pool-mutation (bootstrap: pool not live yet, no verb layer to go through)
    """Write the cursor + head leaf into every replica of a fresh ordered
    region (pool construction time; no verbs, the pool is not live yet)."""
    head = build_leaf(low=0, ver=0, next_id=0, prev=0, entries=[])
    words = torch.from_numpy(as_i64_bits([w & MASK64 for w in head]))
    for mid in pool.placement[region]:
        mem = pool.mns[mid].regions[region]
        set_word(mem, CURSOR_OFF, 1)
        mem[leaf_off(0):leaf_off(0) + LEAF_WORDS] = words.to(mem.device)


# ================================================== client-side protocol ==
def _region_of(client) -> Optional[int]:
    regs = getattr(client.pool, "ordered_regions", None)
    return regs[0] if regs else None


def _read_leaf_verb(region: int, leaf_id: int, replica: int = 0) -> Verb:
    return Verb("read", region=region, replica=replica,
                off=leaf_off(leaf_id), n=LEAF_WORDS)


def _r(client, region: int) -> int:
    return len(client.pool.placement[region])


def _fail_wait(client):
    """FAIL verb seen (dead MN / stale epoch): report + wait a beat."""
    yield MasterCall("fail_report", payload=dict(cid=client.cid))
    yield Phase([], label="ord:wait_membership")


def _read_leaf(client, region: int, leaf_id: int):
    """Read one leaf (primary), retrying across FAIL/epoch bounces."""
    for _ in range(MAX_ORD_RETRIES):
        res = yield Phase([_read_leaf_verb(region, leaf_id)],
                          label="ord:read_leaf")
        if res[0] is not None:
            return parse_leaf(res[0])
        yield from _fail_wait(client)
    return None


def _bootstrap_fences(client, region: int):
    """Cold start: read the cursor, sweep every allocated leaf in batched
    multi-leaf reads, and walk the chain from leaf 0 to learn the fence
    table.  Only *reachable* leaves enter the cache — a written-but-
    unlinked leaf (a split that never linked) must never attract claims."""
    for _ in range(MAX_ORD_RETRIES):
        res = yield Phase([Verb("read", region=region, replica=0,
                                off=CURSOR_OFF, n=1)], label="ord:cursor")
        if res[0] is not None:
            n_leaves = int(res[0][0])
            break
        yield from _fail_wait(client)
    else:
        return
    leaves: Dict[int, Dict] = {}
    ids = list(range(min(n_leaves, max_leaves(client.cfg.region_words))))
    for s in range(0, len(ids), ORD_SWEEP):
        chunk = ids[s:s + ORD_SWEEP]
        for _ in range(MAX_ORD_RETRIES):
            res = yield Phase([_read_leaf_verb(region, i) for i in chunk],
                              label="ord:sweep")
            if all(r is not None for r in res):
                break
            yield from _fail_wait(client)
        for i, raw in zip(chunk, res):
            if raw is not None:
                leaves[i] = parse_leaf(raw)
    # chain walk from the head: reachable leaves only
    client.ord_fences = {}
    cur, hops = 0, 0
    while cur in leaves and hops <= len(leaves):
        lf = leaves[cur]
        if not lf["valid"]:
            break
        client.ord_fences[cur] = lf["low"]
        cur, hops = lf["next"], hops + 1
        if cur == 0:
            break


def _locate(client, key: int, *, hint: int = -1):
    """Find the covering leaf of ``key``: fence-cache probe (or ``hint``
    from a fleet-wide batched probe), then B-link move-right.  Returns
    ``(leaf_id, parsed_leaf)`` — the leaf's low is <= key and its
    successor's low (if any) is > key at read time."""
    region = _region_of(client)
    if not client.ord_fences and hint < 0:
        yield from _bootstrap_fences(client, region)
    if hint >= 0:
        cand = hint       # fleet-wide probe hint; validated by the read
    elif client.ord_fences:
        cand = locate_leaves(client, [key])[0]
    else:
        cand = 0
    for _ in range(MAX_ORD_RETRIES):
        lf = yield from _read_leaf(client, region, cand)
        if lf is None or not lf["valid"] or lf["low"] > key:
            # stale/invalid hint (repair discarded a leaf, or a cold
            # cache miss): restart from the chain head
            yield from _bootstrap_fences(client, region)
            cand = (locate_leaves(client, [key])[0]
                    if client.ord_fences else 0)
            lf = yield from _read_leaf(client, region, cand)
            if lf is None:
                return None, None
        client.ord_fences[cand] = lf["low"]
        if lf["next"] == 0:
            return cand, lf
        nxt = yield from _read_leaf(client, region, lf["next"])
        if nxt is None or not nxt["valid"]:
            return cand, lf           # half-linked successor: ours covers
        client.ord_fences[lf["next"]] = nxt["low"]
        if nxt["low"] > key:
            return cand, lf
        cand = lf["next"]             # move right
    return None, None


# --------------------------------------------------------------- ensure --
def ord_ensure(client, key: int):
    """Ordered half of INSERT (runs after the RACE commit, before the op
    acks): make ``key``'s entry present on every replica of its covering
    leaf.  See the module docstring for the claim/guard protocol."""
    region = _region_of(client)
    if region is None or int(key) == MASK64:
        return OK
    sv = stored(key)
    for _ in range(MAX_ORD_RETRIES):
        leaf_id, lf = yield from _locate(client, key)
        if leaf_id is None:
            return FULL
        r = _r(client, region)
        present = [j for j, e in enumerate(lf["entries"]) if e == sv]
        if present:
            # complete replication (a racing claimer may have crashed
            # between its primary CAS and its backup broadcast)
            if r > 1:
                res = yield Phase(
                    [Verb("write", region=region, replica=i,
                          off=entry_off(leaf_id, present[0]), words=[sv])
                     for i in range(1, r)], label="ord:ensure_backups")
                if any(x is None for x in res):
                    yield from _fail_wait(client)
                    continue
            return OK
        empty = [j for j, e in enumerate(lf["entries"]) if e == 0]
        if not empty:
            st = yield from _split(client, region, leaf_id, lf)
            if st == FULL:
                return FULL
            continue
        j = empty[0]
        # claim (primary CAS) + version guard read in ONE phase: both
        # verbs target the primary MN, so QP FIFO executes the guard
        # strictly after the claim — a version unchanged at guard time
        # means any later splitter's post-link re-read will see our entry
        res = yield Phase(
            [Verb("cas", region=region, replica=0,
                  off=entry_off(leaf_id, j), exp=0, new=sv),
             Verb("read", region=region, replica=0,
                  off=leaf_off(leaf_id) + 1, n=1)],
            label="ord:claim")
        if res[0] is None or res[1] is None:
            yield from _fail_wait(client)
            continue
        old = int(res[0])
        if old not in (0, sv):
            continue                  # slot raced away: re-read the leaf
        if r > 1:
            bres = yield Phase(
                [Verb("write", region=region, replica=i,
                      off=entry_off(leaf_id, j), words=[sv])
                 for i in range(1, r)], label="ord:claim_backups")
            if any(x is None for x in bres):
                yield from _fail_wait(client)
                continue
        if meta_ver(int(res[1][0])) != lf["ver"]:
            # a split linked concurrently: our claim may sit outside the
            # new fence — undo (backups first) and retry against the
            # post-split chain
            yield from _clear_entry(client, region, leaf_id, j, sv)
            continue
        return OK
    return FULL


def _clear_entry(client, region: int, leaf_id: int, j: int, sv: int):
    """CAS one entry word back to 0, backups first, primary last."""
    r = _r(client, region)
    off = entry_off(leaf_id, j)
    if r > 1:
        yield Phase([Verb("cas", region=region, replica=i, off=off,
                          exp=sv, new=0) for i in range(1, r)],
                    label="ord:clear_backups")
    yield Phase([Verb("cas", region=region, replica=0, off=off,
                      exp=sv, new=0)], label="ord:clear_primary")


# ---------------------------------------------------------------- clear --
def ord_clear(client, key: int):
    """Ordered half of DELETE (after the RACE commit): clear the key's
    entry, then re-check the RACE index — a concurrent re-insert that
    committed gets its entry re-ensured (spurious entries are safe,
    missing entries are not)."""
    region = _region_of(client)
    if region is None or int(key) == MASK64:
        return OK
    sv = stored(key)
    leaf_id, lf = yield from _locate(client, key)
    if leaf_id is not None:
        for j, e in enumerate(lf["entries"]):
            if e == sv:
                yield from _clear_entry(client, region, leaf_id, j, sv)
    # RACE re-check: is the key live again (racing re-insert committed)?
    out = yield from client._read_index_for(key, [])
    buckets, base_offs, _ = out
    if buckets is None:
        return OK                     # degraded: repair converges later
    cands = client._locate(key, buckets, base_offs)
    _off, _sv, obj, _stale = yield from client._verify_candidates(key, cands)
    if obj is not None:
        yield from ord_ensure(client, key)
    return OK


# ---------------------------------------------------------------- split --
def _split(client, region: int, leaf_id: int, lf: Dict):
    """Split a full leaf (see module docstring).  Returns OK (split done
    or lost to a racer — either way the caller re-locates) or FULL."""
    # fullness is often transient under pile-ups (a racing winner's
    # clears in flight): re-read before allocating anything, so losers
    # back off instead of minting a leaf id they will leak on the link CAS
    lf2 = yield from _read_leaf(client, region, leaf_id)
    if lf2 is None or not lf2["valid"]:
        return OK
    if lf2["meta"] != lf["meta"] or any(e == 0 for e in lf2["entries"]):
        yield Phase([], label="ord:split_backoff")
        return OK
    lf = lf2
    ent = [e for e in lf["entries"] if e != 0]
    raws = sorted(unstored(e) for e in ent)
    # median must exceed low so the old leaf keeps at least its fence key
    med_cands = [k for k in raws[len(raws) // 2:] if k > lf["low"]]
    if not med_cands:
        return FULL                   # all entries at the fence: can't split
    median = med_cands[0]
    r = _r(client, region)
    if lf["next"] != 0:
        # a racing split at this median may already be linked (its clears
        # of the old leaf still in flight make the leaf look full): if the
        # successor already covers the median, don't split again — retry
        # and let the racer's clears land.  Without this guard, concurrent
        # splitters mint duplicate-range leaves for every pile-up.
        nxt = yield from _read_leaf(client, region, lf["next"])
        if nxt is not None and nxt["valid"] and nxt["low"] <= median:
            yield Phase([], label="ord:split_backoff")
            return OK
    movers = [e for e in ent if unstored(e) >= median]
    # allocate a leaf id: FAA the cursor on every replica (FAA commutes,
    # so replicas converge regardless of interleaving); primary's old
    # value is the claimed id
    res = yield Phase([Verb("faa", region=region, replica=i,
                            off=CURSOR_OFF, delta=1) for i in range(r)],
                      label="ord:alloc_leaf")
    if res[0] is None:
        yield from _fail_wait(client)
        return OK
    new_id = int(res[0])
    if new_id >= max_leaves(client.cfg.region_words):
        return FULL
    # write the (unreachable) new leaf everywhere; its (low, prev, crc)
    # header is the split's embedded log record
    words = build_leaf(low=median, ver=0, next_id=lf["next"], prev=leaf_id,
                       entries=movers)
    wres = yield Phase([Verb("write", region=region, replica=i,
                             off=leaf_off(new_id), words=words)
                        for i in range(r)], label="ord:write_leaf")
    if any(x is None for x in wres):
        yield from _fail_wait(client)
        return OK                     # unlinked leaf leaks; repair reaps it
    # link: CAS the old leaf's meta word on the primary (unique winner,
    # version bump), then broadcast to backups
    new_meta = pack_meta(lf["ver"] + 1, new_id,
                         leaf_crc(lf["low"], lf["prev"]))
    cres = yield Phase([Verb("cas", region=region, replica=0,
                             off=leaf_off(leaf_id) + 1,
                             exp=lf["meta"], new=new_meta)],
                       label="ord:link")
    if cres[0] is None:
        yield from _fail_wait(client)
        return OK
    if int(cres[0]) != lf["meta"]:
        return OK                     # lost the split race; leaf leaks
    if r > 1:
        yield Phase([Verb("write", region=region, replica=i,
                          off=leaf_off(leaf_id) + 1, words=[new_meta])
                     for i in range(1, r)], label="ord:link_backups")
    # post-link second pass: claims that raced the first read are now
    # stragglers (their guard read saw the old version only if our
    # re-read here sees their entry — see ord_ensure)
    res = yield Phase([_read_leaf_verb(region, leaf_id)],
                      label="ord:post_link_read")
    mover_set = set(movers)
    stragglers = []
    if res[0] is not None:
        lf2 = parse_leaf(res[0])
        stragglers = [e for e in lf2["entries"]
                      if e != 0 and unstored(e) >= median
                      and e not in mover_set]
    # a straggler may only be cleared from the old leaf once it is
    # CONFIRMED fully replicated in the new leaf — its owner acked
    # relying on this move, so a failed move (bounced read, full new
    # leaf, lost slot CAS, incomplete backups) must leave the entry where
    # it is (repair re-homes it later); clearing anyway would make a
    # committed key scan-invisible with no fault in the system
    moved: set = set()
    if stragglers:
        nres = yield Phase([_read_leaf_verb(region, new_id)],
                           label="ord:read_new")
        if nres[0] is not None:
            nlf = parse_leaf(nres[0])
            free = [j for j, e in enumerate(nlf["entries"]) if e == 0]
            have = set(nlf["entries"])
            for sv in stragglers:
                if sv in have:
                    moved.add(sv)
                    continue
                if not free:
                    continue          # full new leaf: repair re-homes later
                j = free.pop(0)
                cres2 = yield Phase(
                    [Verb("cas", region=region, replica=0,
                          off=entry_off(new_id, j), exp=0, new=sv)],
                    label="ord:move_claim")
                if cres2[0] is None or int(cres2[0]) not in (0, sv):
                    continue          # bounced / lost the slot: not moved
                if r > 1:
                    bres2 = yield Phase(
                        [Verb("write", region=region, replica=i,
                              off=entry_off(new_id, j), words=[sv])
                         for i in range(1, r)], label="ord:move_backups")
                    if any(x is None for x in bres2):
                        continue      # backups incomplete: not moved
                moved.add(sv)
    # clear movers (written to the new leaf pre-link) + confirmed-moved
    # stragglers from the old leaf (backups first)
    clear_set = mover_set | moved
    old_now = (parse_leaf(res[0])["entries"] if res[0] is not None
               else lf["entries"])
    to_clear = [(j, e) for j, e in enumerate(old_now) if e in clear_set]
    if to_clear:
        if r > 1:
            yield Phase([Verb("cas", region=region, replica=i,
                              off=entry_off(leaf_id, j), exp=e, new=0)
                         for (j, e) in to_clear for i in range(1, r)],
                        label="ord:split_clear_backups")
        yield Phase([Verb("cas", region=region, replica=0,
                          off=entry_off(leaf_id, j), exp=e, new=0)
                     for (j, e) in to_clear], label="ord:split_clear")
    client.ord_fences[new_id] = median
    return OK


# ----------------------------------------------------------------- scan --
def op_scan(client, start: int, count: int, *, hint: int = -1,
            batched: bool = True):
    """SCAN(start_key, count): the next ``count`` live keys >= start, in
    key order, with their values.  Returns ``OpResult(OK, value=[(key,
    value_words), ...])``."""
    return (yield from _scan(client, start, count=count, end=None,
                             hint=hint, batched=batched))


def op_range(client, start: int, end: int, *, hint: int = -1,
             batched: bool = True):
    """RANGE(start, end): every live key in ``[start, end)`` with its
    value, in key order."""
    return (yield from _scan(client, start, count=None, end=end,
                             hint=hint, batched=batched))


def _scan(client, start: int, *, count: Optional[int], end: Optional[int],
          hint: int = -1, batched: bool = True):
    region = _region_of(client)
    if region is None:
        return OpResult(NOT_FOUND)
    if end is not None and end <= start:
        return OpResult(OK, value=[])
    hi = MASK64 if end is None else int(end) - 1
    results: List[Tuple[int, list]] = []
    seen: set = set()
    leaf_id, lf = yield from _locate(client, int(start), hint=hint)
    if leaf_id is None:
        return OpResult(NOT_FOUND)
    exhausted = False
    for _round in range(MAX_ORD_RETRIES):
        # ---- traverse: collect candidate keys from the leaf chain ------
        want = (ORD_VBATCH if count is None
                else max(count - len(results), 1) + 8)
        cands: List[int] = []
        while lf is not None and len(cands) < want:
            for e in lf["entries"]:
                if e == 0:
                    continue
                k = unstored(e)
                if k >= start and k <= hi and k not in seen:
                    cands.append(k)
            if lf["low"] > hi:
                exhausted = True
                break
            nxt_id = lf["next"]
            if nxt_id == 0:
                exhausted = True
                break
            if batched:
                # speculative multi-leaf sweep: the next chain segment
                # predicted from the fence cache, one doorbell batch
                ids = _predict_chain(client, nxt_id, ORD_SWEEP)
                res = yield Phase([_read_leaf_verb(region, i) for i in ids],
                                  label="ord:scan_sweep")
                chain: Dict[int, Dict] = {}
                for i, raw in zip(ids, res):
                    if raw is not None:
                        p = parse_leaf(raw)
                        if p["valid"]:
                            chain[i] = p
                            client.ord_fences[i] = p["low"]
                if nxt_id not in chain:
                    lf = yield from _read_leaf(client, region, nxt_id)
                    if lf is not None and lf["valid"]:
                        client.ord_fences[nxt_id] = lf["low"]
                    leaf_id = nxt_id
                    continue
                # walk the fetched segment in chain order
                cur = nxt_id
                while cur in chain and len(cands) < want:
                    lf = chain[cur]
                    leaf_id = cur
                    for e in lf["entries"]:
                        if e == 0:
                            continue
                        k = unstored(e)
                        if k >= start and k <= hi and k not in seen:
                            cands.append(k)
                    if lf["low"] > hi or lf["next"] == 0:
                        exhausted = lf["low"] > hi or lf["next"] == 0
                        lf = None
                        break
                    cur = lf["next"]
                else:
                    if cur not in chain and lf is not None:
                        lf = yield from _read_leaf(client, region, cur)
                        leaf_id = cur
            else:
                # naive per-slot traversal: one leaf per RTT
                lf = yield from _read_leaf(client, region, nxt_id)
                leaf_id = nxt_id
        # ---- validate + fetch values through the RACE index ------------
        cands = sorted(set(cands))
        if batched:
            fetched = yield from _fetch_values(client, cands)
        else:
            fetched = []
            for k in cands:
                r1 = yield from client._read_index_for(k, [])
                buckets, base_offs, _ = r1
                if buckets is None:
                    continue
                cs = client._locate(k, buckets, base_offs)
                _o, _s, obj, _st = yield from client._verify_candidates(k, cs)
                if obj is not None:
                    fetched.append((k, obj["value"]))
        for k, v in fetched:
            if k not in seen:
                seen.add(k)
                results.append((k, v))
        if count is not None and len(results) >= count:
            results = sorted(results)[:count]
            break
        if exhausted or lf is None:
            break     # end of chain, or a mid-chain read failed terminally
    return OpResult(OK, value=sorted(results))


def _predict_chain(client, head: int, n: int) -> List[int]:
    """Next ``n`` leaf ids after (and including) ``head`` in fence order —
    the speculative sweep set.  Mispredictions (fresh splits) are healed
    by the per-leaf chain walk that follows the read."""
    fences = client.ord_fences
    if head not in fences:
        return [head]
    by_low = sorted((low, lid) for lid, low in fences.items())
    pos = by_low.index((fences[head], head))
    return [lid for (_low, lid) in by_low[pos:pos + n]]


def _fetch_values(client, keys: List[int]):
    """Batched value fetch + liveness validation for scan candidates: one
    phase reads both RACE buckets of every key (one doorbell batch), one
    phase reads every fp-matching object; keys whose object fails the
    (key, used, !invalid, crc) check are dropped (stale ordered entries —
    deleted or never-committed keys)."""
    out: List[Tuple[int, list]] = []
    for s in range(0, len(keys), ORD_VBATCH):
        chunk = keys[s:s + ORD_VBATCH]
        retry = chunk
        for _attempt in range(4):
            if not retry:
                break
            verbs, spans = [], []
            for k in retry:
                region = client._index_region(k)
                b1, b2 = race.bucket_pair(k, client.cfg.index_buckets)
                spans.append((k, region, len(verbs)))
                verbs.append(Verb("read", region=region, replica=0,
                                  off=race.bucket_off(
                                      b1, client.cfg.slots_per_bucket),
                                  n=client.cfg.slots_per_bucket))
                verbs.append(Verb("read", region=region, replica=0,
                                  off=race.bucket_off(
                                      b2, client.cfg.slots_per_bucket),
                                  n=client.cfg.slots_per_bucket))
            bres = yield Phase(verbs, label="ord:val_buckets")
            obj_verbs, obj_map = [], []
            bounced = []
            for (k, region, vi) in spans:
                if bres[vi] is None or bres[vi + 1] is None:
                    bounced.append(k)
                    continue
                fp = L.fingerprint(k)
                cands = race.find_matches(list(bres[vi]), 0, fp) \
                    + race.find_matches(list(bres[vi + 1]), 0, fp)
                for (_off, sv) in cands:
                    obj_map.append(k)
                    obj_verbs.append(Verb(
                        "read", region=L.ptr_region(L.slot_ptr(sv)),
                        replica=0, off=L.ptr_offset(L.slot_ptr(sv)),
                        n=L.size_class_words(L.slot_size_class(sv))))
            if obj_verbs:
                ores = yield Phase(obj_verbs, label="ord:val_objects")
                got = set()
                for k, raw in zip(obj_map, ores):
                    if raw is None or k in got:
                        continue
                    obj = L.parse_object(list(raw))
                    if (obj["key"] == k and obj["used"]
                            and not obj["invalid"] and obj["crc_ok"]):
                        got.add(k)
                        out.append((k, obj["value"]))
            if bounced:
                yield from _fail_wait(client)
            retry = bounced
    return out


# ====================================================== master-side repair
class _HostCopies:
    """One host copy (uint64) of every alive replica of a keydir region.
    The master-side helpers run the reference's word-level code on
    ``arrays`` — ``(replica, array)`` pairs — and ``flush`` writes back
    only the words that changed, one device copy per replica."""

    def __init__(self, pool, region: int):
        reps = pool.placement.get(region, [])
        self.views: List[torch.Tensor] = []
        self.arrays: List[Tuple[int, np.ndarray]] = []
        for i, r in enumerate(reps):
            mn = pool.mns[r]
            if mn.alive and region in mn.regions:
                self.views.append(mn.regions[region])
                self.arrays.append((i, to_u64(mn.regions[region])))
        self._orig = [a.copy() for (_i, a) in self.arrays]

    def flush(self):
        for view, (_i, a), orig in zip(self.views, self.arrays, self._orig):
            idx = np.nonzero(a != orig)[0]
            if idx.size:
                view[torch.from_numpy(idx).to(view.device)] = \
                    torch.from_numpy(a[idx].view(np.int64)).to(view.device)


def _reachable(leaves: Dict[int, Dict]) -> List[int]:
    """Leaf ids reachable from the chain head via valid next pointers —
    the only leaves scans can see (written-but-unlinked half-splits and
    reaped leaves are excluded even when their stale parse looks valid)."""
    reach, cur, seen = [], 0, set()
    while cur in leaves and leaves[cur]["valid"] and cur not in seen:
        seen.add(cur)
        reach.append(cur)
        cur = leaves[cur]["next"]
        if cur == 0:
            break
    return reach


def _chain_windows(leaves: Dict[int, Dict], reach) -> Tuple[List[int], Dict]:
    """Low-sorted reachable leaves and each leaf's fence window high: the
    next *strictly greater* low in the chain.  Racing splits can mint
    duplicate-low leaves (legal: scans sweep both and dedupe), so
    same-low leaves share one window — a zero-width window would strand
    their entries."""
    order = sorted(reach, key=lambda i: (leaves[i]["low"], i))
    lows = [leaves[i]["low"] for i in order]
    highs: Dict[int, int] = {}
    nxt = MASK64 + 1
    for pos in range(len(order) - 1, -1, -1):
        highs[order[pos]] = nxt
        if pos and lows[pos] > lows[pos - 1]:
            nxt = lows[pos]
    return order, highs


def repair_ordered(pool):
    """Alg-3 for the ordered keydir, run by MN recovery, the migration
    cutover, and §5.3 client recovery (all execute atomically at a tick):

    1. word-wise adopt-backup: where alive replicas disagree, adopt an
       alive *backup* value (entry claims broadcast to backups before the
       op acks, and clears hit backups first, so backups are never older
       than the primary for acknowledged mutations);
    2. reap half-splits: a valid-header leaf unreachable from the chain
       was written but never linked (its embedded (low, prev, crc) split
       record committed, the link CAS did not) — discard it; its movers
       still live in the source leaf, which only clears them post-link;
    3. re-home stragglers: entries stranded outside their leaf's fence
       window (a splitter crashed mid-move) are moved to their covering
       leaf so scans — which sweep only fence-relevant leaves — see them.
    """
    for region in getattr(pool, "ordered_regions", []):
        host = _HostCopies(pool, region)
        _repair_region(pool, region, host.arrays)
        host.flush()


def _repair_region(pool, region: int, arrays):
    """``repair_ordered`` on one region's host copies."""
    if arrays:
        # ---- 1. adopt-backup convergence (vectorized) -------------------
        if len(arrays) > 1:
            stack = np.stack([a for (_i, a) in arrays])
            diff = np.nonzero((stack != stack[0]).any(axis=0))[0]
            backups = [a for (i, a) in arrays if i > 0]
            chosen_src = backups[0] if backups else arrays[0][1]
            vals = chosen_src[diff].copy()
            for (_i, a) in arrays:
                a[diff] = vals
        mem = arrays[0][1]
        n_leaves = min(int(mem[CURSOR_OFF]),
                       max_leaves(pool.cfg.region_words))
        leaves = {i: parse_leaf(
            mem[leaf_off(i):leaf_off(i) + LEAF_WORDS])
            for i in range(n_leaves)}
        # ---- 2. reap unreachable (half-split) leaves, SALVAGING their
        # entries: an unreachable leaf is usually a never-linked loser
        # (entries are mover copies still in the source leaf — the
        # present-check dedups them), but it can also hold independent
        # claims acked through a primary-only link that adopt-backup just
        # reverted, or a promoted-backup's view after a primary crash —
        # those acked keys must be re-homed, never dropped
        reach = set(_reachable(leaves))
        moves: List[int] = []
        for i, lf in leaves.items():
            if i not in reach and lf["valid"]:
                moves.extend(unstored(e) for e in lf["entries"] if e != 0)
                for (_r, a) in arrays:
                    a[leaf_off(i) + 1] = np.uint64(0)   # void the header
        # ---- 3. re-home stranded entries --------------------------------
        order, highs = _chain_windows(leaves, reach)
        for i in order:
            lf = leaves[i]
            for j, e in enumerate(lf["entries"]):
                if e == 0:
                    continue
                k = unstored(e)
                if lf["low"] <= k < highs[i]:
                    continue
                for (_r, a) in arrays:
                    a[entry_off(i, j)] = np.uint64(0)
                moves.append(k)
        for k in moves:
            # windows recomputed per placement: a _place_direct may have
            # split a full covering leaf, shifting every later fence
            order, highs = _chain_windows(leaves, _reachable(leaves))
            _place_direct(pool, region, arrays, leaves, order, highs, k)


def _place_direct(pool, region, arrays, leaves, order, highs, key: int):
    """Master-side direct placement of one key into its covering reachable
    leaf (atomic-at-a-tick recovery write, all alive replicas).  When
    every covering leaf is full, the master splits one directly — a
    recovered key must never stay scan-invisible."""
    sv = stored(key)
    covering = [i for i in order
                if leaves[i]["low"] <= key < highs[i]]
    for i in covering:
        ent = leaves[i]["entries"]
        if sv in ent:
            return True
    for i in covering:
        ent = leaves[i]["entries"]
        for j, e in enumerate(ent):
            if e == 0:
                for (_r, a) in arrays:
                    a[entry_off(i, j)] = np.uint64(sv)
                ent[j] = sv
                return True
    if covering and _split_direct(pool, region, arrays, leaves, covering[-1]):
        # retry against the re-parsed post-split chain — REACHABLE leaves
        # only (the stale dict still carries reaped half-splits whose
        # fence windows would otherwise swallow the key invisibly)
        order2, highs2 = _chain_windows(leaves, _reachable(leaves))
        return _place_direct(pool, region, arrays, leaves, order2, highs2,
                             key)
    return False


def _split_direct(pool, region, arrays, leaves, leaf_id: int) -> bool:
    """Master-side leaf split (atomic at a tick): allocate a fresh leaf,
    move the upper half, link.  Updates ``leaves`` in place."""
    lf = leaves[leaf_id]
    raws = sorted(unstored(e) for e in lf["entries"] if e != 0)
    cands = [k for k in raws[len(raws) // 2:] if k > lf["low"]]
    if not cands:
        return False
    median = cands[0]
    mem = arrays[0][1]
    new_id = int(mem[CURSOR_OFF])
    if new_id >= max_leaves(pool.cfg.region_words):
        return False
    movers = [e for e in lf["entries"] if e != 0 and unstored(e) >= median]
    new_words = build_leaf(low=median, ver=0, next_id=lf["next"],
                           prev=leaf_id, entries=movers)
    new_meta = pack_meta(lf["ver"] + 1, new_id,
                         leaf_crc(lf["low"], lf["prev"]))
    for (_r, a) in arrays:
        a[CURSOR_OFF] = np.uint64(new_id + 1)
        a[leaf_off(new_id):leaf_off(new_id) + LEAF_WORDS] = np.array(
            [w & MASK64 for w in new_words], np.uint64)
        a[leaf_off(leaf_id) + 1] = np.uint64(new_meta)
        for j, e in enumerate(lf["entries"]):
            if e in movers:
                a[entry_off(leaf_id, j)] = np.uint64(0)
    leaves[leaf_id] = parse_leaf(mem[leaf_off(leaf_id):
                                     leaf_off(leaf_id) + LEAF_WORDS])
    leaves[new_id] = parse_leaf(mem[leaf_off(new_id):
                                    leaf_off(new_id) + LEAF_WORDS])
    return True


def ensure_entry_direct(pool, key: int):
    """Master-side: make ``key``'s ordered entry present (recovery of a
    crashed client whose RACE write was redone/completed — §5.3 must
    restore scan visibility of the recovered key)."""
    regs = getattr(pool, "ordered_regions", [])
    if not regs or int(key) == MASK64:
        return
    region = regs[0]
    host = _HostCopies(pool, region)
    arrays = host.arrays
    if not arrays:
        return
    mem = arrays[0][1]
    n_leaves = min(int(mem[CURSOR_OFF]), max_leaves(pool.cfg.region_words))
    leaves = {i: parse_leaf(mem[leaf_off(i):leaf_off(i) + LEAF_WORDS])
              for i in range(n_leaves)}
    order, highs = _chain_windows(leaves, _reachable(leaves))
    _place_direct(pool, region, arrays, leaves, order, highs, int(key))
    host.flush()


def ordered_keys_direct(pool) -> List[int]:
    """Whitebox view (tests): every key currently in the ordered keydir,
    sorted, read straight from the primary arrays."""
    regs = getattr(pool, "ordered_regions", [])
    if not regs:
        return []
    region = regs[0]
    prim = next((pool.mns[r].regions[region]
                 for r in pool.placement.get(region, [])
                 if pool.mns[r].alive and region in pool.mns[r].regions),
                None)
    if prim is None:
        return []
    mem = to_u64(prim)
    n_leaves = min(int(mem[CURSOR_OFF]), max_leaves(pool.cfg.region_words))
    out = set()
    cur, hops = 0, 0
    while cur < n_leaves and hops <= n_leaves:
        lf = parse_leaf(mem[leaf_off(cur):leaf_off(cur) + LEAF_WORDS])
        if not lf["valid"]:
            break
        for e in lf["entries"]:
            if e != 0:
                out.add(unstored(e))
        cur, hops = lf["next"], hops + 1
        if cur == 0:
            break
    return sorted(out)
