"""Post-drain DM heap / placement-epoch auditor.

``audit(cluster)`` walks the *quiescent* state of a ``FuseeCluster`` (call
it after ``drain()``) and cross-checks the four ownership surfaces of the
disaggregated heap against each other:

* the **RACE index shards** — every nonzero slot must point at a parseable,
  CRC-valid, used, non-invalidated object whose fingerprint and shard
  routing match the slot; no two slots may share a pointer or a key; a
  referenced object must not carry a set free bit (use-after-free);
* the **block allocation tables** (BAT) — owners must be 0 / a known cid+1
  / ``BAT_ORPHAN``, replicas must agree, and every allocated block must be
  *reachable*: owned by a live client that tracks it in its slab, or
  containing at least one index-referenced object (anything else is
  leaked garbage, reported);
* the **free surfaces** — per-block free bitmaps (bits only at offsets the
  block's size class can carve — a misaligned bit is the double-free FAA
  overflow signature) and the in-process slab free lists;
* the **placement ring** — live clients hold the pool lease epoch, no
  migration is still open, membership contains only live non-retired MNs,
  every placement replica is alive and hosts its region, retired MNs host
  nothing.

The leak rule, per object carved from a live client's block::

    used && !free_bit && !slot_referenced && !in_owner_free_list  ->  leak

(losers reset ``used``; overwritten objects get their free bit FAAed; a
reachable committed object is slot-referenced; everything else must be on
the owner's reclaim path).

Findings are split into ``errors`` (invariant violations — a protocol or
harness bug) and ``warnings`` (legal-but-lossy states: orphaned garbage
blocks surrendered by removed clients, keydir entries dropped under ORD
FULL back-pressure, blocks stranded by unrecovered client crashes).
Crashed-but-unrecovered clients are skipped (their heap state is
*supposed* to dangle until §5.3 recovery) and counted in ``stats``.

Runs that experienced **client crashes** audit in *lenient* mode: leaks
and index-replica divergence demote to warnings there, because both are
documented §5.3 residue rather than bugs — recovery repairs only the
at-most-one in-flight *tail* log entry per size-class list (a pipelined
client that crashed with several in-flight ops legally strands the
non-tail objects), and a crash between a round's backup and primary
CASes leaves backup divergence that the next round on the slot, Alg-3,
or a migration cutover repairs lazily.  A crash-free run holds the
strict line: any leak or divergence is an error.

Counterpart of the JAX package's ``analysis/heapcheck.py``, check for check,
keydir included.  The port's regions are int64 torch tensors, on the card
when the cluster is: the audit reads each region replica it needs with one
host copy (``heap.to_u64``, the master's idiom, taken at first use and
kept for the audit) and walks the unsigned words on the host — never word
by word across the bus.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

import numpy as np

from ..core import layout as L
from ..core import ordered
from ..core.heap import BAT_ORPHAN, to_u64

__all__ = ["HeapReport", "audit"]


@dataclass
class HeapReport:
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    stats: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.errors

    def __str__(self) -> str:
        lines = [f"heap audit: {'clean' if self.ok else 'FAILED'} "
                 f"({len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s))"]
        lines += [f"  ERROR: {e}" for e in self.errors]
        lines += [f"  warn:  {w}" for w in self.warnings]
        lines.append("  stats: " + ", ".join(
            f"{k}={v}" for k, v in sorted(self.stats.items())))
        return "\n".join(lines)


class _HostPool:
    """The pool as the audit reads it: every attribute of ``pool``, and
    ``words(mid, region)``, one host copy (unsigned words) of an MN's
    region, copied at first use and kept for the rest of the audit."""

    def __init__(self, pool):
        self._pool = pool
        self._copies: Dict[Tuple[int, int], np.ndarray] = {}

    def __getattr__(self, name):
        return getattr(self._pool, name)

    def words(self, mid: int, region: int) -> np.ndarray:
        key = (mid, region)
        if key not in self._copies:
            self._copies[key] = to_u64(self._pool.mns[mid].regions[region])
        return self._copies[key]


def _primary_mem(pool, region):
    """First alive replica array hosting ``region`` (master idiom)."""
    for mid in pool.placement.get(region, []):
        mn = pool.mns[mid]
        if mn.alive and region in mn.regions:
            return pool.words(mid, region)
    return None


def _alive_arrays(pool, region):
    out = []
    for i, mid in enumerate(pool.placement.get(region, [])):
        mn = pool.mns[mid]
        if mn.alive and region in mn.regions:
            out.append((i, mid, pool.words(mid, region)))
    return out


def audit(cluster) -> HeapReport:
    """Audit a quiescent cluster; see module docstring."""
    rep = HeapReport()
    pool = _HostPool(cluster.pool)
    cfg = pool.cfg
    clients = cluster.clients
    live = {cid: c for cid, c in clients.items() if not c.crashed}
    crashed = {cid for cid, c in clients.items() if c.crashed}
    rep.stats["clients_live"] = len(live)
    rep.stats["clients_crashed_skipped"] = len(crashed)
    # lenient mode: the run saw client crashes, so §5.3 residue (stranded
    # non-tail objects, mid-round backup divergence) is expected — see
    # module docstring
    lenient = bool(crashed) or cluster.client_recoveries > 0 \
        or cluster.scheduler.crashed_ops > 0
    rep.stats["lenient"] = int(lenient)
    tracer = getattr(pool, "_tracer", None)
    if tracer is not None:
        # the heap audit itself reads pool state, not the trace — but a
        # wrapped ring means any race/trace analysis paired with this
        # audit ran on a truncated window, so surface it here too
        rep.stats["trace_dropped"] = tracer.dropped
        if tracer.dropped:
            rep.warnings.append(
                f"verb-trace ring wrapped: {tracer.dropped} oldest "
                f"record(s) dropped (capacity {tracer.capacity}) — "
                "trace-based analyses cover a truncated window")

    _audit_ring(rep, pool, live)
    refs = _audit_index(rep, pool, lenient)
    _audit_bats(rep, pool, live, refs)
    _audit_blocks(rep, pool, live, refs, lenient)
    if cfg.ordered_index:
        _audit_keydir(rep, pool, live, crashed, refs, lenient)
    return rep


# ------------------------------------------------------------ placement ring
def _audit_ring(rep: HeapReport, pool, live):
    for cid, c in sorted(live.items()):
        if c.epoch != pool.epoch:
            rep.errors.append(
                f"epoch: live client {cid} holds lease epoch {c.epoch} "
                f"but pool epoch is {pool.epoch} (membership commit "
                "did not propagate)")
    if pool.migrations:
        rep.errors.append(
            f"epoch: {len(pool.migrations)} migration dual-write window(s) "
            f"still open for regions {sorted(pool.migrations)} — the "
            "cluster is not quiescent")
    for mid in pool.directory.members:
        mn = pool.mns[mid]
        if not mn.alive or mn.retired:
            rep.errors.append(
                f"ring: MN {mid} is in the committed membership but "
                f"{'retired' if mn.retired else 'dead'} — crash undetected "
                "or retirement incomplete")
    for mn in pool.mns:
        if mn.retired and mn.regions:
            rep.errors.append(
                f"ring: retired MN {mn.mid} still hosts regions "
                f"{sorted(mn.regions)}")
    for region, reps in sorted(pool.placement.items()):
        if not reps:
            rep.errors.append(f"ring: region {region} has an empty "
                              "replica set")
            continue
        if len(set(reps)) != len(reps):
            rep.errors.append(
                f"ring: region {region} lists a duplicate replica: {reps}")
        for mid in reps:
            mn = pool.mns[mid]
            if not mn.alive:
                rep.errors.append(
                    f"ring: region {region} placed on dead MN {mid} "
                    "(Alg-3 re-home missing)")
            elif region not in mn.regions:
                rep.errors.append(
                    f"ring: region {region} placed on MN {mid} which does "
                    "not host a copy")


# ------------------------------------------------------------ index shards
@dataclass
class _Ref:
    """One nonzero index slot and the object it claims."""
    shard: int
    slot_off: int
    fp: int
    sc: int
    ptr: int
    key: int = -1          # parsed object key (-1 = unparseable)


def _audit_index(rep: HeapReport, pool, lenient: bool = False
                 ) -> List[_Ref]:
    cfg = pool.cfg
    refs: List[_Ref] = []
    by_ptr: Dict[int, Tuple[int, int]] = {}
    by_key: Dict[int, Tuple[int, int]] = {}
    data_region_set = set(pool.data_regions)
    for g in pool.index_regions:
        arrays = _alive_arrays(pool, g)
        if not arrays:
            rep.errors.append(f"index: shard region {g} has no alive "
                              "replica")
            continue
        n = cfg.index_words
        base = arrays[0][2][:n]
        for _, mid, arr in arrays[1:]:
            if not np.array_equal(arr[:n], base):
                diff = int(np.nonzero(arr[:n] != base)[0][0])
                # a client crash between a round's backup and primary
                # CASes legally strands backup divergence (repaired by
                # the next round / Alg-3 / cutover) — lenient demotes
                sink = rep.warnings if lenient else rep.errors
                sink.append(
                    f"index: shard {g} replicas diverge at slot word "
                    f"{diff} (MN {arrays[0][1]} vs MN {mid}) after drain — "
                    + ("mid-round crash residue" if lenient else
                       "an uncommitted SNAPSHOT round survived"))
        for off in np.nonzero(base)[0]:
            slot = int(base[int(off)])
            r = _Ref(shard=g, slot_off=int(off), fp=L.slot_fp(slot),
                     sc=L.slot_size_class(slot), ptr=L.slot_ptr(slot))
            refs.append(r)
            dup = by_ptr.get(r.ptr)
            if dup is not None:
                rep.errors.append(
                    f"index: pointer {r.ptr:#x} referenced by two slots: "
                    f"shard {dup[0]} word {dup[1]} and shard {g} word "
                    f"{r.slot_off} (double reference)")
            else:
                by_ptr[r.ptr] = (g, r.slot_off)
            _check_ref_object(rep, pool, r, data_region_set)
            if r.key >= 0:
                dupk = by_key.get(r.key)
                if dupk is not None:
                    rep.errors.append(
                        f"index: key {r.key:#x} present in two slots: "
                        f"shard {dupk[0]} word {dupk[1]} and shard {g} "
                        f"word {r.slot_off}")
                else:
                    by_key[r.key] = (g, r.slot_off)
    rep.stats["index_slots_used"] = len(refs)
    return refs


def _check_ref_object(rep: HeapReport, pool, r: _Ref, data_region_set):
    cfg = pool.cfg
    region, off = L.ptr_region(r.ptr), L.ptr_offset(r.ptr)
    where = f"shard {r.shard} word {r.slot_off} -> ptr {r.ptr:#x}"
    if region not in data_region_set:
        rep.errors.append(f"index: {where} points outside the data "
                          f"regions (region {region})")
        return
    blk = (off - cfg.bat_words) // cfg.block_words
    base = pool.block_base(blk)
    scw = L.size_class_words(r.sc)
    if not (0 <= blk < cfg.blocks_per_region) or off < base \
            or (off - base) % L.MIN_OBJ_WORDS != 0 \
            or off + scw > pool.block_base(blk) + cfg.block_payload_words:
        rep.errors.append(f"index: {where} is not a carvable object "
                          f"offset (block {blk}, sc {r.sc})")
        return
    mem = _primary_mem(pool, region)
    if mem is None:
        rep.errors.append(f"index: {where} targets region {region} with "
                          "no alive replica")
        return
    if int(mem[blk]) == 0:       # BAT word of this block
        rep.errors.append(f"index: {where} lands in UNALLOCATED block "
                          f"{blk} of region {region} (dangling reference)")
        return
    obj_idx = (off - base) // L.MIN_OBJ_WORDS
    bm_word = int(mem[pool.bitmap_base(blk) + obj_idx // 64])
    if (bm_word >> (obj_idx % 64)) & 1:
        rep.errors.append(
            f"index: {where} references an object whose free bit is set "
            f"(region {region} block {blk} obj {obj_idx}) — use after free")
    o = L.parse_object(mem[off:off + scw])
    r.key = int(o["key"])
    if not o["crc_ok"]:
        rep.errors.append(f"index: {where} object fails CRC (torn or "
                          "mis-sized commit)")
    if not o["used"]:
        rep.errors.append(f"index: {where} object has used=0 (slot "
                          "survived a loser reset)")
    if o["invalid"]:
        rep.errors.append(f"index: {where} object is invalidated but "
                          "still referenced")
    if L.fingerprint(r.key) != r.fp:
        rep.errors.append(
            f"index: {where} fingerprint mismatch: slot fp {r.fp}, object "
            f"key {r.key:#x} -> fp {L.fingerprint(r.key)}")
    if pool.index_region_of(r.key) != r.shard:
        rep.errors.append(
            f"index: key {r.key:#x} stored in shard {r.shard} but routes "
            f"to shard {pool.index_region_of(r.key)} (mis-sharded slot)")


# --------------------------------------------------------------------- BAT
def _audit_bats(rep: HeapReport, pool, live, refs: List[_Ref]):
    cfg = pool.cfg
    max_owner = pool.num_clients       # owners are cid+1
    allocated = 0
    orphans = 0
    for region in pool.data_regions:
        arrays = _alive_arrays(pool, region)
        if not arrays:
            continue                   # flagged by the ring audit already
        n = cfg.bat_words
        base = arrays[0][2][:n]
        for _, mid, arr in arrays[1:]:
            if not np.array_equal(arr[:n], base):
                blk = int(np.nonzero(arr[:n] != base)[0][0])
                rep.errors.append(
                    f"bat: region {region} BAT diverges at block {blk} "
                    f"(MN {arrays[0][1]} vs MN {mid})")
        for blk in np.nonzero(base)[0]:
            owner = int(base[int(blk)])
            allocated += 1
            if owner == BAT_ORPHAN:
                orphans += 1
            elif not (1 <= owner <= max_owner):
                rep.errors.append(
                    f"bat: region {region} block {int(blk)} owned by "
                    f"unknown tag {owner:#x} (not 0 / cid+1 / ORPHAN)")
    rep.stats["blocks_allocated"] = allocated
    rep.stats["blocks_orphan"] = orphans


# -------------------------------------------------- block / object surfaces
def _audit_blocks(rep: HeapReport, pool, live, refs: List[_Ref],
                  lenient: bool = False):
    cfg = pool.cfg
    ref_ptrs: Set[int] = {r.ptr for r in refs}
    ref_blocks: Set[Tuple[int, int]] = {
        (L.ptr_region(r.ptr),
         (L.ptr_offset(r.ptr) - cfg.bat_words) // cfg.block_words)
        for r in refs}
    slab_blocks: Set[Tuple[int, int]] = set()
    objects_live = 0
    objects_freed = 0
    leaks = 0
    for cid, c in sorted(live.items()):
        for sc, st in sorted(c.slab.items()):
            scw = L.size_class_words(sc)
            stride = scw // L.MIN_OBJ_WORDS
            free_set = {int(p) for p in st.free}
            for (region, blk) in st.blocks:
                slab_blocks.add((region, blk))
                mem = _primary_mem(pool, region)
                if mem is None:
                    continue
                owner = int(mem[blk])
                if owner != cid + 1:
                    rep.warnings.append(
                        f"block: region {region} block {blk} is in client "
                        f"{cid}'s slab but BAT says owner tag {owner:#x} "
                        "(reassigned by recovery or disowned)")
                base = pool.block_base(blk)
                n_objs = cfg.block_payload_words // scw
                bm_off = pool.bitmap_base(blk)
                bm = [int(w) for w in
                      mem[bm_off:bm_off + cfg.bitmap_words]]
                for w_i, w in enumerate(bm):
                    while w:
                        bit = (w & -w).bit_length() - 1
                        w &= w - 1
                        if (w_i * 64 + bit) % stride != 0:
                            rep.errors.append(
                                f"block: region {region} block {blk} free "
                                f"bitmap bit {w_i * 64 + bit} is not on "
                                f"the sc-{sc} carve grid — double-free "
                                "FAA overflow")
                for i in range(n_objs):
                    off = base + i * scw
                    ptr = L.pack_ptr(region, off)
                    tail = int(mem[off + scw - 1])
                    used = bool(tail & L.USED_BIT)
                    obj_idx = (off - base) // L.MIN_OBJ_WORDS
                    freed = bool(bm[obj_idx // 64] >> (obj_idx % 64) & 1)
                    if used and not freed:
                        objects_live += 1
                    if freed:
                        objects_freed += 1
                    if used and not freed and ptr not in ref_ptrs \
                            and ptr not in free_set:
                        leaks += 1
                        # a client that crashed with a pipeline of in-flight
                        # ops strands the non-tail ones (§5.3 repairs only
                        # the tail log entry per list) — lenient demotes
                        sink = rep.warnings if lenient else rep.errors
                        sink.append(
                            f"leak: region {region} block {blk} word {off} "
                            f"(client {cid}, sc {sc}): used object with no "
                            "index reference, no free bit, and not on the "
                            "owner's free list — unreachable"
                            + (" (crashed-op residue)" if lenient else
                               " forever"))
    # reachability of allocated blocks that no live client's slab tracks
    for region in pool.data_regions:
        mem = _primary_mem(pool, region)
        if mem is None:
            continue
        for blk in np.nonzero(mem[:cfg.bat_words])[0]:
            blk = int(blk)
            if (region, blk) in slab_blocks or (region, blk) in ref_blocks:
                continue
            owner = int(mem[blk])
            who = "ORPHAN" if owner == BAT_ORPHAN else f"tag {owner:#x}"
            rep.warnings.append(
                f"block: region {region} block {blk} ({who}) is allocated "
                "but unreachable: no slab tracks it and no index slot "
                "references into it (garbage until reclaimed)")
    rep.stats["objects_live"] = objects_live
    rep.stats["objects_freed_pending"] = objects_freed
    rep.stats["leaks"] = leaks


# ------------------------------------------------------------------ keydir
def _audit_keydir(rep: HeapReport, pool, live, crashed, refs: List[_Ref],
                  lenient: bool = False):
    race_keys = {r.key for r in refs if r.key >= 0}
    ord_keys = set(ordered.ordered_keys_direct(pool))
    rep.stats["keydir_keys"] = len(ord_keys)
    # ORD FULL back-pressure and client crashes legally desync the keydir
    # from the RACE truth — demote to warnings in those runs
    drops = sum(c.ord_full_drops for c in live.values())
    lenient = lenient or drops > 0
    sink = rep.warnings if lenient else rep.errors
    why = (f" (lenient: {drops} ORD-FULL drop(s), "
           f"{len(crashed)} unrecovered crash(es))" if lenient else "")
    missing = sorted(race_keys - ord_keys)
    extra = sorted(ord_keys - race_keys)
    if missing:
        sink.append(
            f"keydir: {len(missing)} committed key(s) invisible to scans, "
            f"e.g. {missing[0]:#x}{why}")
    if extra:
        sink.append(
            f"keydir: {len(extra)} key(s) in the ordered keydir with no "
            f"RACE entry, e.g. {extra[0]:#x}{why}")
    for region in pool.ordered_regions:
        arrays = _alive_arrays(pool, region)
        if len(arrays) >= 2:
            base = arrays[0][2]
            for _, mid, arr in arrays[1:]:
                if not np.array_equal(arr, base):
                    diff = int(np.nonzero(arr != base)[0][0])
                    rep.warnings.append(
                        f"keydir: region {region} replicas diverge at word "
                        f"{diff} (MN {arrays[0][1]} vs MN {mid}) — "
                        "claim round not completed (repair_ordered due)")
                    break
