"""The FUSEE master (§5): a fault-tolerant cluster-management process.

The master is off every critical path; it only (1) initializes clients/MNs,
(2) recovers from MN crashes (Alg. 3 — representative-last-writer slot
repair + region re-homing), and (3) recovers crashed clients from their
embedded operation logs (§5.3: memory re-management + index repair).

Simplification vs. the paper (documented in DESIGN.md): the master itself is
assumed replicated/fault-tolerant (as in the paper) and its recovery
procedures execute atomically at one scheduler tick; client<->master RPCs are
charged `rpc_rtts` round trips by the network model.  The *client-side*
protocol under failures (Alg. 4) is fully interleaved and schedule-driven.

Counterpart of the JAX package's ``core/master.py``.  The master reads and
writes region copies directly; here those copies live on the pool's device,
so a procedure that scans many words takes one host snapshot of them
(``heap.to_u64``) and writes single words back (``heap.set_word``); the
ordered keydir's repair works the same way (core/ordered.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import layout as L
from . import ordered
from . import race
from .client import MASTER_COMMIT_MARK, FuseeClient
from .events import OK, OpResult
from .heap import (BAT_ORPHAN, INDEX_REGION, META_REGION,
                   META_WORDS_PER_CLIENT, DMPool, get_word, set_word, to_u64)

# TEST-ONLY protocol hole: skip the §5.3 replica convergence of a crashed
# client's log-entry object before its redo re-installs the index slot.
# A client that dies mid-write-phase can leave the KV object on a subset
# of its replicas (the crash drops the remaining QP lanes); without the
# convergence the redo publishes a slot whose object exists only on the
# replica the log was read from, and a later MN recovery that loses that
# replica adopts an all-zero copy — the storm seeds-8/15 heap-audit
# failure.  The `loser_reset` model-checker scope (`analysis/explore.py`,
# ROADMAP A12.3) and regression tests re-enable the hole to prove the
# minimized schedule still reproduces it.
UNSAFE_REDO_NO_CONVERGE = False


@dataclass
class RecoveryStats:
    reconnect_ms: float = 0.0
    get_metadata_rtts: int = 0
    traverse_log_rtts: int = 0
    recover_requests_rtts: int = 0
    construct_free_list_rtts: int = 0
    redone_ops: int = 0
    fixed_primaries: int = 0
    reclaimed_objects: int = 0
    used_objects: int = 0


class Master:
    def __init__(self, pool: DMPool, *, reconnect_ms: float = 163.1):
        self.pool = pool
        self.reconnect_ms = reconnect_ms
        self.handled_mn_crashes: set = set()
        self.clients: Dict[int, FuseeClient] = {}
        # migration engine (core/migrate.py), wired by the cluster surface;
        # the master arbitrates its cutovers and aborts it around Alg-3
        self.migrator = None

    def register(self, client: FuseeClient):
        self.clients[client.cid] = client

    def deregister(self, cid: int):
        """Drop a removed client from membership (lease surrendered); it no
        longer receives prepare/commit notifications on recovery epochs."""
        self.clients.pop(cid, None)

    def release_client(self, cid: int):
        """Graceful leave (§5.2 membership change): scrub the client's meta
        words and re-tag its BAT entries as master-managed orphans, so a
        later holder of a reused cid inherits neither stale size-class list
        heads nor the leaver's blocks (whose live objects remain reachable
        through the index)."""
        pool = self.pool
        base = cid * META_WORDS_PER_CLIENT
        for i in range(len(pool.placement[META_REGION])):
            pool.write(META_REGION, i, base, [0] * META_WORDS_PER_CLIENT)
        for g in pool.data_regions:
            for rep_mid in pool.placement[g]:
                mn = pool.mns[rep_mid]
                if not mn.alive or g not in mn.regions:
                    continue
                bat = mn.regions[g]
                mine = np.nonzero(
                    to_u64(bat[:pool.cfg.blocks_per_region]) == cid + 1)[0]
                for b in mine.tolist():
                    set_word(bat, b, BAT_ORPHAN)
        self._resync_migrations()

    # ------------------------------------------------------------------ MN
    def detect_dead_mns(self) -> List[int]:
        return [m.mid for m in self.pool.mns
                if not m.alive and not m.retired
                and m.mid not in self.handled_mn_crashes]

    def commit_membership(self):
        """Commit a membership change (§5.2): bump the lease epoch and
        propagate it to every live client.  In-flight verbs stamped with
        the old epoch FAIL at execution and their ops retry — the same
        guard MN recovery uses.  Called for MN joins/retires and by every
        migration cutover."""
        self.pool.epoch += 1
        for c in self.clients.values():
            if not c.crashed:
                c.epoch = self.pool.epoch
                c.notified_prepare = False

    def commit_cutover(self, mig):
        """Atomically commit a completed region migration (the epoch-bump
        CAS cutover, arbitrated here so it serializes with Alg-3).

        For index shards the cutover first runs the Alg-3 slot repair
        across the *current alive* replicas: a SNAPSHOT round that
        straddles the cutover has its backup-CAS evidence only in the old
        backup arrays, and that evidence must be converged into every
        replica (committing the round's log) before roles change — the
        exact invariant MN recovery relies on ("backups are never older
        than the primary"); discarding it would let a later repair revert
        an acknowledged primary CAS.  After the repair all alive replicas
        agree, so the staged targets (bulk copy + dual-write mirror of
        the primary, resynced with the repaired slots here) equal the
        retained replicas, which keep their arrays.

        Then: install targets, re-home the region in the pinned directory
        (per-shard version bump), drop the copies of MNs leaving the
        replica set, close the dual-write window, and commit the
        membership epoch — in-flight verbs stamped with the old epoch
        FAIL and their ops retry."""
        pool = self.pool
        if mig.region in pool.index_region_set:
            self._repair_index_region(mig.region)
            prim = pool.mns[pool.placement[mig.region][0]]
            if prim.alive and mig.region in prim.regions:
                n = pool.cfg.index_words
                src = prim.regions[mig.region][:n]
                for arr in mig.targets.values():
                    arr[:n] = src
        elif mig.region in pool.ordered_region_set:
            # the ordered keydir migrates like an index shard: converge
            # straddling claim/clear rounds (adopt-backup + structural
            # repair) before roles change, then resync the staged targets
            ordered.repair_ordered(pool)
            prim = pool.mns[pool.placement[mig.region][0]]
            if prim.alive and mig.region in prim.regions:
                src = prim.regions[mig.region]
                for arr in mig.targets.values():
                    arr.copy_(src)
        old_reps = list(pool.placement[mig.region])
        for mid, arr in mig.targets.items():
            # install by copy into a slab-backed cell (heap.RegionSlab):
            # the staged target is a detached staging buffer, but every
            # *hosted* copy must live in the pool's flat slab so the fused
            # tick can address it
            mn = pool.mns[mid]
            if mig.region not in mn.regions:
                mn.host_region(mig.region)
            mn.regions[mig.region].copy_(arr)
        pool.directory.rehome(mig.region, mig.new_reps)
        for mid in old_reps:
            if mid not in mig.new_reps:
                pool.mns[mid].drop_region(mig.region)
        pool.migrations.pop(mig.region, None)
        self.commit_membership()
        # the repair's log commits may have poked objects in other
        # regions that are still mid-migration
        self._resync_migrations()

    def maybe_recover_mns(self) -> bool:
        dead = self.detect_dead_mns()
        if not dead:
            return False
        # in-flight migrations touching a dead MN are abandoned before
        # recovery re-homes anything (crash-during-migration arbitration:
        # nothing was installed, so aborting is always safe)
        if self.migrator is not None:
            self.migrator.abort_for_dead(dead)
        # disconnection phase: notify clients (lease expiry)
        for c in self.clients.values():
            if not c.crashed:
                c.notified_prepare = True
        for mid in dead:
            self.pool.directory.remove_member(mid)   # crash-stop: leaves ring
            self._recover_mn(mid)
            self.handled_mn_crashes.add(mid)
        # commit membership change
        self.commit_membership()
        self._resync_migrations()
        # re-plan aborted shard moves / pending drains on the new ring
        if self.migrator is not None:
            self.migrator.on_membership_change()
        return True

    def _slot_value_live(self, slot_val: int) -> bool:
        """May ``slot_val`` be adopted during repair?  A nonzero slot value
        whose object's used bit is already 0 is the *residue of a concluded
        round*: its writer lost, reset its embedded log (Alg 1 loser path)
        and may since have reclaimed and reused the object.  Adopting such
        a value resurrects a dead round — the index slot ends up
        referencing a reset object (heapcheck: "slot survived a loser
        reset", the storm-seeds-8/15 corruption).  Empty (0) values adopt
        freely (an in-flight DELETE broadcast)."""
        if slot_val == 0:
            return True
        ptr = L.slot_ptr(slot_val)
        region, off = L.ptr_region(ptr), L.ptr_offset(ptr)
        n = L.size_class_words(L.slot_size_class(slot_val))
        for rep_mid in self.pool.placement.get(region, []):
            mn = self.pool.mns[rep_mid]
            if mn.alive and region in mn.regions:
                return bool(L.log_tail_used(
                    get_word(mn.regions[region], off + n - 1)))
        return False        # object unreadable: never adopt blind

    def _repair_index_region(self, g: int):
        """Alg 3, modification phase, for one index shard: for every slot
        where alive replicas disagree, adopt an alive *backup* value
        (backups are never older than the primary under SNAPSHOT) and
        commit that round's embedded log.  Shared by MN recovery and the
        migration cutover (which must converge straddling rounds before
        replica roles change).

        Adoption skips backup values whose round already concluded LOSE
        (``_slot_value_live``): only a value with a live embedded log may
        be installed, otherwise the first alive replica's value stands."""
        pool = self.pool
        reps = pool.placement[g]
        alive = [(i, r) for i, r in enumerate(reps) if pool.mns[r].alive]
        if not alive:
            return
        arrays = [pool.mns[r].regions[g] for _, r in alive]
        n = pool.cfg.index_words
        # one host snapshot of every alive copy; only diverging slots are
        # visited (the repair below writes index words of THIS region only,
        # and _commit_log_of touches data regions, so the snapshot stays
        # exact for the slots not yet visited)
        snap = np.stack([to_u64(a[:n]) for a in arrays])
        diverged = np.nonzero((snap != snap[0]).any(axis=0))[0]
        for off in diverged.tolist():
            vals = [int(v) for v in snap[:, off]]
            backup_vals = [v for (i, _), v in zip(alive, vals) if i > 0]
            chosen = next((v for v in backup_vals
                           if self._slot_value_live(v)), vals[0])
            for a in arrays:
                set_word(a, off, chosen)
            self._commit_log_of(chosen)

    def _recover_mn(self, mid: int):
        pool = self.pool
        # 1. slot repair on the index (Alg 3, modification phase) — only
        #    the shards with a replica on the dead MN can have diverged
        #    from THIS crash
        for g in pool.index_regions:
            if mid in pool.placement[g]:
                self._repair_index_region(g)
        #    ... and the ordered keydir's adopt-backup + structural repair
        if any(mid in pool.placement[g] for g in pool.ordered_regions):
            ordered.repair_ordered(pool)
        # 2. region re-homing: every region with a replica on the dead MN gets
        #    a fresh replica on the next alive ring successor; the first alive
        #    replica becomes primary.
        alive_mids = [m.mid for m in pool.mns if m.alive]
        for g, reps in list(pool.placement.items()):
            if mid not in reps:
                continue
            survivors = [r for r in reps if pool.mns[r].alive]
            if not survivors:
                from .faults import RegionLost  # local: faults imports RecoveryStats
                raise RegionLost(g, f"placement {reps}, alive MNs "
                                    f"{alive_mids} (Alg-3 cannot re-home)")
            candidates = [m for m in alive_mids if m not in survivors]
            new_reps = survivors + candidates[:len(reps) - len(survivors)]
            pool.recover_mn_placement(g, new_reps)

    def _resync_migrations(self):
        """Master recovery procedures poke replica arrays directly (they
        run atomically at one tick), bypassing the pool's dual-write
        mirror.  Re-sync the already-copied prefix of every open migration
        window from its primary so staged targets never miss a repair."""
        pool = self.pool
        for g, mig in pool.migrations.items():
            prim = pool.placement[g][0]
            mn = pool.mns[prim]
            if mn.alive and g in mn.regions and mig.copied:
                src = mn.regions[g][:mig.copied]
                for arr in mig.targets.values():
                    arr[:mig.copied] = src

    def _commit_log_of(self, slot_val: int):
        """Write MASTER_COMMIT_MARK into the old_value field of the object the
        chosen slot value points to, so client recovery never redoes it."""
        if slot_val == 0:
            return
        ptr = L.slot_ptr(slot_val)
        sc = L.slot_size_class(slot_val)
        region, off = L.ptr_region(ptr), L.ptr_offset(ptr)
        n = L.size_class_words(sc)
        crc = L.crc8([MASTER_COMMIT_MARK])
        for rep_mid in self.pool.placement.get(region, []):
            mn = self.pool.mns[rep_mid]
            if mn.alive and region in mn.regions:
                mem = mn.regions[region]
                set_word(mem, off + n - 3, MASTER_COMMIT_MARK)
                mid_w = get_word(mem, off + n - 2)
                set_word(mem, off + n - 2, int(L.pack_log_mid(
                    L.log_mid_next(mid_w), L.log_mid_opcode(mid_w), crc)))

    # ------------------------------------------------------------- queries
    def fail_query(self, slot_off: int, region: int = INDEX_REGION,
                   **_) -> Optional[int]:
        """Alg 4 line 35 + §A.4.3: decide (and complete) a contested slot
        of one index shard.

        If the backups agree on a value the primary does not hold, an
        in-flight SNAPSHOT round stalled — its winner crashed between the
        backup broadcast and the primary CAS, so pollers would wait
        forever.  The master arbitrates: it installs the backup-majority
        value on every replica and commits that round's embedded log (so
        §5.3 recovery never redoes it), then returns the decided value.
        Otherwise the primary value stands."""
        self.maybe_recover_mns()
        pool = self.pool
        reps = pool.placement[region]
        vals = []
        for i in range(len(reps)):
            v = pool.read(region, i, slot_off, 1)
            vals.append(None if v is None else int(v[0]))
        primary = vals[0]
        if primary is None:
            from .faults import RegionLost  # local: faults imports RecoveryStats
            raise RegionLost(region,
                             f"primary replica unreadable in fail_query "
                             f"(slot_off={slot_off}, placement={reps}) even "
                             "after maybe_recover_mns")
        backups = [v for v in vals[1:] if v is not None]
        # only values whose round is still live may be installed — the
        # residue of a concluded (reset) loser must never win arbitration
        # (same guard as _repair_index_region; storm seeds 8/15)
        live = [v for v in backups if self._slot_value_live(v)]
        if live:
            counts: Dict[int, int] = {}
            for v in live:
                counts[v] = counts.get(v, 0) + 1
            v_maj = max(counts, key=lambda k: (counts[k], -k))
            if (2 * counts[v_maj] >= len(backups)
                    and v_maj not in (primary, 0)):
                for i, v in enumerate(vals):
                    if v is not None:
                        pool.write(region, i, slot_off, [v_maj])
                self._commit_log_of(v_maj)
                self._resync_migrations()
                return v_maj
        return primary

    def bucket_query(self, off: int, region: int = INDEX_REGION):
        self.maybe_recover_mns()
        v = self.pool.read(region, 0, off, self.pool.cfg.slots_per_bucket)
        return list(v)

    # ------------------------------------------------------------- clients
    def recover_client(self, cid: int, *, reassign_to: Optional[FuseeClient] = None
                       ) -> RecoveryStats:
        """§5.3: memory re-management + index repair from the embedded log.

        Returns stats mirroring Table 1.  If ``reassign_to`` is given, the
        crashed client's blocks/free-lists are handed to that client
        (elastic replacement); otherwise they stay master-managed.
        """
        pool = self.pool
        st = RecoveryStats(reconnect_ms=self.reconnect_ms)
        self.maybe_recover_mns()
        # the crashed client may have died mid-leaf-split or mid-claim in
        # the ordered keydir: converge replicas, reap half-split leaves,
        # re-home stranded entries BEFORE replaying its embedded log (the
        # log replay below re-ensures entries for recovered keys)
        ordered.repair_ordered(pool)

        # -- step 1: find all blocks owned by cid via the BATs (MN-side scan)
        owned: List[Tuple[int, int]] = []  # (region, block_idx)
        for g in pool.data_regions:
            prim = pool.primary_mn(g)
            mem = pool.mns[prim].regions.get(g)
            if mem is None:
                continue
            bat = to_u64(mem[:pool.cfg.blocks_per_region])
            owned.extend((g, b) for b in
                         np.nonzero(bat == cid + 1)[0].tolist())
        st.construct_free_list_rtts += max(1, len(owned) // 16)

        # -- step 2: read per-size-class list heads (meta region)
        base = cid * META_WORDS_PER_CLIENT
        heads_raw = pool.read(META_REGION, 0, base, pool.cfg.size_classes)
        heads = [int(h) for h in (heads_raw if heads_raw is not None else [])]
        st.get_metadata_rtts += 1

        # -- step 3: traverse per-size-class linked lists; gather log entries
        tail_entries = []  # (ptr, sc, obj)
        for sc, head in enumerate(heads):
            if head == 0:
                continue
            ptr, hops, seen = head, 0, set()
            last_used = None
            while ptr != 0 and ptr not in seen and hops < 1 << 16:
                seen.add(ptr)
                hops += 1
                region, off = L.ptr_region(ptr), L.ptr_offset(ptr)
                raw = pool.read(region, 0, off, L.size_class_words(sc))
                if raw is None:
                    break
                obj = L.parse_object(list(raw))
                st.traverse_log_rtts += 1
                if obj["used"]:
                    last_used = (ptr, sc, obj)
                    st.used_objects += 1
                ptr = obj["next_ptr"]
            if last_used is not None:
                tail_entries.append(last_used)

        # -- step 4: index repair (the at-most-one in-flight request per list)
        for (ptr, sc, obj) in tail_entries:
            st.recover_requests_rtts += 2
            self._repair_entry(cid, ptr, sc, obj, st)

        # -- step 5: memory re-management: scan blocks, rebuild free lists
        free_lists: Dict[int, List[int]] = {}
        snaps: Dict[int, np.ndarray] = {}
        for (g, b) in owned:
            # one host snapshot per region copy: the loop below reads only
            # its bitmap and object words (BAT re-owning writes go to the
            # device)
            if g not in snaps:
                snaps[g] = to_u64(pool.mns[pool.primary_mn(g)].regions[g])
            mem = snaps[g]
            bm_base = pool.bitmap_base(b)
            blk_base = pool.block_base(b)
            # size class of the block = inferred from first used object, else
            # reclaim whole block at min granularity
            sc = self._infer_block_sc(mem, blk_base)
            scw = L.size_class_words(sc)
            n_objs = pool.cfg.block_payload_words // scw
            for i in range(n_objs):
                off = blk_base + i * scw
                bit_idx = (off - blk_base) // L.MIN_OBJ_WORDS
                freed = bool(int(mem[bm_base + bit_idx // 64]) >> (bit_idx % 64) & 1)
                tail = int(mem[off + scw - 1])
                used = L.log_tail_used(tail)
                if used and not freed:
                    continue  # still-live object
                free_lists.setdefault(sc, []).append(L.pack_ptr(g, off))
                st.reclaimed_objects += 1
            st.construct_free_list_rtts += 1
            if reassign_to is not None:
                # re-own the block: rewrite BAT entries to the new client
                for rep_mid in pool.placement[g]:
                    mn = pool.mns[rep_mid]
                    if mn.alive and g in mn.regions:
                        set_word(mn.regions[g], b, reassign_to.cid + 1)

        if reassign_to is not None:
            for sc, ptrs in free_lists.items():
                s = reassign_to._sc_state(sc)
                for p in ptrs:
                    s.free.append(p)
                for (g, b) in owned:
                    if (g, b) not in s.blocks:
                        s.blocks.append((g, b))
        self._resync_migrations()
        return st

    def _infer_block_sc(self, mem, blk_base: int) -> int:
        for sc in range(self.pool.cfg.size_classes):
            scw = L.size_class_words(sc)
            tail = int(mem[blk_base + scw - 1])
            if L.log_tail_used(tail):
                return sc
        return 0

    def _repair_entry(self, cid: int, ptr: int, sc: int, obj, st: RecoveryStats):
        """§5.3 index repair decision tree for one in-flight log entry."""
        pool = self.pool
        old_v = int(obj["old_value"])
        crc_ok = obj["old_crc"] == L.crc8([old_v]) and old_v != 0
        key = obj["key"]
        region = pool.index_region_of(key)     # shard routing (as clients do)
        v_new = int(L.pack_slot(L.fingerprint(key), sc, ptr))
        if not obj["crc_ok"]:
            # c0: crashed while writing the KV pair itself -> reclaim silently
            self._reclaim_obj(ptr, sc)
            return
        # the client may have crashed mid-write-phase with the KV object
        # landed on a subset of its replicas only (the crash drops the
        # remaining QP lanes).  Every branch below keeps the object
        # reachable, so converge the replicas from the copy the log was
        # validated against first — otherwise a later MN recovery can adopt
        # a torn (all-zero) copy and the index ends up referencing garbage
        # (storm seeds 8/15).
        if not UNSAFE_REDO_NO_CONVERGE:
            self._converge_obj_replicas(ptr, sc)
        if not crc_ok:
            # c1 (or a non-returned loser): old value incomplete -> REDO the
            # request on the client's behalf, via the normal SNAPSHOT path.
            st.redone_ops += 1
            self._redo(cid, key, obj, v_new, sc, ptr)
            return
        if old_v == MASTER_COMMIT_MARK:
            return  # already committed by the master during MN recovery
        # complete old value: the entry belongs to a round winner (c2/c3)
        slot_off = self._find_slot_of(key, old_v, v_new)
        if slot_off is None:
            return
        cur = pool.read(region, 0, slot_off, 1)
        if cur is not None and int(cur[0]) == old_v:
            # c2: winner crashed after commit, before the primary CAS
            for i in range(len(pool.placement[region])):
                pool.cas(region, i, slot_off, old_v, v_new)
            st.fixed_primaries += 1
        # else c3: finished; nothing to do
        if obj["opcode"] != L.OPCODE_DELETE:
            # the client may have crashed between its RACE commit and its
            # ordered-keydir ensure: restore scan visibility (§5.3)
            ordered.ensure_entry_direct(pool, key)

    def _find_slot_of(self, key: int, *vals) -> Optional[int]:
        cfg = self.pool.cfg
        region = self.pool.index_region_of(key)
        for off in race.slot_offsets(key, cfg.index_buckets, cfg.slots_per_bucket):
            cur = self.pool.read(region, 0, off, 1)
            if cur is not None and int(cur[0]) in [int(v) for v in vals]:
                return off
        return None

    def _redo(self, cid: int, key: int, obj, v_new: int, sc: int, ptr: int):
        """Re-execute the crashed request.  The KV object already exists, so
        the redo is the index write only, run through the SNAPSHOT protocol
        (the master acts as an ordinary writer, §5.4)."""
        opcode = obj["opcode"]
        target_v_new = 0 if opcode == L.OPCODE_DELETE else v_new
        cfg = self.pool.cfg
        region = self.pool.index_region_of(key)
        # locate the slot: existing entry for key, else an empty slot
        slot_off, v_old = None, 0
        offs = race.slot_offsets(key, cfg.index_buckets, cfg.slots_per_bucket)
        for off in offs:
            cur = self.pool.read(region, 0, off, 1)
            if cur is None:
                continue
            w = int(cur[0])
            if w != 0 and L.slot_fp(w) == L.fingerprint(key) and w != v_new:
                raw = self.pool.read(L.ptr_region(L.slot_ptr(w)), 0,
                                     L.ptr_offset(L.slot_ptr(w)),
                                     L.size_class_words(L.slot_size_class(w)))
                if raw is not None and L.parse_object(list(raw))["key"] == key:
                    slot_off, v_old = off, w
                    break
            if w == v_new:
                slot_off, v_old = off, w  # already applied
                break
        if slot_off is None:
            if opcode == L.OPCODE_DELETE:
                self._reclaim_obj(ptr, sc)
                return
            for off in offs:
                cur = self.pool.read(region, 0, off, 1)
                if cur is not None and int(cur[0]) == 0:
                    slot_off, v_old = off, 0
                    break
        if slot_off is None:
            return
        if v_old != int(target_v_new):
            # atomic redo: CAS backups then primary (master is the only
            # recovery writer for this client; concurrent client writers are
            # handled by CAS atomicity exactly as in SNAPSHOT)
            r = len(self.pool.placement[region])
            okb = all(int(self.pool.cas(region, i, slot_off, v_old,
                                        target_v_new)) == v_old
                      for i in range(1, r)) if r > 1 else True
            if okb:
                self.pool.cas(region, 0, slot_off, v_old, target_v_new)
        # commit the log so the op is never redone twice
        self._commit_log_of(v_new)
        if opcode == L.OPCODE_DELETE:
            self._reclaim_obj(ptr, sc)
        else:
            ordered.ensure_entry_direct(self.pool, key)

    def _converge_obj_replicas(self, ptr: int, sc: int) -> None:
        """§5.3: re-replicate a recovered log-entry object to all replicas.

        The embedded log is traversed on the primary replica, so the copy
        the repair decision was made from is authoritative; backup replicas
        that missed the crashed client's write phase are brought up to date
        before the entry is (re-)installed in the index.
        """
        pool = self.pool
        region, off = L.ptr_region(ptr), L.ptr_offset(ptr)
        n = L.size_class_words(sc)
        src = pool.read(region, 0, off, n)
        if src is None:
            return
        words = [int(w) for w in src]
        for i in range(1, len(pool.placement.get(region, []))):
            cur = pool.read(region, i, off, n)
            if cur is not None and [int(w) for w in cur] != words:
                pool.write(region, i, off, words)

    def _reclaim_obj(self, ptr: int, sc: int):
        region, off = L.ptr_region(ptr), L.ptr_offset(ptr)
        scw = L.size_class_words(sc)
        tail = int(L.pack_log_tail(0, used=False))
        for rep_mid in self.pool.placement.get(region, []):
            mn = self.pool.mns[rep_mid]
            if mn.alive and region in mn.regions:
                set_word(mn.regions[region], off + scw - 1, tail)
