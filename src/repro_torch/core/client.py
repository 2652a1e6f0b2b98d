"""The FUSEE client: SNAPSHOT replication (Alg. 1+2+4), two-level allocation
(§4.4), embedded operation log (§4.5), adaptive index cache (§4.6), and the
four KV-op workflows of Fig. 9.

Each public ``op_*`` method returns a *generator* that yields
``events.Phase`` / ``events.MasterCall`` objects and finally returns an
``events.OpResult``.  The scheduler in sim.py drives these generators,
interleaving verbs across clients; nothing here touches the pool directly
except through yielded verbs — exactly the one-sided-RDMA discipline of the
paper.

RTT accounting follows Fig. 9: every yielded non-background phase is one
doorbell-batched round trip.  The conflict-free fast path is
INSERT/UPDATE/DELETE = 4 RTTs, SEARCH = 1-2 RTTs.

Counterpart of the JAX package's ``core/client.py``: plain host Python, the
same state machines verb for verb, with the ordered-keydir hooks and
SCAN/RANGE of core/ordered.py.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import layout as L
from . import ordered
from . import race
from .events import (CAUSE_CAS_LOST, CAUSE_FP_COLLISION, CAUSE_FULL,
                     CAUSE_LOSE_POLL, CAUSE_NONE, CAUSE_STALE_EPOCH,
                     EXISTS, FULL, NOT_FOUND, OK, MasterCall, OpResult, Phase,
                     Verb)
from .heap import FIRST_DATA_REGION, INDEX_REGION, META_REGION, \
    META_WORDS_PER_CLIENT, DMConfig, DMPool
from .rng import SimRng

# Sentinel the master writes into an old_value field it committed on a
# client's behalf (§A.4.3); any non-zero value with a valid CRC means
# "committed".  1 can never be a real slot value (fp=0 is reserved).
MASTER_COMMIT_MARK = 1

R1, R2, R3 = "Rule1", "Rule2", "Rule3"
LOSE, FINISH, FAILV = "LOSE", "FINISH", "FAIL"

# Bounded-retry cap for index races (stale candidates, lost empty-slot CAS
# rounds).  Exists only to turn a livelock into a typed FULL; it must
# comfortably exceed the worst per-bucket concurrency — a 1024-client fleet
# tick can legally pile a whole bucket's load onto one empty slot at once.
MAX_OP_RETRIES = 64

# A SNAPSHOT loser polls the primary waiting for the winner's commit (Alg 1
# lines 17-22).  If the winner crashed mid-commit the slot never moves, so
# after this many polls the loser escalates to the master's fail_query
# (Alg 4 / §A.4.3), which arbitrates the stalled round.  Generous enough
# that a merely slow-scheduled winner almost always commits first.
MAX_LOSE_POLLS = 48


def evaluate_rules_pure(v_list: List[Optional[int]], v_new: int):
    """Pure part of Alg. 2 (no Rule-3 primary check).  ``None`` = FAIL.

    Returns one of R1 / R2 / LOSE / FAILV / 'NEED_CHECK' (Rule-3 candidate).
    """
    if any(v is None for v in v_list):
        return FAILV
    if not v_list:  # r == 1: no backups; degenerate fast path handled upstream
        return R1
    vals = [int(v) for v in v_list]
    counts: Dict[int, int] = {}
    for v in vals:
        counts[v] = counts.get(v, 0) + 1
    v_maj = max(counts, key=lambda k: (counts[k], -k))
    cnt = counts[v_maj]
    n = len(vals)
    if cnt == n:
        return R1 if v_maj == int(v_new) else LOSE
    if 2 * cnt > n:
        return R2 if v_maj == int(v_new) else LOSE
    if int(v_new) not in vals:
        return LOSE
    return "NEED_CHECK"


@dataclass
class CacheEntry:
    slot_off: int
    slot_val: int
    access: int = 0
    invalid: int = 0
    # The key's index shard region and its placement-directory version at
    # fill time (§4.6 cache + elasticity): after the shard migrates or is
    # re-homed by recovery, the entry is no longer trusted for the 1-RTT
    # fast path until a full SEARCH revalidates it under the new
    # placement.  ``region`` is cached so the API layer's shadow-probe
    # eligibility filter never re-hashes keys to shards.
    region: int = 0
    shard_ver: int = 0

    @property
    def invalid_ratio(self) -> float:
        return self.invalid / max(1, self.access)


@dataclass
class SlabClass:
    free: deque = field(default_factory=deque)   # FIFO of ptrs (§4.5 ordering)
    last_alloc: int = 0                          # prev_ptr for the next alloc
    head_written: bool = False
    blocks: List[Tuple[int, int]] = field(default_factory=list)  # (region, blk)


class FuseeClient:
    def __init__(self, cid: int, pool: DMPool, *,
                 enable_cache: bool = True,
                 cache_threshold: float = 0.5,
                 replication_mode: str = "snapshot",  # 'snapshot' | 'cr'
                 seed: int = 0,
                 rng: Optional[np.random.Generator] = None):
        self.cid = cid
        self.pool = pool
        self.cfg: DMConfig = pool.cfg
        self.enable_cache = enable_cache
        self.cache_threshold = cache_threshold
        self.replication_mode = replication_mode
        # per-client protocol-jitter substream: callers (store.py) thread
        # the run's SimRng root; standalone construction derives the same
        # named substream from the seed (deterministic-replay contract)
        self.rng = rng if rng is not None \
            else SimRng(seed).stream(f"client.{cid}")
        self.slab: Dict[int, SlabClass] = {}
        self.cache: Dict[int, CacheEntry] = {}
        self.epoch = pool.epoch
        self._alloc_mn_rr = cid % self.cfg.num_mns
        # Set by the master / scheduler on membership changes (lease expiry).
        self.notified_prepare = False
        # deferred background frees: list of (region, block_idx, obj_idx)
        self._pending_resets: List[Tuple[int, int]] = []
        # ordered-keydir fence cache: leaf_id -> low key (append-only
        # facts — a leaf's low never changes and leaves never merge; see
        # core/ordered.py).  Empty until the first scan/ensure bootstraps.
        self.ord_fences: Dict[int, int] = {}
        self.ord_full_drops = 0   # inserts whose keydir entry hit ORD FULL
        self.crashed = False

    # ------------------------------------------------------------------ util
    @property
    def r(self) -> int:
        return len(self.pool.placement[INDEX_REGION])

    def _index_region(self, key: int) -> int:
        """Shard routing: the index region holding this key's buckets (a
        pure key hash over the S shard regions; S=1 -> INDEX_REGION)."""
        return self.pool.index_region_of(key)

    def _shard_ver(self, region: int) -> int:
        return self.pool.directory.version(region)

    def _cache_fresh(self, ce: CacheEntry, region: int) -> bool:
        """A cache entry is trusted for the 1-RTT fast path only while its
        shard's placement version is unchanged (keyed-by-shard-epoch cache
        contract; a migrated shard forces one full SEARCH revalidation)."""
        return ce.shard_ver == self._shard_ver(region)

    def _slot_verb_read_primary(self, region: int, off: int) -> Verb:
        return Verb("read", region=region, replica=0, off=off, n=1)

    def _obj_region_replicas(self, region: int) -> int:
        return len(self.pool.placement[region])

    def _ptr_of(self, region: int, off: int) -> int:
        return L.pack_ptr(region, off)

    def _read_obj_verb(self, ptr: int, sc: int, replica: int = 0) -> Verb:
        return Verb("read", region=L.ptr_region(ptr), replica=replica,
                    off=L.ptr_offset(ptr), n=L.size_class_words(sc))

    # ---------------------------------------------------------- slab (level 2)
    def _sc_state(self, sc: int) -> SlabClass:
        if sc not in self.slab:
            self.slab[sc] = SlabClass()
        return self.slab[sc]

    def _ensure_free(self, sc: int):
        """Keep >=2 free objects so the pre-positioned next_ptr always exists."""
        if self.cfg.block_payload_words // L.size_class_words(sc) == 0:
            # the object class exceeds a block's payload: no grant can ever
            # yield an object — typed FULL, and no block is leaked trying
            return FULL
        st = self._sc_state(sc)
        attempts = 0
        cause = CAUSE_NONE
        while len(st.free) < 2:
            mn = self._alloc_mn_rr % self.cfg.num_mns
            self._alloc_mn_rr += 1
            attempts += 1
            if attempts > 2 * self.cfg.num_mns:
                return FULL
            if not self.pool.mns[mn].alive:
                continue
            res = yield Phase([Verb("alloc", mn=mn)], label="alloc",
                              cause=cause)
            if res[0] is None:
                cause = CAUSE_FULL   # failed grant: re-asking under pressure
                continue
            region, blk = res[0]
            base = self.pool.block_base(blk)
            scw = L.size_class_words(sc)
            n_objs = self.cfg.block_payload_words // scw
            for i in range(n_objs):
                st.free.append(self._ptr_of(region, base + i * scw))
            st.blocks.append((region, blk))
            if not st.head_written:
                # §4.5: store the per-size-class list head on MNs at init time
                # (first block grant).  Head = first object to be allocated.
                head_ptr = st.free[0]
                off = self.cid * META_WORDS_PER_CLIENT + sc
                verbs = [Verb("write", region=META_REGION, replica=i, off=off,
                              words=[head_ptr])
                         for i in range(len(self.pool.placement[META_REGION]))]
                yield Phase(verbs, label="write_list_head")
                st.head_written = True
        return OK

    def _take_obj(self, sc: int) -> Tuple[int, int, int]:
        """Pop the FIFO head. Returns (ptr, next_ptr, prev_ptr)."""
        st = self._sc_state(sc)
        ptr = st.free.popleft()
        next_ptr = st.free[0] if st.free else 0
        prev_ptr = st.last_alloc
        st.last_alloc = ptr
        return ptr, next_ptr, prev_ptr

    def _write_obj_verbs(self, ptr: int, words) -> List[Verb]:
        region = L.ptr_region(ptr)
        off = L.ptr_offset(ptr)
        return [Verb("write", region=region, replica=i, off=off, words=words)
                for i in range(self._obj_region_replicas(region))]

    def _free_obj_verbs(self, slot_val: int) -> List[Verb]:
        """FAA the free bit of the object referenced by a slot value (§4.4)."""
        ptr = L.slot_ptr(slot_val)
        region, off = L.ptr_region(ptr), L.ptr_offset(ptr)
        cfg = self.cfg
        blk = (off - cfg.bat_words) // cfg.block_words
        base = self.pool.block_base(blk)
        obj_idx = (off - base) // L.MIN_OBJ_WORDS  # bit index at min-class granularity
        woff = self.pool.bitmap_base(blk) + obj_idx // 64
        delta = 1 << (obj_idx % 64)
        return [Verb("faa", region=region, replica=i, off=woff, delta=delta)
                for i in range(self._obj_region_replicas(region))]

    def _reset_used_verbs(self, ptr: int, sc: int, prev_ptr: int) -> List[Verb]:
        tail = int(L.pack_log_tail(prev_ptr, used=False))
        off = L.ptr_offset(ptr) + L.size_class_words(sc) - 1
        region = L.ptr_region(ptr)
        return [Verb("write", region=region, replica=i, off=off, words=[tail])
                for i in range(self._obj_region_replicas(region))]

    def _mark_invalid_verbs(self, slot_val: int) -> List[Verb]:
        """Set the invalidation bit of the *old* KV pair (§4.6 cache coherence).

        Uses FAA on the tail word; the invalid bit is set at most once (by the
        unique round winner), so FAA == set-bit.
        """
        ptr = L.slot_ptr(slot_val)
        sc = L.slot_size_class(slot_val)
        off = L.ptr_offset(ptr) + L.size_class_words(sc) - 1
        region = L.ptr_region(ptr)
        return [Verb("faa", region=region, replica=i, off=off, delta=L.INVALID_BIT)
                for i in range(self._obj_region_replicas(region))]

    def _bg_cleanup(self, verbs: List[Verb], label: str):
        """Issue background cleanup obligations (free-bit FAA / cache
        invalidation / used-bit reset) and re-issue any that bounced.

        A verb that returns None was NOT executed (lease-epoch bounce or
        dead MN) — dropping it leaks the object: used bit set, no index
        reference, free-list push lost.  Re-issuing the same Verb instance
        is safe because the scheduler re-stamps its epoch on enqueue and a
        None result guarantees the side effect never landed (re-building
        FAA verbs would NOT be safe — a landed FAA re-issued flips the bit
        back).

        Bounced verbs are re-aimed by the MN *identity* they originally
        targeted, not their replica index: an MN-crash failover renumbers
        the surviving copies, so "replica 1" of a 2-replica region becomes
        replica 0 of a 1-replica region while pointing at the exact same
        memory.  Filtering by index there discards a still-owed obligation
        against live memory and leaks the object on the new primary (found
        by the model checker's stale_epoch scope).  A verb whose target MN
        no longer hosts the region is moot (the copy's memory died with
        the MN) or migrated away — either way it falls to the owner-side
        reclaim scan (§4.4).  Bounded best effort: after MAX_OP_RETRIES
        rounds the remainder is likewise left to the reclaim scan.
        """
        def _target_mn(v: Verb) -> int:
            reps = self.pool.placement.get(v.region, ())
            return reps[v.replica] if v.replica < len(reps) else -1

        pending = [(v, _target_mn(v)) for v in verbs]
        attempts = 0
        while pending and attempts <= MAX_OP_RETRIES:
            res = yield Phase([v for v, _ in pending], label=label,
                              background=True,
                              cause=CAUSE_STALE_EPOCH if attempts
                              else CAUSE_NONE)
            nxt = []
            for (v, mn), r in zip(pending, res):
                if r is not None:
                    continue
                reps = self.pool.placement.get(v.region, ())
                if mn in reps:  # copy survived, possibly renumbered
                    v.replica = list(reps).index(mn)
                    nxt.append((v, mn))
            pending = nxt
            attempts += 1

    # ------------------------------------------------- SNAPSHOT WRITE (Alg 1)
    def _snapshot_write(self, region: int, slot_off: int, v_old: int,
                        v_new: int, obj_ptr: int, obj_sc: int, prev_ptr: int,
                        cause: str = CAUSE_NONE):
        """Returns (status, rule, committed_value_now_in_primary_or_None).

        ``region`` is the key's index shard (shard routing); the whole
        round — backup broadcast, rule 3 check, primary CAS, fail path —
        addresses that shard's replicas.  ``obj_ptr/obj_sc/prev_ptr``
        identify this writer's object so the commit (phase 3) and loser
        used-bit reset target the embedded log.  ``cause`` carries the
        op-level retry cause into this round's opening phase so the span
        profiler attributes re-entered SNAPSHOT rounds to what forced them.
        """
        if self.replication_mode == "cr":
            return (yield from self._cr_write(region, slot_off, v_old, v_new,
                                              cause))
        r = len(self.pool.placement[region])   # this shard's replica count
        extra = 0
        if r == 1:
            # Degenerate: no backups; CAS primary directly; the log commit is
            # skipped (§6.1, single-index-replica comparison mode).
            res = yield Phase([Verb("cas", region=region, replica=0,
                                    off=slot_off, exp=v_old, new=v_new)],
                              label="4:cas_primary", cause=cause)
            if res[0] is None:
                return (yield from self._fail_path(region, slot_off, v_old,
                                                   v_new, obj_ptr, obj_sc,
                                                   prev_ptr,
                                                   cause=CAUSE_STALE_EPOCH))
            if int(res[0]) == int(v_old):
                return OK, R1, v_new
            if int(res[0]) == int(v_new):
                # the primary already holds OUR value: the master installed
                # it on our behalf (fail_query arbitration of an earlier
                # bounced round) and committed our log — we are the winner
                return OK, "MASTER_WIN", v_new
            # lost the race; linearize just before the winner
            yield Phase(self._reset_used_verbs(obj_ptr, obj_sc, prev_ptr),
                        label="loser_reset", cause=CAUSE_CAS_LOST)
            return OK, LOSE, int(res[0])

        # Phase 2: broadcast CAS to all backups (Alg 1, line 7)
        res = yield Phase([Verb("cas", region=region, replica=i,
                                off=slot_off, exp=v_old, new=v_new)
                           for i in range(1, r)], label="2:cas_backups",
                          cause=cause)
        v_list = [None if v is None else
                  (int(v_new) if int(v) == int(v_old) else int(v))
                  for v in res]
        win = evaluate_rules_pure(v_list, v_new)
        if win == "NEED_CHECK":
            # Rule 3 pre-check (Alg 2, line 12): has the primary moved?
            chk = yield Phase([self._slot_verb_read_primary(region, slot_off)],
                              label="rule3_check")
            if chk[0] is None:
                win = FAILV
            elif int(chk[0][0]) == int(v_new):
                # the primary moved to OUR value: the master's adopt-backup
                # repair (Alg-3 recovery or fail_query) installed our
                # backup-CAS residue and committed our log — concluding
                # FINISH here would reset the used bit of the very object
                # the index now references (the seeds-8/15 bug)
                return OK, "MASTER_WIN", v_new
            elif int(chk[0][0]) != int(v_old):
                win = FINISH
            elif min(v_list) == int(v_new):
                win = R3
            else:
                win = LOSE

        if win == FAILV:
            return (yield from self._fail_path(region, slot_off, v_old, v_new,
                                               obj_ptr, obj_sc, prev_ptr,
                                               cause=CAUSE_STALE_EPOCH))

        if win in (R1, R2, R3):
            # Phase 3: commit the embedded log (write old_value + CRC into our
            # object, all replicas) and, for Rule 2/3, repair divergent
            # backups in the same doorbell batch.
            verbs = self._commit_log_verbs(obj_ptr, obj_sc, v_old)
            nlog = len(verbs)
            if win in (R2, R3):
                verbs += [Verb("cas", region=region, replica=i + 1,
                               off=slot_off, exp=v_list[i], new=v_new)
                          for i in range(r - 1) if v_list[i] != int(v_new)]
            res3 = yield Phase(verbs, label="3:commit+fix")
            bad = any(v is None for v in res3)
            if not bad:
                for v, fix in zip(res3[nlog:], verbs[nlog:]):
                    if int(v) not in (int(fix.exp), int(v_new)):
                        bad = True   # backup moved to a THIRD value mid-fix
                        break
            if bad:
                # A commit/fix verb bounced on a lease-epoch change, or a
                # divergent backup moved again under the repair: acking now
                # could leave a backup newer than the primary (the Alg-3
                # invariant) or our round half-installed — escalate to the
                # master's arbitration (Alg 4) instead.
                return (yield from self._fail_path(region, slot_off, v_old,
                                                   v_new, obj_ptr, obj_sc,
                                                   prev_ptr,
                                                   cause=CAUSE_STALE_EPOCH))
            res = yield Phase([Verb("cas", region=region, replica=0,
                                    off=slot_off, exp=v_old, new=v_new)],
                              label="4:cas_primary")
            if res[0] is None:
                return (yield from self._fail_path(region, slot_off, v_old,
                                                   v_new, obj_ptr, obj_sc,
                                                   prev_ptr,
                                                   cause=CAUSE_STALE_EPOCH))
            if int(res[0]) != int(v_old):
                # The primary moved after our rule check: a concurrent round
                # (possibly for a DIFFERENT key colliding on this slot)
                # committed first, so we did NOT win — acking here is the
                # seed-13 lost-write hole.  Let the master arbitrate: it
                # decides v_new (win), v_old (retry), or the other round's
                # value (lose; op_insert's empty-slot guard re-runs us).
                return (yield from self._fail_path(region, slot_off, v_old,
                                                   v_new, obj_ptr, obj_sc,
                                                   prev_ptr,
                                                   cause=CAUSE_CAS_LOST))
            return OK, win, v_new

        if win == FINISH:
            yield Phase(self._reset_used_verbs(obj_ptr, obj_sc, prev_ptr),
                        label="loser_reset", cause=CAUSE_CAS_LOST)
            return OK, FINISH, None

        # LOSE: poll the primary until the winner commits (Alg 1, lines 17-22)
        polls = 0
        while True:
            if self.notified_prepare or polls >= MAX_LOSE_POLLS:
                # membership change, or the winner is taking suspiciously
                # long (crashed mid-commit?): escalate to the master
                return (yield from self._fail_path(region, slot_off, v_old,
                                                   v_new, obj_ptr, obj_sc,
                                                   prev_ptr,
                                                   cause=CAUSE_LOSE_POLL))
            polls += 1
            chk = yield Phase([self._slot_verb_read_primary(region, slot_off)],
                              label="lose_poll", cause=CAUSE_LOSE_POLL)
            if chk[0] is None:
                return (yield from self._fail_path(region, slot_off, v_old,
                                                   v_new, obj_ptr, obj_sc,
                                                   prev_ptr,
                                                   cause=CAUSE_STALE_EPOCH))
            if int(chk[0][0]) != int(v_old):
                break
        if int(chk[0][0]) == int(v_new):
            # the slot moved to OUR value while we were polling: an MN
            # crash mid-round let Alg-3 recovery adopt our backup-CAS
            # residue (``_repair_index_region`` takes the first alive
            # backup) and commit our embedded log.  We are the committed
            # winner — resetting the used bit now would leave the index
            # slot referencing a dead object (storm seeds 8/15).
            return OK, "MASTER_WIN", v_new
        # reset our used bit before returning so recovery never redoes a
        # returned (lost) op — required for linearizability under redo (§5.3).
        yield Phase(self._reset_used_verbs(obj_ptr, obj_sc, prev_ptr),
                    label="loser_reset", cause=CAUSE_CAS_LOST)
        return OK, LOSE, int(chk[0][0])

    def _cr_write(self, region: int, slot_off: int, v_old: int, v_new: int,
                  cause: str = CAUSE_NONE):
        """FUSEE-CR baseline (§6.1): sequentially CAS every replica.

        One CAS per RTT, primary last — latency grows linearly with r.
        """
        r = len(self.pool.placement[region])
        for i in range(r - 1, -1, -1):
            while True:
                res = yield Phase([Verb("cas", region=region, replica=i,
                                        off=slot_off, exp=v_old, new=v_new)],
                                  label=f"cr:cas_{i}", cause=cause)
                if res[0] is None:
                    return FAILV, None, None
                old = int(res[0])
                if old == int(v_old) or old == int(v_new):
                    break
                cause = CAUSE_CAS_LOST   # lost this replica's round: re-CAS
                if i == r - 1:
                    # lost on the first replica: adopt last-writer-wins by
                    # retrying on the new value
                    v_old = old
                else:
                    v_old = old
            # continue to next replica with the same expected value
        return OK, "CR", v_new

    def _commit_log_verbs(self, obj_ptr: int, obj_sc: int, v_old: int) -> List[Verb]:
        region = L.ptr_region(obj_ptr)
        off = L.ptr_offset(obj_ptr)
        n = L.size_class_words(obj_sc)
        crc = L.crc8([int(v_old)])
        # rewrite w[-3] (old_value) and w[-2] (next|op|crc): we must preserve
        # next/op which we know locally; reconstructed by the op wrapper.
        old_w = int(np.uint64(int(v_old) & 0xFFFF_FFFF_FFFF_FFFF))
        mid = self._pending_mid  # set by the op before calling snapshot_write
        mid_new = int(L.pack_log_mid(L.log_mid_next(mid), L.log_mid_opcode(mid), crc))
        verbs = [Verb("write", region=region, replica=i, off=off + n - 3,
                      words=[old_w, mid_new])
                 for i in range(self._obj_region_replicas(region))]
        return verbs

    # ------------------------------------------------------- failure path
    def _fail_path(self, region: int, slot_off: int, v_old: int, v_new: int,
                   obj_ptr: int, obj_sc: int, prev_ptr: int,
                   cause: str = CAUSE_STALE_EPOCH):
        """Alg 4 lines 34-38: ask the master, retry if our write is too new.

        ``cause`` records WHY the round escalated (bounced verb vs lost
        CAS vs stalled LOSE poll) so the wait-master stall beats are
        attributed to the triggering event, not lumped together.
        """
        while True:
            ans = yield MasterCall("fail_query", payload=dict(
                region=region, slot_off=slot_off, v_old=v_old, v_new=v_new,
                cid=self.cid))
            if ans is None:
                # master has not yet detected/recovered; wait a beat
                yield Phase([], label="wait_master", cause=cause)
                continue
            self.epoch = self.pool.epoch
            self.notified_prepare = False
            v_dec = int(ans)
            if v_dec == int(v_new):
                return OK, "MASTER_WIN", v_new
            if v_dec == int(v_old):
                # our value was not applied and the decided value is stale:
                # retry the write from scratch (Alg 4 line 37-38)
                return "RETRY", None, v_dec
            # someone else's newer value was committed; we linearize before it
            yield Phase(self._reset_used_verbs(obj_ptr, obj_sc, prev_ptr),
                        label="loser_reset", cause=CAUSE_CAS_LOST)
            return OK, "MASTER_LOSE", v_dec

    # ------------------------------------------------------------ index read
    def _read_index_for(self, key: int, extra_verbs: List[Verb],
                        cause: str = CAUSE_NONE):
        """Phase 1 helper: read both candidate buckets of the key's index
        shard (+ any op-specific verbs folded into the same doorbell
        batch).  Shard routing happens here for every op's index read.
        ``cause`` marks re-entered rounds (op-level retry loops).

        Returns (bucket_words, base_offs, extra_results).
        """
        cfg = self.cfg
        region = self._index_region(key)
        b1, b2 = race.bucket_pair(key, cfg.index_buckets)
        o1 = race.bucket_off(b1, cfg.slots_per_bucket)
        o2 = race.bucket_off(b2, cfg.slots_per_bucket)
        verbs = [Verb("read", region=region, replica=0, off=o1,
                      n=cfg.slots_per_bucket),
                 Verb("read", region=region, replica=0, off=o2,
                      n=cfg.slots_per_bucket)] + extra_verbs
        res = yield Phase(verbs, label="1:read_index", cause=cause)
        if res[0] is None or res[1] is None:
            return None, None, res[2:]
        return ([list(res[0]), list(res[1])], [o1, o2], res[2:])

    def _locate(self, key: int, buckets, base_offs):
        """Find (slot_off, slot_val) candidates whose fp matches key."""
        fp = L.fingerprint(key)
        cands = []
        for words, base in zip(buckets, base_offs):
            cands += race.find_matches(words, base, fp)
        return cands

    def _verify_candidates(self, key: int, cands, cause: str = CAUSE_NONE):
        """Read all fp-matching KV objects in one batch; return the match.

        Returns (slot_off, slot_val, obj, stale).  ``stale`` means some
        candidate's fingerprint matched but the object did not verify
        (invalidated / freed / overwritten concurrently) — the index should
        be re-read rather than concluding the key is absent (RACE §data-
        access integrity check: key + CRC validate every read).
        """
        if not cands:
            return None, None, None, False
        verbs = [self._read_obj_verb(L.slot_ptr(v), L.slot_size_class(v))
                 for (_, v) in cands]
        res = yield Phase(verbs, label="2:read_kv", cause=cause)
        stale = False
        for (off_v, raw) in zip(cands, res):
            if raw is None:
                stale = True
                continue
            obj = L.parse_object(list(raw))
            if obj["key"] == key and obj["used"] and not obj["invalid"] and obj["crc_ok"]:
                return off_v[0], off_v[1], obj, False
            if obj["key"] != key and obj["used"] and obj["crc_ok"]:
                # a *different* key's live object behind a matching 8-bit
                # fingerprint: a permanent collision, not staleness —
                # retrying the index read would spin forever (at fleet key
                # counts fp collisions are routine, and treating them as
                # stale starves the op into a spurious FULL)
                continue
            stale = True  # mid-write / freed / invalidated: re-read helps
        return None, None, None, stale

    # ------------------------------------------------------------- SEARCH
    def op_search(self, key: int):
        rtts = [0]
        region = self._index_region(key)
        ce = self.cache.get(key) if self.enable_cache else None
        use_cache = (ce is not None
                     and ce.invalid_ratio <= self.cache_threshold
                     and self._cache_fresh(ce, region))
        if ce is not None:
            ce.access += 1
        obs = self.pool._obs
        if obs is not None:
            obs.heat_key64(key)      # buffered; hashed vectorized at flush
        if use_cache:
            # 1 RTT fast path: read the cached slot + the cached KV in parallel
            sv = ce.slot_val
            verbs = [Verb("read", region=region, replica=0,
                          off=ce.slot_off, n=1),
                     self._read_obj_verb(L.slot_ptr(sv), L.slot_size_class(sv))]
            res = yield Phase(verbs, label="1:cached_read")
            if res[0] is not None and res[1] is not None:
                cur_slot = int(res[0][0])
                obj = L.parse_object(list(res[1]))
                if (cur_slot == int(sv) and obj["key"] == key and obj["used"]
                        and not obj["invalid"] and obj["crc_ok"]):
                    return OpResult(OK, value=obj["value"], rtts=1)
                ce.invalid += 1
                if cur_slot != 0 and L.slot_fp(cur_slot) == L.fingerprint(key):
                    # slot moved: fetch the new object (read amplification!)
                    res2 = yield Phase([self._read_obj_verb(
                        L.slot_ptr(cur_slot), L.slot_size_class(cur_slot))],
                        label="2:read_kv")
                    if res2[0] is not None:
                        obj2 = L.parse_object(list(res2[0]))
                        if obj2["key"] == key and obj2["used"] and obj2["crc_ok"]:
                            ce.slot_val = cur_slot
                            return OpResult(OK, value=obj2["value"], rtts=2)
            # fall through to the miss path
        cause = CAUSE_NONE
        for _attempt in range(8):
            out = yield from self._read_index_for(key, [], cause=cause)
            buckets, base_offs, _ = out
            if buckets is None:
                return (yield from self._search_degraded(key))
            cands = self._locate(key, buckets, base_offs)
            slot_off, slot_val, obj, stale = yield from self._verify_candidates(
                key, cands, cause=cause)
            cause = CAUSE_FP_COLLISION   # only stale re-reads loop back here
            if obj is not None:
                if self.enable_cache:
                    e = self.cache.setdefault(key, CacheEntry(slot_off, slot_val))
                    e.slot_off, e.slot_val = slot_off, slot_val
                    e.region, e.shard_ver = region, self._shard_ver(region)
                return OpResult(OK, value=obj["value"], rtts=2)
            if not stale:
                return OpResult(NOT_FOUND, rtts=2)
        return OpResult(NOT_FOUND, rtts=2)

    def op_search_batch(self, items):
        """Vectorized cache-resident SEARCH: one doorbell batch reads the
        cached slot + cached KV object of *every* key in ``items`` — the
        whole batch costs 1 RTT instead of 1-2 RTTs per key.

        ``items`` is a list of ``(key, slot_off, slot_val)`` picked by the
        API layer (core/api.py) from this client's index cache via the
        race_lookup kernel.  Per-key validation is identical to the cached
        fast path of ``op_search``: the slot must still hold the cached
        value and the object must verify (key + used + !invalid + CRC).
        Keys that fail validation are reported as misses — the caller
        falls back to individual ``op_search`` ops for them.

        Returns ``OpResult(OK, value=[(status|None, value|None), ...])``
        aligned with ``items``; ``None`` status = fall back.
        """
        verbs = []
        for (key, slot_off, slot_val) in items:
            verbs.append(Verb("read", region=self._index_region(key),
                              replica=0, off=slot_off, n=1))
            verbs.append(self._read_obj_verb(L.slot_ptr(slot_val),
                                             L.slot_size_class(slot_val)))
        res = yield Phase(verbs, label="1:batch_cached_read")
        out = []
        for i, (key, slot_off, slot_val) in enumerate(items):
            ce = self.cache.get(key)
            if ce is not None:
                ce.access += 1
            slot_raw, kv_raw = res[2 * i], res[2 * i + 1]
            hit = False
            if slot_raw is not None and kv_raw is not None:
                cur_slot = int(slot_raw[0])
                obj = L.parse_object(list(kv_raw))
                if (cur_slot == int(slot_val) and obj["key"] == key
                        and obj["used"] and not obj["invalid"]
                        and obj["crc_ok"]):
                    out.append((OK, obj["value"]))
                    hit = True
            if not hit:
                if ce is not None:
                    ce.invalid += 1
                out.append((None, None))
        return OpResult(OK, value=out, rtts=1)

    def _search_degraded(self, key: int):
        """§5.2 READ when the primary read failed: read all replicas of
        the key's shard; if they agree, use that value; otherwise ask the
        master.

        Every replica returning FAIL does NOT mean the key is absent — it
        almost always means the lease epoch moved mid-flight (MN recovery
        or a migration cutover committed between issue and execution, and
        several can land back-to-back during a scale-out), so the phase
        is re-issued under the committed epoch rather than concluding
        NOT_FOUND for a key that exists."""
        cfg = self.cfg
        region = self._index_region(key)
        b1, b2 = race.bucket_pair(key, cfg.index_buckets)
        offs = [race.bucket_off(b1, cfg.slots_per_bucket),
                race.bucket_off(b2, cfg.slots_per_bucket)]
        attempts = 0
        cause = CAUSE_STALE_EPOCH   # entered because the primary read failed
        while True:
            attempts += 1
            r = len(self.pool.placement[region])  # re-read: may change
            verbs = [Verb("read", region=region, replica=i, off=o,
                          n=cfg.slots_per_bucket)
                     for o in offs for i in range(r)]
            res = yield Phase(verbs, label="deg:read_all", cause=cause)
            per_bucket, bounced = {}, False
            for j, o in enumerate(offs):
                reps = [res[j * r + i] for i in range(r)]
                alive = [list(x) for x in reps if x is not None]
                if not alive:
                    bounced = True
                    break
                if all(a == alive[0] for a in alive):
                    per_bucket[o] = alive[0]
                else:
                    ans = yield MasterCall("bucket_query",
                                           payload=dict(off=o, region=region))
                    per_bucket[o] = list(ans)
            if bounced:
                if attempts > MAX_OP_RETRIES:
                    # genuinely unreachable (> r-1 failures): best effort
                    return OpResult(NOT_FOUND, rtts=2)
                yield MasterCall("fail_report", payload=dict(cid=self.cid))
                yield Phase([], label="wait_membership",
                            cause=CAUSE_STALE_EPOCH)
                cause = CAUSE_STALE_EPOCH
                continue
            buckets = [per_bucket[offs[0]], per_bucket[offs[1]]]
            cands = self._locate(key, buckets, offs)
            slot_off, slot_val, obj, stale = \
                yield from self._verify_candidates(key, cands, cause=cause)
            if obj is None:
                if stale and attempts <= MAX_OP_RETRIES:
                    cause = CAUSE_FP_COLLISION
                    continue             # mid-write / bounced object read
                return OpResult(NOT_FOUND, rtts=3)
            return OpResult(OK, value=obj["value"], rtts=3)

    # ----------------------------------------------------------- write ops
    def _prepare_object(self, key: int, value, opcode: int):
        """Allocate + build the object (log entry embedded). No verbs yet."""
        vlen = len(value)
        sc = L.size_class_for(L.obj_words_needed(vlen))
        st = yield from self._ensure_free(sc)
        if st == FULL:
            return None
        ptr, next_ptr, prev_ptr = self._take_obj(sc)
        words, sc2 = L.build_object(key, value, next_ptr, prev_ptr, opcode)
        assert sc2 == sc  # lint: allow-assert (hot path; both derive from vlen)
        self._pending_mid = words[len(words) - 2]
        return ptr, sc, prev_ptr, words

    def op_insert(self, key: int, value):
        prep = yield from self._prepare_object(key, value, L.OPCODE_INSERT)
        if prep is None:
            return OpResult(FULL)
        ptr, sc, prev_ptr, words = prep
        fp = L.fingerprint(key)
        region = self._index_region(key)
        v_new = int(L.pack_slot(fp, sc, ptr))
        retries = 0
        cause = CAUSE_NONE
        while True:
            # Phase 1: write KV (all replicas) + read both index buckets
            out = yield from self._read_index_for(
                key, self._write_obj_verbs(ptr, words), cause=cause)
            buckets, base_offs, wres = out
            if buckets is None or any(w is None for w in wres):
                # index read or an object-replica write bounced: a dead MN
                # (crash-stop) or a stale lease epoch (membership change /
                # migration cutover committed mid-phase).  Acking with a
                # replica hole would lose the write on the next re-homing
                # — report, wait for the membership commit, start over.
                yield MasterCall("fail_report", payload=dict(cid=self.cid))
                yield Phase([], label="wait_membership",
                            cause=CAUSE_STALE_EPOCH)
                cause = CAUSE_STALE_EPOCH
                continue
            # duplicate key?  -> treat as racing UPDATE on the existing slot
            cands = self._locate(key, buckets, base_offs)
            target = None
            v_old = 0
            if cands:
                slot_off2, slot_val2, obj2, stale = \
                    yield from self._verify_candidates(key, cands, cause=cause)
                if obj2 is not None:
                    target, v_old = slot_off2, slot_val2
                elif stale:
                    retries += 1
                    if retries > MAX_OP_RETRIES:
                        return OpResult(FULL)
                    cause = CAUSE_FP_COLLISION
                    continue
            if target is None:
                empty = None
                for wordsb, base in zip(buckets, base_offs):
                    empty = race.find_empty(wordsb, base)
                    if empty is not None:
                        break
                if empty is None:
                    return OpResult(FULL)
                target, v_old = empty, 0
            status, rule, fin = yield from self._snapshot_write(
                region, target, v_old, v_new, ptr, sc, prev_ptr, cause=cause)
            if status == "RETRY":
                retries += 1
                if retries > MAX_OP_RETRIES:
                    return OpResult(FULL)
                cause = CAUSE_CAS_LOST
                continue
            if status != OK:
                return OpResult(status, rule=rule)
            if v_old == 0 and rule in (LOSE, FINISH, "MASTER_LOSE"):
                # Lost an *empty-slot* race: the winner may have inserted a
                # DIFFERENT key there, so returning OK would acknowledge a
                # write that is nowhere in the index.  Retry from the top
                # (RACE insert retry): the index re-read either finds our
                # key (a same-key racer won -> upsert that slot) or a fresh
                # empty slot; the object words are rewritten first, since
                # the loser path reset our used bit.
                retries += 1
                if retries > MAX_OP_RETRIES:
                    return OpResult(FULL)
                cause = CAUSE_CAS_LOST
                continue
            bg = []
            if rule in (R1, R2, R3, "MASTER_WIN", "CR") and v_old != 0 \
                    and L.slot_ptr(v_old) != ptr:
                # v_old pointing at our OWN object means an epoch-bounced
                # retry re-observed its half-installed value (the cutover
                # repair adopts backups): there is no old object to free —
                # freeing would unlink the object the slot now references.
                bg += self._free_obj_verbs(v_old)          # free overwritten obj
                bg += self._mark_invalid_verbs(v_old)      # cache invalidation
            if bg:
                yield from self._bg_cleanup(bg, "bg:free_old")
            if self.enable_cache:
                self.cache[key] = CacheEntry(target, v_new, access=1,
                                             region=region,
                                             shard_ver=self._shard_ver(region))
            if self.pool.ordered_regions:
                # ordered keydir maintenance BEFORE the ack: a committed
                # key must be scan-visible (core/ordered.py contract)
                if (yield from ordered.ord_ensure(self, key)) == FULL:
                    self.ord_full_drops += 1
            return OpResult(OK, rule=rule)

    def op_update(self, key: int, value):
        prep = yield from self._prepare_object(key, value, L.OPCODE_UPDATE)
        if prep is None:
            return OpResult(FULL)
        ptr, sc, prev_ptr, words = prep
        fp = L.fingerprint(key)
        region = self._index_region(key)
        v_new = int(L.pack_slot(fp, sc, ptr))
        retries = 0
        ce = self.cache.get(key) if self.enable_cache else None
        use_cache = (ce is not None
                     and ce.invalid_ratio <= self.cache_threshold
                     and self._cache_fresh(ce, region))
        if ce is not None:
            ce.access += 1
        obs = self.pool._obs
        if obs is not None:
            obs.heat_key64(key)      # buffered; hashed vectorized at flush
        cause = CAUSE_NONE
        while True:
            target = v_old = None
            if use_cache and retries == 0:
                sv = ce.slot_val
                verbs = (self._write_obj_verbs(ptr, words)
                         + [Verb("read", region=region, replica=0,
                                 off=ce.slot_off, n=1),
                            self._read_obj_verb(L.slot_ptr(sv), L.slot_size_class(sv))])
                res = yield Phase(verbs, label="1:write+cached_read",
                                  cause=cause)
                nrep = self._obj_region_replicas(L.ptr_region(ptr))
                if any(w is None for w in res[:nrep]):
                    # an object-replica write bounced (dead MN / stale
                    # epoch): never ack with a replica hole — see op_insert
                    yield MasterCall("fail_report", payload=dict(cid=self.cid))
                    yield Phase([], label="wait_membership",
                                cause=CAUSE_STALE_EPOCH)
                    cause = CAUSE_STALE_EPOCH
                    continue
                slot_raw, kv_raw = res[nrep], res[nrep + 1]
                if slot_raw is not None and kv_raw is not None:
                    cur = int(slot_raw[0])
                    obj = L.parse_object(list(kv_raw))
                    if cur == int(sv) and obj["key"] == key and obj["used"] and obj["crc_ok"]:
                        target, v_old = ce.slot_off, cur
                    else:
                        ce.invalid += 1
                        if (cur != 0 and L.slot_fp(cur) == fp):
                            # slot changed but fp still ours: verify new object
                            r2 = yield Phase([self._read_obj_verb(
                                L.slot_ptr(cur), L.slot_size_class(cur))],
                                label="2:read_kv")
                            if r2[0] is not None:
                                o2 = L.parse_object(list(r2[0]))
                                if o2["key"] == key and o2["used"] and o2["crc_ok"]:
                                    target, v_old = ce.slot_off, cur
                elif slot_raw is None:
                    yield MasterCall("fail_report", payload=dict(cid=self.cid))
                    yield Phase([], label="wait_membership",
                                cause=CAUSE_STALE_EPOCH)
                    cause = CAUSE_STALE_EPOCH
                    continue
            if target is None:
                extra = self._write_obj_verbs(ptr, words) if (not use_cache or retries > 0) else []
                out = yield from self._read_index_for(key, extra, cause=cause)
                buckets, base_offs, wres = out
                if buckets is None or any(w is None for w in wres):
                    yield MasterCall("fail_report", payload=dict(cid=self.cid))
                    yield Phase([], label="wait_membership",
                                cause=CAUSE_STALE_EPOCH)
                    cause = CAUSE_STALE_EPOCH
                    continue
                cands = self._locate(key, buckets, base_offs)
                slot_off2, slot_val2, obj2, stale = \
                    yield from self._verify_candidates(key, cands, cause=cause)
                if obj2 is None:
                    if stale:
                        retries += 1
                        use_cache = False
                        if retries > MAX_OP_RETRIES:
                            return OpResult(FULL)
                        cause = CAUSE_FP_COLLISION
                        continue
                    yield from self._bg_cleanup(
                        self._reset_used_verbs(ptr, sc, prev_ptr),
                        "abort_reset")
                    return OpResult(NOT_FOUND)
                target, v_old = slot_off2, slot_val2
            status, rule, fin = yield from self._snapshot_write(
                region, target, v_old, v_new, ptr, sc, prev_ptr, cause=cause)
            if status == "RETRY":
                retries += 1
                use_cache = False
                if retries > MAX_OP_RETRIES:
                    return OpResult(FULL)
                cause = CAUSE_CAS_LOST
                continue
            if status != OK:
                return OpResult(status, rule=rule)
            bg = []
            if rule in (R1, R2, R3, "MASTER_WIN", "CR") \
                    and L.slot_ptr(v_old) != ptr:
                # same own-object guard as op_insert: an epoch-bounced retry
                # can re-observe its own half-installed value as v_old
                bg += self._free_obj_verbs(v_old)
                bg += self._mark_invalid_verbs(v_old)
            if bg:
                yield from self._bg_cleanup(bg, "bg:free_old")
            if self.enable_cache:
                e = self.cache.setdefault(key, CacheEntry(target, v_new))
                e.slot_off, e.slot_val = target, v_new
                e.region, e.shard_ver = region, self._shard_ver(region)
            return OpResult(OK, rule=rule)

    def op_delete(self, key: int):
        # §4.5: DELETE allocates a temporary object recording the log entry +
        # target key, reclaimed when the request finishes.
        prep = yield from self._prepare_object(key, [], L.OPCODE_DELETE)
        if prep is None:
            return OpResult(FULL)
        ptr, sc, prev_ptr, words = prep
        region = self._index_region(key)
        retries = 0
        cause = CAUSE_NONE
        while True:
            out = yield from self._read_index_for(
                key, self._write_obj_verbs(ptr, words), cause=cause)
            buckets, base_offs, wres = out
            if buckets is None or any(w is None for w in wres):
                yield MasterCall("fail_report", payload=dict(cid=self.cid))
                yield Phase([], label="wait_membership",
                            cause=CAUSE_STALE_EPOCH)
                cause = CAUSE_STALE_EPOCH
                continue
            cands = self._locate(key, buckets, base_offs)
            slot_off2, slot_val2, obj2, stale = \
                yield from self._verify_candidates(key, cands, cause=cause)
            if obj2 is None:
                if stale:
                    retries += 1
                    if retries > MAX_OP_RETRIES:
                        return OpResult(FULL)
                    cause = CAUSE_FP_COLLISION
                    continue
                yield from self._bg_cleanup(
                    self._reset_used_verbs(ptr, sc, prev_ptr),
                    "abort_reset")
                return OpResult(NOT_FOUND)
            status, rule, fin = yield from self._snapshot_write(
                region, slot_off2, slot_val2, 0, ptr, sc, prev_ptr,
                cause=cause)
            if status == "RETRY":
                retries += 1
                if retries > MAX_OP_RETRIES:
                    return OpResult(FULL)
                cause = CAUSE_CAS_LOST
                continue
            if status != OK:
                return OpResult(status, rule=rule)
            bg = []
            if rule in (R1, R2, R3, "MASTER_WIN", "CR"):
                bg += self._free_obj_verbs(slot_val2)
                bg += self._mark_invalid_verbs(slot_val2)
            # reclaim the temp DELETE object (free + reset used)
            own_slotval = int(L.pack_slot(L.fingerprint(key), sc, ptr))
            bg += self._free_obj_verbs(own_slotval)
            bg += self._reset_used_verbs(ptr, sc, prev_ptr)
            yield from self._bg_cleanup(bg, "bg:del_cleanup")
            self.cache.pop(key, None)
            if self.pool.ordered_regions:
                # clear the keydir entry (re-checks RACE: a racing
                # re-insert that committed gets its entry re-ensured)
                yield from ordered.ord_clear(self, key)
            return OpResult(OK, rule=rule)

    # --------------------------------------------------- owner-side reclaim
    def op_reclaim(self):
        """Background task (§4.4): scan free bitmaps of owned blocks, reclaim
        freed objects into local FIFO free lists, reset their used bits."""
        reclaimed = 0
        for sc, st in list(self.slab.items()):
            scw = L.size_class_words(sc)
            for (region, blk) in st.blocks:
                bmoff = self.pool.bitmap_base(blk)
                res = yield Phase([Verb("read", region=region, replica=0,
                                        off=bmoff, n=self.cfg.bitmap_words)],
                                  label="bg:read_bitmap", background=True)
                if res[0] is None:
                    continue
                bm = list(res[0])
                base = self.pool.block_base(blk)
                clear_verbs = []
                for w_i, w in enumerate(bm):
                    w = int(w)
                    while w:
                        bit = (w & -w).bit_length() - 1
                        w &= w - 1
                        obj_idx = w_i * 64 + bit
                        off = base + (obj_idx * L.MIN_OBJ_WORDS)
                        if (off - base) % scw != 0:
                            continue  # bit granularity finer than this class
                        ptr = self._ptr_of(region, off)
                        st.free.append(ptr)
                        reclaimed += 1
                        delta = 1 << (obj_idx % 64)
                        for i in range(self._obj_region_replicas(region)):
                            clear_verbs.append(Verb("faa", region=region,
                                                    replica=i, off=bmoff + w_i,
                                                    delta=-delta))
                        tail = int(L.pack_log_tail(0, used=False))
                        for i in range(self._obj_region_replicas(region)):
                            clear_verbs.append(Verb("write", region=region,
                                                    replica=i,
                                                    off=off + scw - 1,
                                                    words=[tail]))
                if clear_verbs:
                    yield Phase(clear_verbs, label="bg:reclaim", background=True)
        return OpResult(OK, value=[reclaimed])

    # ----------------------------------------------------- ordered scans
    def op_scan(self, start: int, count: int, *, hint: int = -1,
                batched: bool = True):
        """SCAN(start_key, count) over the ordered keydir (core/ordered.py):
        the next ``count`` live keys >= start in key order, values fetched
        and validated through the RACE index in batched phases."""
        return ordered.op_scan(self, start, count, hint=hint,
                               batched=batched)

    def op_range(self, start: int, end: int, *, hint: int = -1,
                 batched: bool = True):
        """RANGE(start, end): every live key in [start, end) with its
        value, in key order."""
        return ordered.op_range(self, start, end, hint=hint,
                                batched=batched)
