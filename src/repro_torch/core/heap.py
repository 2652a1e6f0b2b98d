"""The disaggregated-memory pool: passive memory nodes + one-sided verbs,
with every hosted region copy in one device-resident int64 slab.

Counterpart of the JAX package's ``core/heap.py`` with the same semantics
(§2.1 of the paper): READ / WRITE / CAS / FAA at 8-byte-word atomicity plus
the compute-light ALLOC/FREE RPC of the MN's weak cores; a verb addressed to
a crashed MN returns None (crash-stop, §5.1); placement is pinned in an
epoch-versioned ``PlacementDirectory``.

Device contract
---------------
* ``RegionSlab.buf`` is ONE contiguous ``int64`` tensor on the pool's
  ``device``; each ``MemoryNode.regions[g]`` is a view of one region-sized
  cell, re-bound when the slab grows.  Words are stored as 64-bit two's
  complement bit patterns of the protocol's unsigned words.
* Everything handed back to host protocol code is unsigned: READs return
  ``np.uint64`` arrays, CAS/FAA return ``np.uint64`` scalars — exactly the
  reference's types, so op histories agree on words >= 2^63 and ``FAIL``.
* ``DMPool(device=None)`` means ``"cuda"`` and raises where no GPU is
  present; the CPU is used only when the caller passes ``device="cpu"``.
* ``exec_fused_tick`` moves a tick's coordinates and values to the device
  in one copy, runs the READ sweep through the ``fleet_read`` kernel and
  the WRITE/CAS/FAA sweeps as tensor scatters, and brings every result back
  in one copy: the kernel and the CAS/FAA gathers write one reused device
  staging buffer, whose used prefix comes back through a pinned mirror
  with one non-blocking copy and one sync, into a fresh host array per
  tick.  Same-word CAS/FAA races (rare) cost one extra round trip.
* ``DMConfig(ordered_index=True)`` adds the ordered keydir's region
  (core/ordered.py) after the index shards, placed and migrated like them.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import chain
from typing import Dict, List, Optional

import numpy as np
import torch

from . import layout as L
from .ring import PlacementDirectory, ring_replicas
from .staging import Staging
from ..kernels.fleet_tick.ops import fleet_read_tick

_M64 = 0xFFFF_FFFF_FFFF_FFFF


def resolve_device(device=None) -> torch.device:
    """The pool's device: ``None`` means CUDA, and no GPU is an error —
    the port never falls back to the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device (torch.cuda.is_available() is "
            "False); pass device='cpu' to run on the CPU explicitly")
    return dev


# ---------------------------------------------------------- word conversion
def to_signed(v: int) -> int:
    """Unsigned 64-bit word -> the int64 bit pattern stored in the slab."""
    v = int(v) & _M64
    return v - (1 << 64) if v >> 63 else v


def as_i64_bits(vals) -> np.ndarray:
    """Word values (uint64/int64 arrays or int lists, masked to 64 bits) as
    an int64 bit-pattern array."""
    if isinstance(vals, np.ndarray) and vals.dtype in (np.uint64, np.int64):
        return vals.view(np.int64)
    try:
        return np.asarray(vals, np.uint64).view(np.int64)
    except (OverflowError, TypeError, ValueError):
        return np.array([to_signed(v) for v in vals], np.int64)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """Host copy of slab words as the protocol's unsigned words."""
    return t.to("cpu", copy=True).numpy().view(np.uint64)


def get_word(mem: torch.Tensor, off: int) -> int:
    """One slab word as an unsigned Python int (a device sync on CUDA)."""
    return int(mem[off].item()) & _M64


def set_word(mem: torch.Tensor, off: int, value: int):
    mem[off] = to_signed(value)


def _i64_tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.int64)).to(device)


def _last_wins(addrs: np.ndarray, vals: np.ndarray):
    """Resolve duplicate scatter addresses explicitly: the value that comes
    LAST in array order wins (numpy's assignment order; a CUDA scatter with
    duplicate indices has no defined winner)."""
    u, first_in_rev = np.unique(addrs[::-1], return_index=True)
    return u, vals[::-1][first_in_rev]


def _putter(host: List[np.ndarray]):
    """Appender of int64 pieces to ``host`` (one host-to-device copy later);
    each call returns the slice its piece will occupy."""
    def put(arr) -> slice:
        start = sum(map(len, host))
        host.append(np.ascontiguousarray(arr, np.int64))
        return slice(start, start + len(arr))
    return put


def _words(plan, reads: bool = False) -> int:
    """Result words a planned sweep stages: the READ sweep's gathered
    words, or one old value per vectorized CAS/FAA verb."""
    if plan is None or plan[1] is None:
        return 0
    return int(plan[1][1][-1]) if reads else len(plan[1][0])


def _split_dups(addr: np.ndarray, li: np.ndarray):
    """Split live verbs into words touched once (vectorizable) and words
    touched by several verbs (serialized in input order)."""
    sa = np.sort(addr[li])
    if not (sa[1:] == sa[:-1]).any():
        return li, li[:0]
    _u, inv, counts = np.unique(addr[li], return_inverse=True,
                                return_counts=True)
    dup = counts[inv] > 1
    return li[~dup], li[dup]


@dataclass
class DMConfig:
    num_mns: int = 4
    replication: int = 2            # r: data + index replication factor
    region_words: int = 1 << 14     # scaled-down 2 GB region
    block_words: int = 1 << 9       # scaled-down 16 MB block
    regions_per_mn: int = 8         # primary regions initially owned per MN
    index_buckets: int = 256        # RACE: combined-bucket count (power of 2)
    slots_per_bucket: int = 7
    size_classes: int = 6
    index_shards: int = 1           # S: independent RACE shard regions
    # Ordered secondary index (core/ordered.py): a replicated keydir of
    # fat leaves in its own region, enabling SCAN/RANGE.  Off by default —
    # the classic layout and per-op RTT counts are bit-identical.
    ordered_index: bool = False

    @property
    def blocks_per_region(self) -> int:
        # one BAT word per block, bitmap ahead of each block's payload
        return self.region_words // (self.block_words + 1)

    @property
    def bat_words(self) -> int:
        return self.blocks_per_region

    @property
    def bitmap_words(self) -> int:
        max_objs = self.block_words // L.MIN_OBJ_WORDS
        return (max_objs + 63) // 64

    @property
    def block_payload_words(self) -> int:
        return self.block_words - self.bitmap_words

    @property
    def index_words(self) -> int:
        return self.index_buckets * self.slots_per_bucket


INDEX_REGION = 0   # replicated hash-index region (shard 0; extra shards get
                   # their own region ids after the initial data regions)
META_REGION = 1    # per-client metadata (per-size-class list heads)
FIRST_DATA_REGION = 2
SHARD_HASH_SEED = 11   # key -> index shard (pure hash, never placement)

META_WORDS_PER_CLIENT = 64  # sc list heads + scratch

# BAT owner tag for blocks surrendered by a gracefully-removed client:
# nonzero (never re-allocated by the MN) and above any cid+1, so a later
# holder of a reused cid never inherits them; their live objects stay
# readable through the index.
BAT_ORPHAN = 1 << 32


class RegionSlab:
    """Flat device backing store for every hosted region copy.

    One contiguous int64 tensor carved into region-sized *cells*; each
    ``MemoryNode.regions[g]`` entry is a view of one cell, so per-region
    code addresses its copy directly while the fused tick addresses the
    whole tick against the single buffer with **global word addresses**
    (``cell * region_words + offset``).

    Growth doubles the buffer and re-binds every registered node's views;
    nothing outside ``MemoryNode.regions`` may hold a cell view across a
    carve."""

    def __init__(self, region_words: int, capacity: int = 8,
                 device: torch.device = torch.device("cpu")):
        self.region_words = region_words
        self.capacity = max(1, capacity)
        self.device = device
        self.buf = torch.zeros(self.capacity * region_words,
                               dtype=torch.int64, device=device)
        # free cells, descending, so pop() hands out the lowest cell first
        self._free = list(range(self.capacity - 1, -1, -1))
        self.cells: Dict[tuple, int] = {}      # (mid, region) -> cell
        self._nodes: List["MemoryNode"] = []   # rebind targets on growth
        self.gen = 0        # bumped on carve/release: cell-map version

    def register(self, mn: "MemoryNode"):
        self._nodes.append(mn)

    def view(self, cell: int) -> torch.Tensor:
        rw = self.region_words
        return self.buf[cell * rw:(cell + 1) * rw]

    def carve(self, mid: int, region: int) -> torch.Tensor:
        """Allocate (and zero) a cell for one region copy."""
        if not self._free:
            self._grow()
        cell = self._free.pop()
        self.cells[(mid, region)] = cell
        self.gen += 1
        v = self.view(cell)
        v.zero_()
        return v

    def release(self, mid: int, region: int):
        cell = self.cells.pop((mid, region), None)
        if cell is not None:
            self._free.append(cell)
            self.gen += 1

    def _grow(self):
        old_cap = self.capacity
        self.capacity = old_cap * 2
        buf = torch.zeros(self.capacity * self.region_words,
                          dtype=torch.int64, device=self.device)
        buf[:self.buf.numel()] = self.buf
        self.buf = buf
        self._free.extend(range(self.capacity - 1, old_cap - 1, -1))
        self.rebind()

    def rebind(self):
        """Point every registered node's region views at the current
        buffer."""
        for mn in self._nodes:
            for (mid, region), cell in self.cells.items():
                if mid == mn.mid and region in mn.regions:
                    mn.regions[region] = self.view(cell)


class MemoryNode:
    """A passive memory node.  Owns replica copies of regions."""

    def __init__(self, mid: int, cfg: DMConfig, slab: RegionSlab):
        self.mid = mid
        self.cfg = cfg
        self.alive = True
        self.retired = False            # gracefully removed (not crashed)
        self.regions: Dict[int, torch.Tensor] = {}
        self._slab = slab               # pool-shared flat backing store
        # MN-side coarse allocation cursor per primary region (compute-light)
        self.alloc_cursor: Dict[int, int] = {}
        self.cpu_ops = 0  # number of MN-CPU operations served (for netmodel)
        slab.register(self)

    def host_region(self, region_id: int):
        self.regions[region_id] = self._slab.carve(self.mid, region_id)

    def drop_region(self, region_id: int):
        if self.regions.pop(region_id, None) is not None:
            self._slab.release(self.mid, region_id)


class DMPool:
    """The full memory pool + placement. Verbs are synchronous and atomic."""

    def __init__(self, cfg: DMConfig, num_clients: int = 64, seed: int = 0,
                 *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_clients = num_clients
        # flat backing store for every hosted region copy (fused tick
        # substrate); sized for the initial placement, grows by doubling
        r_eff = min(cfg.replication, cfg.num_mns)
        init_cells = (cfg.num_mns * cfg.regions_per_mn + 1
                      + cfg.index_shards + int(cfg.ordered_index)) * r_eff
        self.slab = RegionSlab(cfg.region_words, capacity=init_cells + 2,
                               device=self.device)
        self.mns = [MemoryNode(i, cfg, self.slab) for i in range(cfg.num_mns)]
        self.epoch = 0
        # pinned, epoch-versioned region -> ordered MN list (replica 0 =
        # primary); mutated ONLY by recovery/migration (ring.py)
        self.directory = PlacementDirectory(cfg.replication,
                                            list(range(cfg.num_mns)))
        # regions undergoing live migration: region -> migrate.RegionMigration
        # (writes to the primary replica are mirrored into the targets —
        # the dual-write window of the shard migration state machine)
        self.migrations: Dict[int, object] = {}
        self._place_initial(seed)
        # traffic accounting (bytes in+out per MN) for the network model;
        # a host array — liveness and placement are host facts
        self.mn_bytes = np.zeros(cfg.num_mns, dtype=np.int64)
        # verb tracer (repro_torch.analysis.trace) — None unless attached;
        # the tracer installs instance-attribute wrappers over the verb
        # entry points.  Observability hub (repro_torch.obs.ClusterObs) —
        # None unless attached (FuseeCluster attaches one by default).
        self._tracer = None
        self._obs = None
        # fused-tick (region, replica) -> (cell, mid) lookup table, cached
        # until the topology token changes (see _fused_cells)
        self._fused_lut = None
        self._alive_gen = 0     # bumped whenever an MN leaves the pool
        # a tick's results (READ words, then CAS and FAA old values) are
        # staged in one device buffer and come back in one copy through its
        # pinned host mirror
        self._stage = Staging(self.device)

    # ---------------- placement -------------------------------------------
    @property
    def placement(self) -> Dict[int, List[int]]:
        """The pinned placement table (read-only view; mutate through
        ``directory.rehome`` / ``recover_mn_placement`` only)."""
        return self.directory.table

    def _place_initial(self, seed: int):
        cfg = self.cfg
        data_count = cfg.num_mns * cfg.regions_per_mn
        self.data_regions: List[int] = list(
            range(FIRST_DATA_REGION, FIRST_DATA_REGION + data_count))
        # extra index shards live after the initial data regions so the
        # S=1 layout is bit-identical to the classic single-table one
        self.index_regions: List[int] = [INDEX_REGION] + [
            FIRST_DATA_REGION + data_count + i
            for i in range(cfg.index_shards - 1)]
        self.index_region_set = frozenset(self.index_regions)
        self.num_regions = FIRST_DATA_REGION + data_count \
            + (cfg.index_shards - 1)
        # the ordered keydir region (core/ordered.py) lives after the
        # index shards; strided on the ring like them, first-class for
        # migration/recovery.  Absent entirely when ordered_index=False.
        self.ordered_regions: List[int] = []
        if cfg.ordered_index:
            self.ordered_regions = [self.num_regions]
            self.num_regions += 1
        self.ordered_region_set = frozenset(self.ordered_regions)
        shard_placement = self.desired_index_placement()
        for g in range(FIRST_DATA_REGION, FIRST_DATA_REGION + data_count):
            self._host_all(g, self.directory.place(g))
        self._host_all(META_REGION, self.directory.place(META_REGION))
        for g in self.index_regions + self.ordered_regions:
            self._host_all(g, self.directory.pin(g, shard_placement[g]))
        if self.ordered_regions:
            from . import ordered                 # local: layering, no cycle
            ordered.init_region(self, self.ordered_regions[0])

    def _host_all(self, region: int, reps: List[int]):
        for mid in reps:
            if region not in self.mns[mid].regions:
                self.mns[mid].host_region(region)

    def desired_index_placement(self) -> Dict[int, List[int]]:
        """Where the index shards — and the ordered keydir region —
        should live on the current membership ring: shard 0 at the classic
        hash start (S=1 layout unchanged), shard s offset by s so S shards
        spread over min(S, N) MNs; the ordered region continues the stride
        after the shards."""
        members = self.directory.members
        n = len(members)
        start0 = L.hash64(INDEX_REGION, seed=3) % n
        return {g: ring_replicas(g, members, self.cfg.replication,
                                 start=(start0 + s) % n)
                for s, g in enumerate(self.index_regions
                                      + self.ordered_regions)}

    # ---------------- key -> shard routing ---------------------------------
    @property
    def num_shards(self) -> int:
        return len(self.index_regions)

    def shard_of(self, key: int) -> int:
        """Index shard of a key: a pure key hash, independent of placement
        (re-homing a shard never re-shards keys)."""
        if len(self.index_regions) == 1:
            return 0
        return L.hash64(key, seed=SHARD_HASH_SEED) % len(self.index_regions)

    def index_region_of(self, key: int) -> int:
        return self.index_regions[self.shard_of(key)]

    def replicas(self, region_id: int) -> List[int]:
        return self.directory.table[region_id]

    def primary_mn(self, region_id: int) -> int:
        return self.directory.table[region_id][0]

    def data_regions_of_mn(self, mid: int) -> List[int]:
        return [g for g in self.data_regions
                if self.directory.table[g][0] == mid]

    # ---------------- elastic membership (migration engine hooks) ----------
    def add_node(self) -> int:
        """Register a fresh (empty) MN and commit it to the membership
        ring.  Region placement does NOT change here — the migration
        engine re-homes shards and grants the node fresh data regions."""
        mid = len(self.mns)
        self.mns.append(MemoryNode(mid, self.cfg, self.slab))
        self.mn_bytes = np.concatenate(
            [self.mn_bytes, np.zeros(1, np.int64)])
        self.directory.add_member(mid)
        return mid

    def add_data_regions(self, mid: int, count: Optional[int] = None
                         ) -> List[int]:
        """Grant ``count`` fresh data regions primaried on ``mid`` (ring
        successors as backups).  Fresh regions are empty, so no copy or
        dual-write window is needed — they are pinned and hosted at once."""
        cfg = self.cfg
        count = cfg.regions_per_mn if count is None else count
        members = self.directory.members
        pos = members.index(mid)
        r = min(cfg.replication, len(members))
        new: List[int] = []
        for _ in range(count):
            g = self.num_regions
            self.num_regions += 1
            reps = [members[(pos + i) % len(members)] for i in range(r)]
            self.directory.pin(g, reps)
            for m in reps:
                self.mns[m].host_region(g)
            self.data_regions.append(g)
            new.append(g)
        return new

    def retire_node(self, mid: int):
        """Finalize a graceful remove_mn: the node hosts no regions (the
        migration engine has re-homed them all) and leaves membership.
        Retired is distinct from crashed — Alg-3 must not run."""
        mn = self.mns[mid]
        if mn.regions:
            from .faults import ProtocolViolation  # local: faults->master->client->heap cycle
            raise ProtocolViolation(
                f"retire_node({mid}) while it still hosts regions "
                f"{sorted(mn.regions)}: drain (migrate) them first")
        mn.retired = True
        mn.alive = False
        self._alive_gen += 1
        self.directory.remove_member(mid)

    # ---------------- dual-write mirroring (live migration) ----------------
    def _mirror(self, region: int, replica: int, off: int, n: int,
                mem: torch.Tensor):
        """Dual-write window: mutations applied to the *primary* replica of
        a migrating region are mirrored into every migration target copy,
        so a write racing the bulk copy is never lost."""
        if replica != 0:
            return
        mig = self.migrations.get(region)
        if mig is None:
            return
        src = mem[off:off + n]
        for mid, arr in mig.targets.items():
            arr[off:off + n] = src
            self.mn_bytes[mid] += n * L.WORD

    def _mirror_idx(self, region: int, replica: int, idx: np.ndarray,
                    mem: torch.Tensor):
        """Batched-verb twin of ``_mirror``: mirror an index array of
        just-mutated words into the migration targets (byte accounting
        counts every index, repeats included)."""
        if replica != 0:
            return
        mig = self.migrations.get(region)
        if mig is None:
            return
        it = _i64_tensor(np.ravel(idx), self.device)
        src = mem[it]
        for mid, arr in mig.targets.items():
            arr[it] = src
            self.mn_bytes[mid] += idx.size * L.WORD

    # ---------------- state import ------------------------------------------
    def load_numpy_state(self, slab_words: np.ndarray,
                         cells: Dict[tuple, int],
                         placement: Dict[int, List[int]], *,
                         alive: Optional[List[bool]] = None,
                         members: Optional[List[int]] = None,
                         epoch: Optional[int] = None,
                         mn_bytes: Optional[np.ndarray] = None,
                         versions: Optional[Dict[int, int]] = None,
                         ordered_regions: Optional[List[int]] = None):
        """Rebuild this pool's memory from plain host state: the flat slab
        words (uint64 or int64, ``capacity * region_words`` of them), the
        ``(mid, region) -> cell`` map, the region -> replica-list placement
        and, optionally, MN liveness, the committed ring membership, the
        lease epoch, per-MN byte counters and per-region placement
        versions.  The config must match the one the state was taken
        under (``ordered_regions``, when given, is checked against it: the
        ordered keydir — cursor, leaves — travels in the slab words); the
        slab lands on this pool's device."""
        rw = self.cfg.region_words
        if ordered_regions is not None \
                and list(ordered_regions) != self.ordered_regions:
            raise ValueError(f"state has ordered regions "
                             f"{list(ordered_regions)}, this pool's config "
                             f"gives {self.ordered_regions}")
        words = np.ascontiguousarray(slab_words).view(np.int64)
        if words.size % rw:
            raise ValueError(f"slab of {words.size} words is not a whole "
                             f"number of {rw}-word cells")
        slab = self.slab
        slab.capacity = words.size // rw
        slab.buf = torch.from_numpy(words.copy()).to(self.device)
        slab.cells = {tuple(k): int(c) for k, c in cells.items()}
        used = set(slab.cells.values())
        slab._free = [c for c in range(slab.capacity - 1, -1, -1)
                      if c not in used]
        slab.gen += 1
        for mn in self.mns:
            mn.regions = {}
        for (mid, region), cell in slab.cells.items():
            self.mns[mid].regions[region] = slab.view(cell)
        self.directory.table = {int(g): list(map(int, reps))
                                for g, reps in placement.items()}
        if versions is not None:
            self.directory.versions = {int(g): int(v)
                                       for g, v in versions.items()}
        self.directory.gen += 1
        if members is not None:
            self.directory.members = list(map(int, members))
        if alive is not None:
            for mn, a in zip(self.mns, alive):
                mn.alive = bool(a)
            self._alive_gen += 1
        if epoch is not None:
            self.epoch = int(epoch)
        if mn_bytes is not None:
            self.mn_bytes = np.array(mn_bytes, np.int64)
        self._fused_lut = None

    # ---------------- verbs -------------------------------------------------
    def _mem(self, region: int, replica: int) -> Optional[torch.Tensor]:
        reps = self.placement.get(region)
        if reps is None or replica >= len(reps):
            return None
        mn = self.mns[reps[replica]]
        if not mn.alive:
            return None
        return mn.regions.get(region)

    def read(self, region: int, replica: int, off: int, n: int):
        mem = self._mem(region, replica)
        if mem is None:
            return None  # FAIL
        self.mn_bytes[self.placement[region][replica]] += n * L.WORD
        return to_u64(mem[off:off + n])

    def write(self, region: int, replica: int, off: int, words) -> bool:
        mem = self._mem(region, replica)
        if mem is None:
            return False
        w = as_i64_bits([int(x) & _M64 for x in words])
        if len(w):
            mem[off:off + len(w)] = _i64_tensor(w, self.device)
        self.mn_bytes[self.placement[region][replica]] += len(w) * L.WORD
        self._mirror(region, replica, off, len(w), mem)
        return True

    def cas(self, region: int, replica: int, off: int, exp: int, new: int):
        """Atomic compare-and-swap; returns the *old* value (RDMA semantics)."""
        mem = self._mem(region, replica)
        if mem is None:
            return None
        old = get_word(mem, off)
        if old == int(exp) & _M64:
            set_word(mem, off, new)
            self._mirror(region, replica, off, 1, mem)
        self.mn_bytes[self.placement[region][replica]] += 2 * L.WORD
        return np.uint64(old)

    def faa(self, region: int, replica: int, off: int, delta: int):
        mem = self._mem(region, replica)
        if mem is None:
            return None
        old = get_word(mem, off)
        set_word(mem, off, old + int(delta))
        self._mirror(region, replica, off, 1, mem)
        self.mn_bytes[self.placement[region][replica]] += 2 * L.WORD
        return np.uint64(old)

    # ---------------- batched verbs (the migration-window path) -------------
    # Element-wise identical to the scalar verbs above.  The fleet engine
    # runs these while a migration's dual-write window is open (the WRITE/
    # CAS/FAA twins mirror into the targets); the migration engine's bulk
    # copy reads through read_batch.  READ is the fused tick's READ sweep on
    # its own — one fleet_read launch — and needs no mirroring.

    def read_batch(self, regions, replicas, offs, ns) -> list:
        """Vectorized READ: one ``fleet_read`` launch over every live verb.
        Returns a list aligned with the inputs: a copy of the words per
        verb, or None where the target replica is dead (or ``n`` is 0)."""
        host: List[np.ndarray] = []
        plan = self._plan_reads(_putter(host), regions, replicas, offs, ns)
        n = _words(plan, reads=True)
        self._sweep_reads(plan, self._h2d(host), self._results(n))
        return self._fused_unpack_reads(plan, self._fetch(n), 0)[0]

    def write_batch(self, regions, replicas, offs, words_list) -> list:
        """Vectorized WRITE of per-verb word lists.  Overlapping writes
        within one batch land in a fixed deterministic order — groups in
        sorted (region, replica, length) order, input order within a group
        (the last writer of a word wins)."""
        regions = np.asarray(regions, np.int64)
        replicas = np.asarray(replicas, np.int64)
        offs = np.asarray(offs, np.int64)
        ns = np.array([len(w) for w in words_list], np.int64)
        out = [False] * len(regions)
        group = (regions << 36) | (replicas << 32) | ns
        for g in np.unique(group):
            sel = np.nonzero(group == g)[0]
            region, replica = int(regions[sel[0]]), int(replicas[sel[0]])
            n = int(ns[sel[0]])
            mem = self._mem(region, replica)
            if mem is None:
                continue
            if n:
                vals = as_i64_bits([int(x) & _M64 for i in sel
                                    for x in words_list[i]])
                idx = (offs[sel][:, None] + np.arange(n)).ravel()
                uidx, uvals = _last_wins(idx, vals)
                mem[_i64_tensor(uidx, self.device)] = \
                    _i64_tensor(uvals, self.device)
                self._mirror_idx(region, replica, idx, mem)
            self.mn_bytes[self.placement[region][replica]] += \
                n * len(sel) * L.WORD
            for i in sel:
                out[int(i)] = True
        return out

    def _atomic_batch(self, regions, replicas, offs, deltas=None, exps=None,
                      news=None) -> list:
        """Shared body of cas_batch (exps/news) and faa_batch (deltas):
        distinct words in one vectorized pass per (region, replica) group,
        same-word verbs serialized in input order."""
        regions = np.asarray(regions, np.int64)
        replicas = np.asarray(replicas, np.int64)
        offs = np.asarray(offs, np.int64)
        is_cas = deltas is None
        if is_cas:
            a_bits = as_i64_bits([int(e) & _M64 for e in exps])
            b_bits = as_i64_bits([int(v) & _M64 for v in news])
        else:
            a_bits = as_i64_bits([int(d) & _M64 for d in deltas])
        out: list = [None] * len(regions)
        group = (regions << 36) | replicas
        for g in np.unique(group):
            sel = np.nonzero(group == g)[0]
            region, replica = int(regions[sel[0]]), int(replicas[sel[0]])
            mem = self._mem(region, replica)
            if mem is None:
                continue
            o = offs[sel]
            if len(np.unique(o)) == len(o):          # conflict-free fast path
                ot = _i64_tensor(o, self.device)
                old = mem[ot]
                a = _i64_tensor(a_bits[sel], self.device)
                old_h = to_u64(old)
                if is_cas:
                    b = _i64_tensor(b_bits[sel], self.device)
                    mem[ot] = torch.where(old == a, b, old)
                    hit = old_h == a_bits[sel].view(np.uint64)
                    if hit.any():
                        self._mirror_idx(region, replica, o[hit], mem)
                else:
                    mem[ot] = old + a                # 64-bit wrap-around
                    self._mirror_idx(region, replica, o, mem)
                for k, v in zip(sel.tolist(), old_h):
                    out[k] = v
            else:                                    # same-word races
                for i in sel.tolist():
                    old = get_word(mem, int(offs[i]))
                    if is_cas:
                        if old == int(a_bits[i]) & _M64:
                            set_word(mem, int(offs[i]), int(b_bits[i]))
                            self._mirror(region, replica, int(offs[i]), 1,
                                         mem)
                    else:
                        set_word(mem, int(offs[i]), old + int(a_bits[i]))
                        self._mirror(region, replica, int(offs[i]), 1, mem)
                    out[i] = np.uint64(old)
            self.mn_bytes[self.placement[region][replica]] += \
                2 * len(sel) * L.WORD
        return out

    def cas_batch(self, regions, replicas, offs, exps, news) -> list:
        """Vectorized CAS; returns old values (RDMA semantics) or None.
        Verbs targeting the *same word* are serialized in input order."""
        return self._atomic_batch(regions, replicas, offs, exps=exps,
                                  news=news)

    def faa_batch(self, regions, replicas, offs, deltas) -> list:
        """Vectorized FAA; returns old values or None.  Same-word verbs
        accumulate in input order (each sees the running sum)."""
        return self._atomic_batch(regions, replicas, offs, deltas=deltas)

    # ---------------- fused tick (fleet megakernel substrate) --------------
    # One fleet tick's READ/WRITE/CAS/FAA sweeps against the flat device
    # slab with GLOBAL word addresses.  The host turns verb coordinates into
    # addresses (liveness and per-MN byte accounting are host facts, so the
    # lookup table stays on the host), ships every address and value in ONE
    # host-to-device copy, and receives every result in ONE copy back.

    def _fused_cells(self, regions: np.ndarray, replicas: np.ndarray):
        """Per-verb (cell, mid): the slab cell of the addressed replica copy
        and its MN id; cell -1 where the verb FAILs (dead/absent replica).

        Resolution is a dense (region, replica) lookup table, rebuilt only
        when the topology token changes: fresh regions always carve a cell
        (slab.gen), rehomes and membership changes bump directory.gen, and
        MNs are crash-stop (_alive_gen covers kills)."""
        tok = (self.slab.gen, self.directory.gen, self._alive_gen)
        lut = self._fused_lut
        if lut is None or lut[0] != tok:
            table = self.placement
            nr = (max(table) + 1) if table else 1
            nrep = max((len(r) for r in table.values()), default=1)
            cell_lut = np.full((nr, nrep), -1, np.int64)
            mid_lut = np.zeros((nr, nrep), np.int64)
            for region, reps in table.items():  # lint: allow-fused-loop (LUT rebuild — runs only on topology changes, not per tick)
                for replica, mid in enumerate(reps):  # lint: allow-fused-loop (LUT rebuild — bounded by the replication factor)
                    mn = self.mns[mid]
                    if not mn.alive or region not in mn.regions:
                        continue
                    cell = self.slab.cells.get((mid, region))
                    if cell is not None:
                        cell_lut[region, replica] = cell
                        mid_lut[region, replica] = mid
            lut = self._fused_lut = (tok, cell_lut, mid_lut)
        _tok, cell_lut, mid_lut = lut
        nr, nrep = cell_lut.shape
        if regions.size == 0 or (int(regions.max()) < nr
                                 and int(replicas.max()) < nrep):
            return cell_lut[regions, replicas], mid_lut[regions, replicas]
        ok = (regions < nr) & (replicas < nrep)
        rg = np.where(ok, regions, 0)
        rp = np.where(ok, replicas, 0)
        return (np.where(ok, cell_lut[rg, rp], -1),
                np.where(ok, mid_lut[rg, rp], 0))

    def _account(self, mids: np.ndarray, live: np.ndarray, words):
        self.mn_bytes += (np.bincount(
            mids[live], weights=words * L.WORD,
            minlength=self.mn_bytes.size)).astype(np.int64)

    def exec_fused_tick(self, reads=None, writes=None, cass=None, faas=None):
        """Execute one fleet tick's verb sweeps — READ, WRITE, CAS, FAA, in
        that order — against the flat slab.  Each argument is the
        positional-arg tuple of the corresponding ``*_batch`` twin (or
        None); ``writes`` may carry two extra trailing args (per-verb
        lengths + pre-flattened word values).  Returns the four result lists
        ``(read_out, write_out, cas_out, faa_out)``, element-wise identical
        to what the twins would return.

        During a live migration the dual-write mirror must observe every
        mutation, so the whole tick delegates to the (mirroring) twins."""
        if self.migrations:
            return (self.read_batch(*reads) if reads else [],
                    self.write_batch(*writes[:4]) if writes else [],
                    self.cas_batch(*cass) if cass else [],
                    self.faa_batch(*faas) if faas else [])
        flat = self.slab.buf
        host: List[np.ndarray] = []      # int64 pieces of the one H2D copy
        put = _putter(host)

        # ---- host planning: addresses, liveness, byte accounting ---------
        r_plan = w_plan = c_plan = f_plan = None
        if reads:
            r_plan = self._plan_reads(put, *reads)
        w_out: list = []
        if writes:
            w_out, w_plan = self._fused_plan_writes(put, *writes)
        if cass:
            c_plan = self._plan_atomic(put, cass[0], cass[1], cass[2],
                                       (cass[3], cass[4]))
        if faas:
            f_plan = self._plan_atomic(put, faas[0], faas[1], faas[2],
                                       (faas[3],))
        dbuf = self._h2d(host)

        # ---- device sweeps, in verb order, into the staging buffer --------
        n_r = _words(r_plan, reads=True)
        n_c = _words(c_plan)
        used = n_r + n_c + _words(f_plan)
        stage = self._results(used)
        self._sweep_reads(r_plan, dbuf, stage)
        if w_plan is not None:
            s_addr, s_vals = w_plan
            flat[dbuf[s_addr]] = dbuf[s_vals]
        c_res = self._fused_sweep_atomic(c_plan, dbuf, stage, n_r, cas=True)
        f_res = self._fused_sweep_atomic(f_plan, dbuf, stage, n_r + n_c,
                                         cas=False)
        res = self._fetch(used)

        # ---- split the results on the host ---------------------------------
        r_out, pos = self._fused_unpack_reads(r_plan, res, 0)
        c_out, pos = self._fused_unpack_atomic(c_plan, c_res, res, pos)
        f_out, pos = self._fused_unpack_atomic(f_plan, f_res, res, pos)
        return r_out, w_out, c_out, f_out

    def _results(self, n: int) -> torch.Tensor:
        """The device staging buffer of a sweep's results (>= n words)."""
        return self._stage.buffer(n)

    def _fetch(self, n: int) -> np.ndarray:
        """The first ``n`` staged words as the protocol's unsigned words, in
        a fresh host array (the rows handed out outlive the next tick,
        which overwrites the mirror)."""
        if n == 0:
            return np.zeros(0, np.uint64)
        return self._stage.download(n).view(np.uint64)

    def _h2d(self, host: List[np.ndarray]) -> torch.Tensor:
        """The one host-to-device copy of a sweep's int64 pieces."""
        if not host:
            return torch.empty(0, dtype=torch.int64, device=self.device)
        return _i64_tensor(np.concatenate(host), self.device)

    def _plan_reads(self, put, regions, replicas, offs, ns):
        """Host part of a READ sweep: the live verbs' global base addresses
        and the CSR offsets of their lengths, plus byte accounting.  Verbs
        on a dead/absent replica or of length 0 FAIL (None)."""
        regions, replicas, offs, ns = (np.asarray(a, np.int64)
                                       for a in (regions, replicas, offs, ns))
        cells, mids = self._fused_cells(regions, replicas)
        live = (cells >= 0) & (ns > 0)
        if not live.any():
            return (len(regions), None)
        self._account(mids, live, ns[live])
        sel = np.nonzero(live)[0]
        start = np.concatenate([[0], np.cumsum(ns[sel])])
        base = cells[sel] * self.slab.region_words + offs[sel]
        return (len(regions), (sel, start, put(base), put(start)))

    def _sweep_reads(self, plan, dbuf, stage):
        """Device part of a READ sweep: one ragged ``fleet_read`` launch
        that writes the words at the head of ``stage``.  The plan's
        coordinates are int64 slices of ``dbuf``, contiguous and on the
        slab's device by construction, so the launch checks nothing."""
        if plan is None or plan[1] is None:
            return
        _sel, start, s_base, s_start = plan[1]
        fleet_read_tick(self.slab.buf, dbuf, s_base, s_start, int(start[-1]),
                        stage, 0, self.device)

    @staticmethod
    def _fused_unpack_reads(plan, res, pos):
        """Split the flat gathered words into per-verb rows (views of
        ``res``), exactly as the reference's read sweep does."""
        if plan is None:
            return [], pos
        n_verbs, body = plan
        out: list = [None] * n_verbs
        if body is None:
            return out, pos
        sel, start = body[0], body[1]
        rows = res[pos:pos + int(start[-1])]
        for i, lo, hi in zip(sel.tolist(), start[:-1].tolist(),  # lint: allow-fused-loop (per-verb result unpack at the generator API boundary)
                             start[1:].tolist()):
            out[i] = rows[lo:hi]
        return out, pos + int(start[-1])

    def _fused_plan_writes(self, put, regions, replicas, offs, words_list,
                           ns=None, vals=None):
        regions = np.asarray(regions, np.int64)
        replicas = np.asarray(replicas, np.int64)
        offs = np.asarray(offs, np.int64)
        ns = (np.fromiter(map(len, words_list), np.int64,
                          count=len(words_list))
              if ns is None else np.asarray(ns, np.int64))
        cells, mids = self._fused_cells(regions, replicas)
        live = cells >= 0
        self._account(mids, live, ns[live])
        live_pos = live & (ns > 0)
        sel = np.nonzero(live_pos)[0]
        if not len(sel):
            return live.tolist(), None
        base = cells[sel] * self.slab.region_words + offs[sel]
        ln = ns[sel]
        ends = np.cumsum(ln)
        total = int(ends[-1])
        addrs = np.repeat(base, ln) + (np.arange(total)
                                       - np.repeat(ends - ln, ln))
        if vals is not None:
            bits = as_i64_bits(vals)
            if len(sel) != len(words_list):
                bits = bits[np.repeat(live_pos, ns)]
        else:
            rows = words_list if len(sel) == len(words_list) \
                else map(words_list.__getitem__, sel.tolist())
            try:
                bits = np.fromiter(chain.from_iterable(rows), np.uint64,
                                   count=total).view(np.int64)
            except (OverflowError, TypeError, ValueError):
                bits = np.fromiter((to_signed(x) for i in sel.tolist()
                                    for x in words_list[i]),
                                   np.int64, count=total)
        order = np.argsort(base, kind="stable")
        sb = base[order]
        if ((sb[:-1] + ln[order][:-1]) > sb[1:]).any():
            # overlapping same-tick writes: land them in write_batch's order
            # — (region, replica, length) groups sorted, input order within
            # a group — and let the last writer of each word win explicitly
            key = (regions[sel] << 36) | (replicas[sel] << 32) | ln
            verb_order = np.argsort(key, kind="stable")
            word_order = np.concatenate(
                [np.arange(s, e) for s, e in
                 zip((ends - ln)[verb_order].tolist(),
                     ends[verb_order].tolist())])
            addrs, bits = _last_wins(addrs[word_order], bits[word_order])
        return live.tolist(), (put(addrs), put(bits))

    def _plan_atomic(self, put, regions, replicas, offs, args):
        regions = np.asarray(regions, np.int64)
        replicas = np.asarray(replicas, np.int64)
        offs = np.asarray(offs, np.int64)
        bits = [as_i64_bits(a) for a in args]
        cells, mids = self._fused_cells(regions, replicas)
        live = cells >= 0
        if not live.any():
            return (len(regions), None)
        self.mn_bytes += np.bincount(
            mids[live], minlength=self.mn_bytes.size) * (2 * L.WORD)
        addr = cells * self.slab.region_words + offs
        vsel, dsel = _split_dups(addr, np.nonzero(live)[0])
        slices = [put(addr[vsel])] + [put(b[vsel]) for b in bits]
        return (len(regions), (vsel, dsel, addr, bits, slices))

    def _fused_sweep_atomic(self, plan, dbuf, stage, off, *, cas: bool):
        """Device part of the CAS (``cas``) or FAA sweep: one vectorized
        pass over words touched once, their old values gathered into
        ``stage`` at ``off``; words several verbs touch are serialized in
        input order on the host (one extra round trip, only in ticks that
        have such races).  Returns the host-resolved old values of the
        serialized verbs."""
        if plan is None or plan[1] is None:
            return {}
        vsel, dsel, addr, bits, slices = plan[1]
        flat = self.slab.buf
        if len(vsel):
            a = dbuf[slices[0]]
            old = torch.index_select(flat, 0, a,
                                     out=stage[off:off + len(vsel)])
            if cas:
                flat[a] = torch.where(old == dbuf[slices[1]],
                                      dbuf[slices[2]], old)
            else:
                flat[a] = old + dbuf[slices[1]]     # 64-bit wrap-around
        if not len(dsel):
            return {}
        words, inv = np.unique(addr[dsel], return_inverse=True)
        wt = _i64_tensor(words, self.device)
        cur = to_u64(flat[wt]).astype(object)
        res = {}
        for k, i in enumerate(dsel.tolist()):  # lint: allow-fused-loop (same-word CAS/FAA races are inherently sequential — input order, exactly like the batch verbs)
            w = int(inv[k])
            o = int(cur[w])
            if cas:
                if o == int(bits[0][i]) & _M64:
                    cur[w] = int(bits[1][i]) & _M64
            else:
                cur[w] = (o + int(bits[0][i])) & _M64
            res[i] = np.uint64(o)
        flat[wt] = _i64_tensor(as_i64_bits(list(cur)), self.device)
        return res

    @staticmethod
    def _fused_unpack_atomic(plan, dup_res, res, pos):
        if plan is None:
            return [], pos
        n_verbs, body = plan
        out: list = [None] * n_verbs
        if body is None:
            return out, pos
        vsel = body[0]
        old = res[pos:pos + len(vsel)]
        for i, o in zip(vsel.tolist(), old):  # lint: allow-fused-loop (per-verb result unpack at the generator API boundary)
            out[i] = o
        for i, o in dup_res.items():  # lint: allow-fused-loop (serialized same-word verbs)
            out[i] = o
        return out, pos + len(vsel)

    # ---------------- MN-side coarse allocation (ALLOC RPC, §4.4) ----------
    def alloc_block(self, mid: int, cid: int):
        """MN-side handler: grab a free block from one of this MN's primary
        regions, record CID in the BAT of *all* region replicas, return
        (region_id, block_idx).  Compute-light: a cursor bump + r BAT writes.
        """
        mn = self.mns[mid]
        if not mn.alive:
            return None
        cfg = self.cfg
        for g in self.data_regions_of_mn(mid):
            cur = mn.alloc_cursor.get(g, 0)
            if cur < cfg.blocks_per_region:
                # one host copy of the remaining BAT words, not one per block
                bat = to_u64(mn.regions[g][cur:cfg.blocks_per_region])
                free = np.nonzero(bat == 0)[0]
                if len(free):
                    cur += int(free[0])
                    for rep_idx, rep_mid in enumerate(self.placement[g]):
                        rep = self.mns[rep_mid]
                        if rep.alive and g in rep.regions:
                            set_word(rep.regions[g], cur, cid + 1)
                            self._mirror(g, rep_idx, cur, 1, rep.regions[g])
                    mn.alloc_cursor[g] = cur + 1
                    mn.cpu_ops += 1
                    return g, cur
                cur = cfg.blocks_per_region
            mn.alloc_cursor[g] = cur
        return None  # MN out of memory

    def free_block(self, mid: int, region: int, block_idx: int):
        mn = self.mns[mid]
        if not mn.alive:
            return False
        for rep_idx, rep_mid in enumerate(self.placement[region]):
            rep = self.mns[rep_mid]
            if rep.alive and region in rep.regions:
                set_word(rep.regions[region], block_idx, 0)
                self._mirror(region, rep_idx, block_idx, 1,
                             rep.regions[region])
        mn.cpu_ops += 1
        return True

    # ---------------- block geometry ---------------------------------------
    def block_base(self, block_idx: int) -> int:
        """Word offset of a block's payload (bitmap comes first)."""
        cfg = self.cfg
        return cfg.bat_words + block_idx * cfg.block_words + cfg.bitmap_words

    def bitmap_base(self, block_idx: int) -> int:
        cfg = self.cfg
        return cfg.bat_words + block_idx * cfg.block_words

    # ---------------- failure injection ------------------------------------
    def crash_mn(self, mid: int):
        self.mns[mid].alive = False
        self._alive_gen += 1

    def recover_mn_placement(self, region: int, new_replicas: List[int]):
        """Master-side: re-home a region on a new replica set (copies bytes
        device-to-device).  Goes through the directory — the pinned-placement
        mutation path."""
        src = None
        for mid in self.placement[region]:
            mn = self.mns[mid]
            if mn.alive and region in mn.regions:
                src = mn.regions[region]
                break
        if src is None:
            from .faults import RegionLost  # local: faults->master->client->heap cycle
            raise RegionLost(region,
                             f"old placement {self.placement[region]}, "
                             f"requested re-home to {new_replicas}")
        # snapshot before carving: a slab growth re-binds views, so the
        # source view must not be held across host_region
        snap = src.clone()
        for mid in new_replicas:
            mn = self.mns[mid]
            if region not in mn.regions:
                mn.host_region(region)
                mn.regions[region].copy_(snap)
        self.directory.rehome(region, list(new_replicas))
