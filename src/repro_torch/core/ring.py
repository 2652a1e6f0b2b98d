"""Epoch-versioned placement directory: the pinned region -> MN map.

FUSEE consistent-hashes regions onto MNs (FaRM-style, §4.4), but *where a
region lives* must never be an implicit function of the current alive
list: recomputing the ring on every call silently re-homes every region
the instant an MN dies — before Alg-3 recovery has copied a single byte —
so reads chase replicas that do not exist and acknowledged writes become
unreachable.  ``PlacementDirectory`` pins placement explicitly:

* ``place()`` computes a region's replica set from the *membership ring*
  (the committed member list, not the alive list) exactly once and pins
  it in the table;
* the ONLY mutation paths are ``rehome()`` (Alg-3 MN recovery and the
  migration engine's cutover, core/migrate.py) and membership changes
  (``add_member`` / ``remove_member``);
* every rehome bumps the region's **version** and the directory
  generation.  Clients key their per-shard index caches by these
  versions, and the pool's lease ``epoch`` (bumped by the master at each
  membership/cutover commit, §5.2) invalidates in-flight verbs — the
  same stale-epoch FAIL-and-retry guard as MN recovery.

Index shards are placed with an explicit per-shard stride on the ring so
``S`` shards spread across ``min(S, N)`` MNs even when hashes collide —
the whole point of sharding the RACE table is that its CAS hot words and
probe traffic no longer all land on the same r MNs.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from . import layout as L

__all__ = ["PlacementDirectory", "ring_replicas"]


def ring_replicas(region_id: int, members: List[int], r: int,
                  *, start: Optional[int] = None) -> List[int]:
    """Consistent hashing: region -> r successive members on the ring.

    Pure function of ``(region_id, members, r)`` — callers pin the result
    in a ``PlacementDirectory``; nothing recomputes it against an alive
    list.  ``start`` overrides the hash start (index-shard striding)."""
    if start is None:
        start = L.hash64(region_id, seed=3) % len(members)
    r = min(r, len(members))
    return [members[(start + i) % len(members)] for i in range(r)]


class PlacementDirectory:
    """Pinned, version-tracked region placement (see module docstring)."""

    def __init__(self, replication: int, members: List[int]):
        self.replication = replication
        self.members: List[int] = list(members)       # committed membership
        self.table: Dict[int, List[int]] = {}         # region -> [mid, ...]
        self.versions: Dict[int, int] = {}            # region -> rehome count
        self.gen = 0                                  # total mutations

    # ------------------------------------------------------------ placement
    def place(self, region: int, *, start: Optional[int] = None) -> List[int]:
        """Pin a fresh region's replica set (ring hash over *members*)."""
        reps = ring_replicas(region, self.members, self.replication,
                             start=start)
        self.table[region] = reps
        self.versions[region] = 0
        return reps

    def pin(self, region: int, reps: List[int]) -> List[int]:
        """Pin an explicit replica set for a fresh region (e.g. data
        regions primaried on a just-added MN)."""
        self.table[region] = list(reps)
        self.versions[region] = 0
        return self.table[region]

    def replicas(self, region: int) -> List[int]:
        return self.table[region]

    def primary(self, region: int) -> int:
        return self.table[region][0]

    def version(self, region: int) -> int:
        """Rehome count of ``region`` — the per-shard epoch clients key
        their index-cache entries by."""
        return self.versions.get(region, 0)

    # ------------------------------------------------------------ mutation
    def rehome(self, region: int, new_reps: List[int]):
        """Move a region to a new replica set.  The ONLY placement
        mutation path besides membership bookkeeping — called by Alg-3 MN
        recovery and by the migration engine's cutover, never by the data
        path."""
        self.table[region] = list(new_reps)
        self.versions[region] = self.versions.get(region, 0) + 1
        self.gen += 1

    def add_member(self, mid: int):
        if mid not in self.members:
            self.members.append(mid)
            self.gen += 1

    def remove_member(self, mid: int):
        if mid in self.members:
            self.members.remove(mid)
            self.gen += 1
