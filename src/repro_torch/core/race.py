"""RACE-hashing index math (Zuo et al., ATC'21), as used by FUSEE §4.2.

The index is an array of combined buckets, each holding ``slots_per_bucket``
8-byte slots.  A key hashes to two candidate buckets (h1, h2); slots hold
``fp | size_class | pointer`` (layout.py).  The index lives in a dedicated
replicated region (heap.INDEX_REGION); a slot's address is its word offset,
identical in every replica — which is what lets SNAPSHOT CAS "the same slot"
on r MNs.

Deterministic slot choice: INSERT always targets the first empty slot of h1,
then h2 ("earliest candidate first").  Concurrent same-key inserts therefore
usually race on the *same* slot and are resolved by SNAPSHOT; the residual
cross-bucket duplicate case is handled by the post-insert re-read + canonical
dedup (smallest slot offset survives), mirroring RACE's insert check.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from . import layout as L


def bucket_pair(key: int, n_buckets: int) -> Tuple[int, int]:
    b1 = L.hash64(key, seed=1) % n_buckets
    b2 = L.hash64(key, seed=2) % n_buckets
    if b2 == b1:
        b2 = (b1 + 1) % n_buckets
    return b1, b2


def bucket_off(bucket: int, slots_per_bucket: int) -> int:
    return bucket * slots_per_bucket


def slot_offsets(key: int, n_buckets: int, slots_per_bucket: int) -> List[int]:
    """All candidate slot word-offsets for a key (both buckets, in order)."""
    b1, b2 = bucket_pair(key, n_buckets)
    offs = [bucket_off(b1, slots_per_bucket) + i for i in range(slots_per_bucket)]
    offs += [bucket_off(b2, slots_per_bucket) + i for i in range(slots_per_bucket)]
    return offs


def find_matches(bucket_words, base_off: int, fp: int) -> List[Tuple[int, int]]:
    """(slot_off, slot_value) for every non-empty slot with matching fp."""
    out = []
    for i, w in enumerate(bucket_words):
        if not L.is_empty(w) and L.slot_fp(w) == fp:
            out.append((base_off + i, int(w)))
    return out


def find_empty(bucket_words, base_off: int) -> Optional[int]:
    for i, w in enumerate(bucket_words):
        if L.is_empty(w):
            return base_off + i
    return None
