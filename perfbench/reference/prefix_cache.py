"""A plain model of the serving pool's prefix cache: which prompt blocks
must be hits, and which must be findable after a run.

A prompt is cut into blocks of 64 tokens; a block's key is a rolling
hash over the block numbers and every 7th token of the blocks up to it
(the serving engine's prefix identity, written out again here).  Every
admission of a group of requests first looks all their keys up, then
inserts the misses: so a request's hits are its keys present before its
group was admitted, and after the group every key of its requests that
did not fail is present.  Nothing is ever evicted.  It imports nothing of
the program.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np

BLOCK = 64


def block_keys(prompt: np.ndarray) -> List[int]:
    out, h = [], 1469598103
    for b in range(len(prompt) // BLOCK):
        blk = prompt[b * BLOCK:(b + 1) * BLOCK]
        for x in (b, *(int(t) for t in blk[::7])):
            h = ((h ^ x) * 1099511628211) & 0x7FFFFFFF
        out.append(h)
    return out


class PrefixCache:
    """The keys present, replayed over the admissions in their order."""

    def __init__(self):
        self.present: Dict[int, None] = {}

    def admit(self, prompts: Sequence[np.ndarray],
              failed: Iterable[bool]) -> List[List[int]]:
        """The keys each prompt of one admitted group must miss, in block
        order (its other keys are its hits); then the keys of the group's
        prompts that did not fail become present."""
        keys = [block_keys(p) for p in prompts]
        misses = [[k for k in ks if k not in self.present] for ks in keys]
        for ks, bad in zip(keys, failed):
            if not bad:
                self.present.update(dict.fromkeys(ks))
        return misses
