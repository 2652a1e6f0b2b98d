"""The comparison that decides ``correct``, on what the timed path made.

* The served tokens: for a sample of the requests the window finished
  (drawn from the seed across the engine's slots), the plain float32
  reference runs once over each prompt with its served tokens; the
  number compared is the widest gap by which a served token's logit lies
  below the reference's best at its position (``logit_gap``).
* The pool: every admission of the engine is replayed through the plain
  prefix-cache model.  Each request's prefix hits must be the model's
  (``prefix_hits_wrong``), each must hold a page for every key it missed
  (``acks_missing``), every key an acknowledged insert wrote must be
  found again through the store with the page its insert acknowledged
  (``pages_lost``), no two keys may share a page (``pages_shared``), and
  the index replicas must agree slot for slot (``replica_slots_diverged``).
* Every finished request holds exactly the tokens it asked for
  (``requests_wrong_length``).

The exact comparisons have the limit 0; ``logit_gap``'s limit is the
cell's, in ``limits/<cell>.json``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference.decoder import Decoder
from .reference.prefix_cache import PrefixCache


def request_failed(req) -> bool:
    """The pool answered FULL: a page it could not grant (-1), or an
    insert that lost its slot."""
    return bool((req.pages is not None and (np.asarray(req.pages) < 0).any())
                or (req.surplus is not None and len(req.surplus)))


def pool_numbers(engine, admits: Sequence[Sequence]) -> Dict[str, int]:
    """The pool's comparisons (see the module docstring); ``admits`` are
    the engine's admitted groups in their order, from its first."""
    from repro_torch.core.api import Op
    from repro_torch.core.events import OK
    model = PrefixCache()
    wrong_hits = missing = 0
    acked: Dict[int, int] = {}
    for group in admits:
        failed = [request_failed(r) for r in group]
        misses = model.admit([r.prompt for r in group], failed)
        for r, ms, bad in zip(group, misses, failed):
            blocks = len(r.prompt) // 64
            wrong_hits += int(r.prefix_hits != blocks - len(ms))
            if bad:
                continue
            pages = [] if r.pages is None else [int(p) for p in r.pages]
            if len(pages) != len(ms):
                missing += 1
                continue
            for key, page in zip(ms, pages):
                acked.setdefault(key, page)
    keys = sorted(acked)
    lost = 0
    if keys:
        res = [f.result() for f in
               engine.store.submit_batch([Op.get(k) for k in keys])]
        lost = sum(r.status != OK or r.page != acked[k]
                   for k, r in zip(keys, res))
    idx = engine.pool.index.cpu().numpy()
    return {"prefix_hits_wrong": wrong_hits,
            "acks_missing": missing,
            "pages_lost": int(lost),
            "pages_shared": len(acked) - len(set(acked.values())),
            "replica_slots_diverged": int((idx[1:] != idx[:1]).any(0).sum())}


def _sequences(sample) -> tuple:
    """Each request's prompt with its served tokens but the last, and the
    positions whose logits predict the served tokens."""
    seqs, want = [], []
    for r in sample:
        p, out = len(r.prompt), list(r.out)
        seqs.append(np.concatenate([r.prompt, np.asarray(out[:-1],
                                                         np.int32)]))
        want.append(range(p - 1, p - 1 + len(out)))
    return seqs, want


def _gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far below each row's best the logit of ``tokens`` lies; a
    token outside the vocabulary lies infinitely far."""
    V = ref.shape[1]
    inside = tokens < V
    got = ref.gather(1, tokens.clamp(max=V - 1)[:, None])[:, 0]
    gap = ref.max(dim=1).values - got
    return torch.where(inside, gap, torch.full_like(gap, float("inf")))


def logit_gap(cfg: Dict, weights: Dict, sample: List,
              control: bool = False) -> Dict[str, float]:
    """The widest gap of the sample's served tokens under the float32
    reference.  With ``control``, the fp8 reference is put in the
    program's place: the tokens judged are those it puts first at the
    served positions (on the same prompts and served tokens), and the
    served tokens' own gap is returned as ``served_gap``."""
    seqs, want = _sequences(sample)
    ref = Decoder(cfg, weights).logits(seqs, want)
    dev = ref[0].device
    judged = [torch.as_tensor(np.asarray(r.out, np.int64), device=dev)
              for r in sample]
    out = {"tokens_compared": sum(len(t) for t in judged)}
    if control:
        out["served_gap"] = _widest(ref, judged)
        if dev.type == "cuda":      # the float32 pass's freed blocks
            torch.cuda.empty_cache()
        low = Decoder(cfg, weights, "fp8").logits(seqs, want)
        judged = [c.argmax(dim=1) for c in low]
    out["logit_gap"] = _widest(ref, judged)
    return out


def _widest(ref: List[torch.Tensor], tokens: List[torch.Tensor]) -> float:
    return float(max(_gaps(lg, t).max() for lg, t in zip(ref, tokens)))
