"""Online hot-key / skew monitor: the sensor layer for load-driven index
placement (FlexKV-style bucket migration).

Three streaming estimators, all batch-vectorized and fully deterministic
(integer counts + fixed-point milli gauges — same-seed runs produce
byte-identical registry snapshots):

* ``SpaceSaving`` — the Metwally et al. top-k heavy-hitter sketch over
  the fold32 key stream the heat sketch already sees (client cached-path
  touches + probe-wave keys).  Batched: one ``np.unique`` per flush,
  hits folded with one scatter-add, misses merged in mergeable-summaries
  form (candidate count = current min + batch count, err = min, keep the
  top-``capacity``), preserving the per-item algorithm's guarantee
  ``true_count <= count <= true_count + err`` even when one flush batch
  carries more distinct misses than the sketch has slots.  Deterministic
  tie-breaks: (count desc, key asc) for both survival and reporting.
* ``zipf_theta`` — an online zipf-θ estimate: least-squares slope of
  ``log(count)`` vs ``log(rank)`` over the monitor's top-k.  Contract:
  the estimate describes the **head** of the distribution (the monitored
  keys), needs a saturated monitor (>= 8 live counters) to report, and
  is exact only when the head really is zipfian — uniform workloads
  report ~0, planted zipf(0.99) converges to ~0.99 within a couple
  thousand ticks (acceptance-tested).
* ``HotKeyMonitor`` — glues both to an EWMA per-shard / per-MN imbalance
  score (max-share over mean-share of settled-op load) and a two-state
  regime machine (``uniform`` <-> ``skewed``) with hysteresis; crossings
  emit typed ``regime`` events into the flight ring (obs/flight.py
  ``EV_REGIME``) — the hook adaptive index offloading will consume.

Counterpart of the JAX package's ``obs/hotspot.py`` (plain numpy).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["SpaceSaving", "zipf_theta", "HotKeyMonitor"]


class SpaceSaving:
    """Batched space-saving top-k over an int key stream.

    Monitored set is kept key-sorted so batch membership is one
    ``searchsorted``; eviction keeps the per-item error bound by
    inheriting the evicted counter (err = evicted count).
    """

    def __init__(self, capacity: int = 128):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self.keys = np.zeros(0, np.int64)      # sorted ascending
        self.counts = np.zeros(0, np.int64)
        self.errs = np.zeros(0, np.int64)
        self.n_seen = 0                        # stream length folded so far

    def update(self, keys) -> None:
        """Fold a batch of keys (any int array) — one unique + one merge."""
        keys = np.asarray(keys)
        if keys.size == 0:
            return
        keys = keys.astype(np.int64, copy=False).ravel()
        self.n_seen += len(keys)
        uk, uc = np.unique(keys, return_counts=True)
        if len(self.keys):
            pos = np.searchsorted(self.keys, uk)
            posc = np.minimum(pos, len(self.keys) - 1)
            hit = self.keys[posc] == uk
            if hit.any():
                self.counts[posc[hit]] += uc[hit]
            uk, uc = uk[~hit], uc[~hit]
        if len(uk) == 0:
            return
        # largest incoming first; deterministic (count desc, key asc)
        order = np.lexsort((uk, -uc))
        uk, uc = uk[order], uc[order]
        free = self.capacity - len(self.keys)
        if free > 0:
            take = min(free, len(uk))
            self.keys = np.concatenate([self.keys, uk[:take]])
            self.counts = np.concatenate([self.counts, uc[:take]])
            self.errs = np.concatenate([self.errs,
                                        np.zeros(take, np.int64)])
            uk, uc = uk[take:], uc[take:]
        if len(uk):
            # Merge step (mergeable-summaries form of space-saving): every
            # miss enters with count = min + its batch count and err = min
            # (min is the inherited floor any evicted key could have had),
            # then only the top-``capacity`` by count survive.  Unlike
            # evicting ``len(uk)`` victims outright, this keeps the
            # guarantee for batches with more distinct misses than
            # capacity: an established heavy hitter can only be displaced
            # by a candidate whose (floor + batch) count actually beats it.
            minc = int(self.counts.min()) if len(self.counts) else 0
            cand_k = np.concatenate([self.keys, uk])
            cand_c = np.concatenate([self.counts, uc + minc])
            cand_e = np.concatenate([self.errs,
                                     np.full(len(uk), minc, np.int64)])
            keep = np.lexsort((cand_k, -cand_c))[:self.capacity]
            self.keys, self.counts, self.errs = \
                cand_k[keep], cand_c[keep], cand_e[keep]
        order = np.argsort(self.keys, kind="stable")
        self.keys = self.keys[order]
        self.counts = self.counts[order]
        self.errs = self.errs[order]

    def top(self, k: Optional[int] = None) -> List[Tuple[int, int, int]]:
        """``[(key, count, err), ...]`` by count descending (key asc ties)."""
        order = np.lexsort((self.keys, -self.counts))
        if k is not None:
            order = order[:k]
        return [(int(self.keys[i]), int(self.counts[i]), int(self.errs[i]))
                for i in order]


def zipf_theta(counts) -> float:
    """Least-squares zipf-θ over rank/count pairs (counts sorted desc).

    Returns 0.0 when fewer than 8 positive counts (an unsaturated head
    cannot be fit honestly).  θ is clamped to [0, 4] — beyond that the
    head is effectively a single key and the slope is noise."""
    c = np.asarray(counts, np.float64)
    c = c[c > 0]
    if len(c) < 8:
        return 0.0
    c = np.sort(c)[::-1]
    x = np.log(np.arange(1, len(c) + 1, dtype=np.float64))
    y = np.log(c)
    xm, ym = x.mean(), y.mean()
    denom = ((x - xm) ** 2).sum()
    if denom <= 0.0:
        return 0.0
    theta = -float(((x - xm) * (y - ym)).sum() / denom)
    return min(max(theta, 0.0), 4.0)


def _imbalance(ewma: np.ndarray) -> float:
    """max-share / mean-share over dimensions that have seen load."""
    live = ewma[ewma > 0]
    if len(live) < 2:
        return 1.0
    return float(live.max() / live.mean())


class HotKeyMonitor:
    """Streaming skew sensor; see module docstring.

    ``observe_keys`` takes fold32 keys (the heat-stream vocabulary);
    ``observe_load`` takes the per-settle shard/MN id arrays the obs hub
    already computes; ``evaluate`` refreshes θ/imbalance and returns a
    regime-transition dict (or None) for the caller to record.
    """

    def __init__(self, *, top_k: int = 32, capacity: int = 128,
                 alpha: float = 0.2, theta_hi: float = 0.6,
                 imb_hi: float = 2.0, imb_lo: float = 1.4):
        self.top_k = int(top_k)
        self.sketch = SpaceSaving(max(int(capacity), self.top_k))
        self.alpha = float(alpha)
        self.theta_hi = float(theta_hi)
        self.imb_hi = float(imb_hi)
        self.imb_lo = float(imb_lo)
        self._shard_ewma = np.zeros(0, np.float64)
        self._mn_ewma = np.zeros(0, np.float64)
        self.theta = 0.0
        self.regime = "uniform"
        self.flips = 0

    # ---------------------------------------------------------- ingest ---
    def observe_keys(self, keys32) -> None:
        self.sketch.update(keys32)

    def _fold_dim(self, ewma: np.ndarray, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return ewma
        hi = int(ids.max()) + 1
        if hi > len(ewma):
            ewma = np.concatenate([ewma, np.zeros(hi - len(ewma))])
        ewma *= (1.0 - self.alpha)
        cnt = np.bincount(ids, minlength=len(ewma)).astype(np.float64)
        ewma += self.alpha * cnt
        return ewma

    def observe_load(self, shards, mns) -> None:
        """One settle batch's shard/MN attribution (one EWMA step each)."""
        self._shard_ewma = self._fold_dim(self._shard_ewma, shards)
        self._mn_ewma = self._fold_dim(self._mn_ewma, mns)

    # -------------------------------------------------------- evaluate ---
    @property
    def shard_imbalance(self) -> float:
        return _imbalance(self._shard_ewma)

    @property
    def mn_imbalance(self) -> float:
        return _imbalance(self._mn_ewma)

    def evaluate(self) -> Optional[Dict]:
        """Refresh θ and the regime state machine.  Returns a transition
        event dict on a crossing (hysteresis: enter ``skewed`` above
        ``theta_hi`` OR ``imb_hi``, leave below BOTH ``theta_hi`` and
        ``imb_lo``), else None."""
        counts = np.sort(self.sketch.counts)[::-1][:self.sketch.capacity]
        self.theta = zipf_theta(counts)
        imb = max(self.shard_imbalance, self.mn_imbalance)
        new = self.regime
        if self.regime == "uniform":
            if self.theta > self.theta_hi or imb > self.imb_hi:
                new = "skewed"
        else:
            if self.theta <= self.theta_hi and imb < self.imb_lo:
                new = "uniform"
        if new == self.regime:
            return None
        self.regime = new
        self.flips += 1
        return {"regime": new, "theta_milli": int(round(self.theta * 1000)),
                "imbalance_milli": int(round(imb * 1000))}

    # -------------------------------------------------------- reporting --
    def snapshot(self) -> Dict:
        """Deterministic (int-valued) summary for ``cluster.metrics()`` /
        ``kv.stats()``; same-seed runs produce identical dicts."""
        return {
            "top": [list(t) for t in self.sketch.top(self.top_k)],
            "keys_seen": self.sketch.n_seen,
            "theta_milli": int(round(self.theta * 1000)),
            "shard_imbalance_milli":
                int(round(self.shard_imbalance * 1000)),
            "mn_imbalance_milli": int(round(self.mn_imbalance * 1000)),
            "regime": self.regime,
            "regime_flips": self.flips,
        }
