"""Failure injection + straggler detection for the training loop.

At 1000-node scale, two failure classes dominate:
* hard failures (preemption, HBM ECC, host loss) — handled by
  checkpoint/restart (Trainer.run_with_recovery; identical to a real
  preemption: state is rebuilt from the last *committed* checkpoint and the
  deterministic data pipeline is fast-forwarded by step number);
* stragglers (thermal throttling, failing ICI links) — detected here by
  per-step wall-time against a rolling median; the deployment hook is to
  evict the slow host and re-shard (in this repo: recorded + surfaced).

The port's own copy of the JAX package's ``train/fault.py`` (which is
plain Python).
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


class SimulatedFailure(RuntimeError):
    """Raised by the fault drill to emulate a node loss mid-run."""

    def __init__(self, step: int):
        super().__init__(f"simulated node failure at step {step}")
        self.step = step


@dataclass
class StragglerWatchdog:
    factor: float = 3.0          # straggler = step > factor * rolling median
    window: int = 32
    times: List[float] = field(default_factory=list)
    flagged: List[Tuple[int, float, float]] = field(default_factory=list)

    def record(self, step: int, dt: float):
        med = statistics.median(self.times[-self.window:]) if self.times else dt
        self.times.append(dt)
        if len(self.times) > 8 and dt > self.factor * med:
            self.flagged.append((step, dt, med))

    @property
    def straggler_steps(self) -> List[int]:
        return [s for s, *_ in self.flagged]

    def summary(self) -> Dict:
        if not self.times:
            return {"steps": 0}
        return {
            "steps": len(self.times),
            "median_s": statistics.median(self.times),
            "p99_s": sorted(self.times)[int(0.99 * (len(self.times) - 1))],
            "stragglers": len(self.flagged),
        }
