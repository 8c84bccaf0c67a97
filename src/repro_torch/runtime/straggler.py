"""Straggler mitigation.

Synchronous SPMD steps move at the pace of the slowest host, so persistent
stragglers are a throughput failure even when nothing crashes.  Detection is
percentile-based over a sliding window of per-host step times; mitigation is
tiered:

  1. observe    — mark host; keep synchronous semantics.
  2. rebalance  — hand a fraction of the straggler's data shard to the
                  fastest hosts (deterministic: repro_torch.data keys on
                  global row, so reassignment is a pure index remap).
  3. evict      — treat as failed; hand to ElasticPlanner.

The policy is deliberately deterministic and unit-testable: feed step-time
observations, read back directives.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional

__all__ = ["StragglerPolicy", "Directive"]


@dataclasses.dataclass(frozen=True)
class Directive:
    host: str
    action: str          # 'observe' | 'rebalance' | 'evict'
    ratio: float = 0.0   # fraction of its shard to move (rebalance)
    detail: str = ""


class StragglerPolicy:
    def __init__(self, window: int = 20, slow_factor: float = 1.5,
                 evict_factor: float = 3.0, min_observations: int = 5):
        self.window = window
        self.slow_factor = slow_factor
        self.evict_factor = evict_factor
        self.min_observations = min_observations
        self._times: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))

    def observe(self, host: str, step_time_s: float) -> None:
        self._times[host].append(step_time_s)

    def _median_of_medians(self) -> Optional[float]:
        meds = []
        for q in self._times.values():
            if len(q) >= self.min_observations:
                s = sorted(q)
                meds.append(s[len(s) // 2])
        if not meds:
            return None
        meds.sort()
        return meds[len(meds) // 2]

    def directives(self) -> List[Directive]:
        base = self._median_of_medians()
        if base is None or base <= 0:
            return []
        out: List[Directive] = []
        for host, q in sorted(self._times.items()):
            if len(q) < self.min_observations:
                continue
            s = sorted(q)
            med = s[len(s) // 2]
            r = med / base
            if r >= self.evict_factor:
                out.append(Directive(host, "evict",
                                     detail=f"{r:.2f}x median"))
            elif r >= self.slow_factor:
                # shed work proportional to the slowdown
                ratio = min(0.5, 1.0 - 1.0 / r)
                out.append(Directive(host, "rebalance", ratio=ratio,
                                     detail=f"{r:.2f}x median"))
        return out
