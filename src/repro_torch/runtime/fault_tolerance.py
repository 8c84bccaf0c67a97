"""Fault tolerance: heartbeats, failure detection, elastic remesh planning.

At 1000+ nodes, node loss is routine; the control plane here provides the
three pieces a training job needs (the data plane — checkpoint/restart,
deterministic data resharding — lives in repro_torch.checkpoint and
repro_torch.data):

  * HeartbeatMonitor   — per-host liveness with configurable timeout.
  * FailureDetector    — turns missed heartbeats / NaN watchdogs into
                         actionable FailureEvents.
  * ElasticPlanner     — given surviving hosts, picks the largest valid
                         (pod, data, model) mesh factorization <= survivors,
                         maps old shard coordinates to new ones, and emits a
                         RemeshPlan (which checkpoint to restore, which data
                         shards each host now owns).

Everything is pure-python and unit-testable on CPU; interfaces take host ids
and device counts, not concrete backends, so the same planner drives a real
multi-host restart (launcher re-execs with the planned topology).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["HeartbeatMonitor", "FailureEvent", "FailureDetector",
           "RemeshPlan", "ElasticPlanner"]


class HeartbeatMonitor:
    """Tracks last-seen timestamps per host."""

    def __init__(self, hosts: Sequence[str], timeout_s: float = 60.0,
                 clock=time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        now = clock()
        self._last: Dict[str, float] = {h: now for h in hosts}

    def beat(self, host: str, at: Optional[float] = None) -> None:
        self._last[host] = self._clock() if at is None else at

    def dead(self, now: Optional[float] = None) -> List[str]:
        now = self._clock() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)

    def alive(self, now: Optional[float] = None) -> List[str]:
        now = self._clock() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t <= self.timeout_s)


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    kind: str          # 'host_lost' | 'nan' | 'straggler'
    host: Optional[str]
    step: int
    detail: str = ""


class FailureDetector:
    """Fuses liveness + numeric watchdogs into failure events."""

    def __init__(self, monitor: HeartbeatMonitor):
        self.monitor = monitor
        self._reported: set = set()

    def poll(self, step: int) -> List[FailureEvent]:
        events = []
        for h in self.monitor.dead():
            if h not in self._reported:
                self._reported.add(h)
                events.append(FailureEvent("host_lost", h, step,
                                           "heartbeat timeout"))
        return events

    def report_nan(self, step: int, what: str) -> FailureEvent:
        # NaN containment mirrors the paper's overflow guard (§2): the
        # training loop rolls back to the last checkpoint with a lowered
        # conductance/lr scale rather than propagating poison.
        return FailureEvent("nan", None, step, what)


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    hosts: Tuple[str, ...]            # surviving hosts, mesh order
    restore_step: Optional[int]
    data_shard_of_host: Dict[str, int]
    dropped_hosts: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return math.prod(self.mesh_shape)


class ElasticPlanner:
    """Plans the post-failure topology.

    Constraints: model-parallel width is fixed (weights are laid out for
    it); the data(+pod) extent shrinks to the largest multiple the
    survivors support.  Batch is kept constant by raising per-shard batch
    (synchronous semantics preserved; throughput degrades gracefully).
    """

    def __init__(self, devices_per_host: int, model_parallel: int,
                 global_batch: int):
        self.devices_per_host = devices_per_host
        self.model_parallel = model_parallel
        self.global_batch = global_batch

    def plan(self, alive_hosts: Sequence[str], dead_hosts: Sequence[str],
             restore_step: Optional[int]) -> RemeshPlan:
        alive = sorted(alive_hosts)
        total_dev = len(alive) * self.devices_per_host
        mp = self.model_parallel
        if total_dev < mp:
            raise RuntimeError(
                f"survivors ({total_dev} devices) below model-parallel "
                f"width {mp}")
        data = total_dev // mp
        # keep data extent a divisor of the global batch so per-shard batch
        # stays integral
        while data > 1 and self.global_batch % data:
            data -= 1
        used_hosts = (data * mp + self.devices_per_host - 1) \
            // self.devices_per_host
        hosts = tuple(alive[:used_hosts])
        shards = {h: i % data for i, h in enumerate(hosts)}
        return RemeshPlan(
            mesh_shape=(data, mp), mesh_axes=("data", "model"),
            hosts=hosts, restore_step=restore_step,
            data_shard_of_host=shards, dropped_hosts=tuple(sorted(
                dead_hosts)))
