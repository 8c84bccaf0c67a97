"""Slot scheduling for continuous-batching servers.

A copy of ``repro/launch/scheduling.py``, the port's own (it imports
nothing of the JAX package).  The token server (``repro_torch.launch.serve``)
keeps a fixed table of slots (KV-cache rows), a FIFO queue of pending
requests, and a loop that admits queued requests into free slots, advances
every occupied slot in one step, and evicts finished requests so their
slots are reusable.  This module is that core, plus the per-request latency
accounting.  Priorities, mid-flight eviction and slot re-packing
(``submit(req, priority=...)``, ``evict``, ``move``/``resize``) are kept as
the JAX package has them, for the gateway that will come with the SNN
serving port.

Requests are arbitrary objects with an integer ``rid`` attribute; the
scheduler never inspects anything else.  Time comes from an injectable
``clock`` (default ``time.monotonic``) so deadline logic is testable.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["RequestTiming", "SlotScheduler"]


@dataclasses.dataclass
class RequestTiming:
    """Wall-clock milestones of one request through the slot table.

    ``deadline_at``/``evicted_at`` are the gateway's SLO fields: a request
    past ``deadline_at`` is evicted at the next chunk boundary, stamping
    ``evicted_at`` (and ``finished_at``, so pruning via ``forget`` still
    works) — evicted requests are excluded from completion-latency
    percentiles and counted separately.
    """

    submitted_at: float
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    deadline_at: Optional[float] = None    # absolute; None = no deadline
    evicted_at: Optional[float] = None

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def service_s(self) -> Optional[float]:
        if self.admitted_at is None or self.finished_at is None:
            return None
        return self.finished_at - self.admitted_at

    @property
    def total_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def evicted(self) -> bool:
        return self.evicted_at is not None

    def deadline_exceeded(self, now: float) -> bool:
        """True when the request has a deadline and ``now`` is past it."""
        return self.deadline_at is not None and now > self.deadline_at


class SlotScheduler:
    """Priority FIFO queue + fixed slot table (continuous batching).

    Slots are integers in [0, max_slots); a slot is either free or bound to
    exactly one in-flight request.  ``admit`` moves queued requests into
    free slots (priority order, FIFO within a priority), ``release`` frees
    a slot when its request finishes — the next ``admit`` refills it, so a
    long-running request never blocks the batch (the continuous-batching
    property both servers rely on).  ``evict`` removes a request that will
    *not* finish (deadline expiry, load shedding) whether it is still
    queued or already holds a slot; evicting something already gone is a
    no-op, so callers can be sloppy about races between completion and
    deadline checks.
    """

    def __init__(self, max_slots: int,
                 clock: Callable[[], float] = time.monotonic):
        if max_slots <= 0:
            raise ValueError(f"max_slots must be positive, got {max_slots}")
        self.max_slots = int(max_slots)
        self.clock = clock
        self.queue: List[object] = []
        self.active: Dict[int, object] = {}      # slot -> request
        self.timings: Dict[int, RequestTiming] = {}   # rid -> timing
        self._priority: Dict[int, int] = {}      # rid -> submit priority
        self.evicted_total = 0

    # -- queue ------------------------------------------------------------
    def submit(self, req, priority: int = 0,
               deadline_at: Optional[float] = None) -> None:
        """Enqueue a request (stamped for latency accounting).

        ``priority``: lower runs first; equal priorities stay FIFO (stable
        insertion, so the default 0 everywhere degrades to plain FIFO).
        ``deadline_at``: absolute clock() time after which the request is
        eligible for eviction (the *caller* checks and calls evict —
        typically at chunk boundaries, where slots can actually be
        reclaimed).
        """
        if req.rid in self.timings:
            raise ValueError(
                f"duplicate request rid {req.rid}: timing/accounting is "
                "keyed by rid; use forget() after collecting a finished "
                "request to recycle its id")
        self.timings[req.rid] = RequestTiming(submitted_at=self.clock(),
                                              deadline_at=deadline_at)
        self._priority[req.rid] = int(priority)
        i = len(self.queue)
        while i > 0 and self._priority[self.queue[i - 1].rid] > priority:
            i -= 1
        self.queue.insert(i, req)

    @property
    def free_slots(self) -> List[int]:
        return [s for s in range(self.max_slots) if s not in self.active]

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active)

    # -- slot transitions -------------------------------------------------
    def admit(self) -> List[Tuple[int, object]]:
        """Bind queued requests to free slots (priority FIFO); returns the
        new (slot, request) assignments so the caller can initialize the
        device-resident state those slots hold."""
        assigned: List[Tuple[int, object]] = []
        free = self.free_slots
        now = self.clock()
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.pop(0)
            self.active[slot] = req
            self.timings[req.rid].admitted_at = now
            assigned.append((slot, req))
        return assigned

    def release(self, slot: int):
        """Free a slot whose request finished; returns the request."""
        req = self.active.pop(slot)
        self.timings[req.rid].finished_at = self.clock()
        return req

    def evict(self, rid: int):
        """Remove a request that will not finish (deadline expiry, load
        shedding): a queued request leaves the queue, an in-flight request
        gives its slot back, an unknown/already-finished rid is a **no-op**
        (double-finish safe — deadline sweeps race with completions).
        Returns the request if one was actually evicted, else None; stamps
        ``evicted_at`` and ``finished_at`` so latency accounting and
        ``forget`` pruning keep working."""
        t = self.timings.get(rid)
        if t is None or t.finished_at is not None:
            return None
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                now = self.clock()
                t.evicted_at = t.finished_at = now
                self.evicted_total += 1
                return req
        for slot, req in self.active.items():
            if req.rid == rid:
                del self.active[slot]
                now = self.clock()
                t.evicted_at = t.finished_at = now
                self.evicted_total += 1
                return req
        return None

    def expired(self, now: Optional[float] = None) -> List[object]:
        """Queued or in-flight requests whose deadline has passed (the
        chunk-boundary sweep calls this, then evicts each one)."""
        if now is None:
            now = self.clock()
        out = [r for r in self.queue
               if self.timings[r.rid].deadline_exceeded(now)]
        out += [r for _, r in sorted(self.active.items())
                if self.timings[r.rid].deadline_exceeded(now)]
        return out

    # -- slot re-packing (elastic capacity) --------------------------------
    def move(self, src: int, dst: int) -> None:
        """Re-bind the request in slot ``src`` to free slot ``dst`` (the
        elastic resize compacts active slots to the low end before
        shrinking the table; the caller must move the device-resident
        state the same way — CompiledModel.select_streams)."""
        if dst in self.active:
            raise ValueError(f"destination slot {dst} is occupied")
        self.active[dst] = self.active.pop(src)

    def resize(self, new_max: int) -> None:
        """Change the slot-table capacity between chunks.  Growing is
        always safe; shrinking requires every active slot to already be
        below the new capacity (compact with move() first)."""
        if new_max <= 0:
            raise ValueError(f"max_slots must be positive, got {new_max}")
        stranded = [s for s in self.active if s >= new_max]
        if stranded:
            raise ValueError(
                f"cannot shrink to {new_max} slots: active slot(s) "
                f"{sorted(stranded)} would be stranded; move() them first")
        self.max_slots = int(new_max)

    def forget(self, rid: int) -> None:
        """Drop a finished request's timing record (long-lived servers
        prune per-request accounting after collecting results; without
        this the timings dict grows one entry per request forever)."""
        t = self.timings.get(rid)
        if t is not None and t.finished_at is not None:
            del self.timings[rid]
            self._priority.pop(rid, None)

    # -- reporting --------------------------------------------------------
    def latency_summary(self) -> Dict[str, float]:
        """Mean/max total latency and queue wait over *completed* requests
        (evicted ones are not completions: their latency measures the
        deadline, not the service — they are counted, not averaged)."""
        done = [t for t in self.timings.values()
                if t.finished_at is not None and not t.evicted]
        evicted = sum(1 for t in self.timings.values() if t.evicted)
        if not done:
            return {"finished": 0, "evicted": evicted}
        totals = [t.total_s for t in done]
        waits = [t.queue_wait_s for t in done if t.queue_wait_s is not None]
        return {
            "finished": len(done),
            "evicted": evicted,
            "mean_total_s": sum(totals) / len(done),
            "max_total_s": max(totals),
            "mean_queue_wait_s": (sum(waits) / len(waits)) if waits else 0.0,
        }
