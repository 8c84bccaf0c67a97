"""Structured tracing: lightweight spans with Chrome trace_event export.

The port's own copy of ``repro/obs/trace.py`` (same API and event schema).
A span or an instant is host time only: recording one reads the host's
clock and never synchronizes the device, so nothing of it lands in a CUDA
graph that a traced region captures.

A ``TraceCollector`` is a thread-safe, bounded in-process ring of trace
events.  Code instruments itself with::

    from repro_torch.obs import trace

    with trace.span("device_init", group="PN_KC", rows=4096):
        ...                      # timed region -> "X" (complete) event

    trace.instant("choose_block_spmv", bp=8, bn=128)   # point event

Events accumulate in a module-level default collector and can be exported
as Chrome ``trace_event`` JSON (loadable in chrome://tracing or Perfetto)
via :func:`export` / :func:`chrome_trace`.  The collector is bounded: once
``cap`` events are held the oldest are dropped and ``dropped`` counts them,
so long-running servers never grow without bound.

Timestamps are microseconds relative to the collector's epoch
(``time.perf_counter_ns`` at construction), which is what the Chrome trace
viewer expects (``ts``/``dur`` in µs).  Nesting is implicit: the viewer
reconstructs the span tree from ts/dur containment per ``tid``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

import torch

__all__ = [
    "TraceCollector",
    "span",
    "instant",
    "events",
    "clear",
    "chrome_trace",
    "export",
    "get_collector",
    "set_enabled",
    "validate_chrome_trace",
]

_DEFAULT_CAP = 65536


def _jsonable(v: Any) -> Any:
    """Coerce an arg value to something json.dumps accepts."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        # a 0-d tensor on the CPU is its value; reading one on the card
        # would synchronize the device, so it is described instead
        if v.dim() == 0 and v.device.type == "cpu":
            return v.item()
        return f"tensor({v.device}, {v.dtype}, {list(v.shape)})"
    try:  # numpy scalars
        return v.item()
    except (AttributeError, ValueError, TypeError):
        return str(v)


class TraceCollector:
    """Thread-safe bounded collector of Chrome trace_event records."""

    def __init__(self, cap: int = _DEFAULT_CAP, enabled: bool = True):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=cap)
        self._epoch_ns = time.perf_counter_ns()
        self.enabled = enabled
        self.dropped = 0

    # -- recording -------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._epoch_ns) / 1e3

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[Dict[str, Any]]:
        """Record a complete ("X") event covering the with-block.  Yields
        the span's args, to which the block may add what it learns (a run
        says whether it captured a graph)."""
        if not self.enabled:
            yield {}
            return
        t0 = self._now_us()
        try:
            yield args
        finally:
            self._append({
                "name": name,
                "ph": "X",
                "ts": t0,
                "dur": self._now_us() - t0,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": {k: _jsonable(v) for k, v in args.items()},
            })

    def instant(self, name: str, **args: Any) -> None:
        """Record an instant ("i") event at the current time."""
        if not self.enabled:
            return
        self._append({
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": self._now_us(),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": {k: _jsonable(v) for k, v in args.items()},
        })

    # -- export ----------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def chrome_trace(self) -> Dict[str, Any]:
        """The full Chrome trace_event JSON document (as a dict)."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def export(self, path: str) -> int:
        """Write the Chrome trace JSON to ``path``; returns event count.

        Raises OSError if the file cannot be written.
        """
        doc = self.chrome_trace()
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return len(doc["traceEvents"])


# -- module-level default collector --------------------------------------
_default = TraceCollector()


def get_collector() -> TraceCollector:
    return _default


def set_enabled(enabled: bool) -> None:
    _default.enabled = enabled


def span(name: str, **args: Any):
    return _default.span(name, **args)


def instant(name: str, **args: Any) -> None:
    _default.instant(name, **args)


def events() -> List[Dict[str, Any]]:
    return _default.events()


def clear() -> None:
    _default.clear()


def chrome_trace() -> Dict[str, Any]:
    return _default.chrome_trace()


def export(path: str) -> int:
    return _default.export(path)


def validate_chrome_trace(doc: Any) -> Optional[str]:
    """Check a dict against the Chrome trace_event schema we emit.

    Returns None when valid, else a string describing the first problem.
    Used by tests and by ``chip_smoke.py`` on its exported trace.
    """
    if not isinstance(doc, dict):
        return "document is not an object"
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return "traceEvents missing or not a list"
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            return f"event {i} not an object"
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                return f"event {i} missing {field!r}"
        if not isinstance(ev["name"], str):
            return f"event {i} name not a string"
        if ev["ph"] not in ("X", "i", "B", "E", "M"):
            return f"event {i} has unknown phase {ev['ph']!r}"
        if ev["ph"] == "X" and (not isinstance(ev.get("dur"), (int, float))
                                or ev["dur"] < 0):
            return f"event {i} 'X' without non-negative dur"
        try:
            json.dumps(ev.get("args", {}))
        except (TypeError, ValueError):
            return f"event {i} args not JSON-serializable"
    return None
