"""Wall-clock phase timing and the ``torch.profiler`` capture hook.

Counterpart of ``repro/obs/profile.py``.  :class:`PhaseTimer` is the
CLI-facing layer over :mod:`repro_torch.obs.trace`: phases are recorded both
as trace spans (so they land in the exported Chrome trace) and as a simple
(name, seconds) table the CLIs print.

:func:`torch_profiler_trace` takes the place of ``jax_profiler_trace``: it
wraps ``torch.profiler.profile`` with the CPU and CUDA activities and writes
the device timeline as a Chrome trace.  Where the profiler cannot start it
raises; it never continues without profiling.
"""
from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Iterator, List, Optional, Tuple

import torch

from repro_torch.obs import trace as _trace

__all__ = ["PhaseTimer", "torch_profiler_trace", "write_trace",
           "export_trace_cli"]


class PhaseTimer:
    """Accumulates named wall-clock phases; each phase is also a span."""

    def __init__(self, collector: Optional[_trace.TraceCollector] = None):
        self._collector = collector or _trace.get_collector()
        self.phases: List[Tuple[str, float]] = []

    @contextmanager
    def phase(self, name: str, **args):
        t0 = time.perf_counter()
        with self._collector.span(name, **args):
            yield
        self.phases.append((name, time.perf_counter() - t0))

    def total(self) -> float:
        return sum(s for _, s in self.phases)

    def render(self) -> str:
        if not self.phases:
            return "(no phases recorded)"
        width = max(len(n) for n, _ in self.phases)
        lines = [f"  {n:<{width}}  {s * 1e3:10.2f} ms" for n, s in self.phases]
        lines.append(f"  {'total':<{width}}  {self.total() * 1e3:10.2f} ms")
        return "\n".join(lines)


@contextmanager
def torch_profiler_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the with-block with ``torch.profiler`` (the CPU's and the
    card's activity) and write its Chrome trace to ``logdir/trace.json``
    when the block ends.  Yields the profiler (its ``key_averages()`` and
    ``events()``).  Raises when no card is present, or when the profiler
    fails to start or export: the block never runs unprofiled."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch_profiler_trace traces the card's "
                           "activity, and no CUDA device is available")
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def write_trace(path: str,
                collector: Optional[_trace.TraceCollector] = None) -> int:
    """Export the Chrome trace to ``path``; returns the event count.

    Raises OSError when the file cannot be written: callers (the CLIs)
    turn that into a non-zero exit instead of a teardown-swallowed error.
    """
    c = collector or _trace.get_collector()
    return c.export(path)


def export_trace_cli(path: str, tag: str,
                     collector: Optional[_trace.TraceCollector] = None
                     ) -> int:
    """Shared ``--trace FILE`` tail for the CLIs: export and report.

    Returns a process exit code: 0 on success (or empty ``path``), 1 with
    a clear stderr message when the trace file cannot be written.  The run
    itself already happened; only the export failed.
    """
    if not path:
        return 0
    try:
        n = write_trace(path, collector)
    except OSError as e:
        print(f"[{tag}] error: cannot write trace file {path!r}: {e}",
              file=sys.stderr)
        return 1
    print(f"[{tag}] wrote {n} trace events to {path} "
          "(open in chrome://tracing or Perfetto)")
    return 0
