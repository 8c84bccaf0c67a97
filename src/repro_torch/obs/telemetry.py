"""Metrics: counters, gauges, histograms and Prometheus text rendering.

A copy of ``repro/obs/telemetry.py``, the port's own (pure Python; it
imports nothing of the JAX package).  ``repro_torch.launch.gateway``
renders its ``/metrics`` endpoint through the primitives here; anything
else that wants metrics registers them on a :class:`MetricsRegistry`.

Rendering follows the Prometheus text exposition format, version 0.0.4:
``name{label="value",...} value`` lines, one sample per line, trailing
newline.  :class:`PromText` is the low-level line writer used both by the
registry and by the gateway, whose metric names, labels and number formats
are the JAX package's, byte for byte.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "LatencyWindow",
    "PromText",
    "format_labels",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]


class LatencyWindow:
    """Sliding window of latency samples with percentile summaries.

    Keeps the most recent ``cap`` samples (bounded memory) plus a lifetime
    count.  Percentiles use nearest-rank on the sorted window.
    """

    def __init__(self, cap: int = 4096):
        self._samples: deque = deque(maxlen=cap)
        self.count = 0  # lifetime, not windowed

    def add(self, v: float) -> None:
        self._samples.append(float(v))
        self.count += 1

    def samples(self) -> List[float]:
        return list(self._samples)

    def percentile(self, q: float) -> float:
        """q in [0, 1]; 0.0 if no samples."""
        s = sorted(self._samples)
        if not s:
            return 0.0
        i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[i]

    def summary(self) -> Dict[str, float]:
        s = self.samples()
        return {
            "count": self.count,
            "p50": self.percentile(0.50),
            "p99": self.percentile(0.99),
            "mean": (sum(s) / len(s)) if s else 0.0,
            "max": max(s) if s else 0.0,
        }


def format_labels(labels: Mapping[str, Any]) -> str:
    """Render a label set as ``{k="v",...}`` (empty string when no labels)."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return "{" + inner + "}"


class PromText:
    """Prometheus text-exposition line writer.

    The formatting knobs let a caller with a frozen output contract (the
    gateway's metric text, byte-identical to the JAX package's) keep its
    exact formatting through one renderer.
    """

    CONTENT_TYPE = "text/plain; version=0.0.4"

    def __init__(self) -> None:
        self.lines: List[str] = []

    def sample(self, name: str, labels: Mapping[str, Any], value: Any,
               fmt: str = "{}") -> None:
        self.lines.append(f"{name}{format_labels(labels)} " + fmt.format(value))

    def quantiles(self, name: str, labels: Mapping[str, Any],
                  summary: Mapping[str, float], unit: float = 1.0,
                  quantiles: Iterable[str] = ("50", "99"),
                  fmt: str = "{:.6f}") -> None:
        """Emit ``name{...,quantile="q"}`` lines plus ``name_count``.

        ``summary`` is a :meth:`LatencyWindow.summary` dict; ``unit``
        rescales samples (e.g. 1e-6 for µs windows rendered as seconds).
        """
        for q in quantiles:
            lab = dict(labels)
            lab["quantile"] = q
            self.sample(name, lab, summary[f"p{q}"] * unit, fmt)
        self.sample(name + "_count", labels, summary["count"])

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


class Counter:
    """Monotonically increasing counter, optionally labelled."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels: Any) -> float:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            return self._values.get(key, 0)

    def collect(self, out: PromText) -> None:
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.sample(self.name, dict(key), v, "{:g}")


class Gauge:
    """A value that can go up and down."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def set(self, value: float, **labels: Any) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def value(self, **labels: Any) -> float:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def collect(self, out: PromText) -> None:
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.sample(self.name, dict(key), v, "{:g}")


class Histogram:
    """Fixed-bucket histogram rendered as cumulative ``_bucket`` lines."""

    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets if buckets is not None
                                    else self.DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        # per label-set: (bucket counts, sum, count)
        self._series: Dict[Tuple[Tuple[str, str], ...],
                           Tuple[List[int], float, int]] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            counts, total, n = self._series.get(
                key, ([0] * len(self.buckets), 0.0, 0))
            for i, le in enumerate(self.buckets):
                if value <= le:
                    counts[i] += 1
            self._series[key] = (counts, total + value, n + 1)

    def collect(self, out: PromText) -> None:
        with self._lock:
            items = sorted((k, (list(c), s, n))
                           for k, (c, s, n) in self._series.items())
        for key, (counts, total, n) in items:
            base = dict(key)
            for le, c in zip(self.buckets, counts):
                lab = dict(base)
                lab["le"] = f"{le:g}"
                out.sample(self.name + "_bucket", lab, c)
            lab = dict(base)
            lab["le"] = "+Inf"
            out.sample(self.name + "_bucket", lab, n)
            out.sample(self.name + "_sum", base, total, "{:.6f}")
            out.sample(self.name + "_count", base, n)


class MetricsRegistry:
    """Registry of named metrics with one canonical text renderer."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _register(self, cls, name: str, help: str, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}")
                return existing
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def render(self) -> str:
        out = PromText()
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        for m in metrics:
            m.collect(out)
        return out.render()


# The process-wide registry (as trace has one collector).
default_registry = MetricsRegistry()
