"""Observation for the port.  Counterpart of ``repro/obs``:

- :mod:`repro_torch.obs.trace`: structured spans and Chrome trace_event
  export (host time only);
- :mod:`repro_torch.obs.telemetry`: counters, gauges, histograms and
  Prometheus text (``MetricsRegistry``, ``LatencyWindow``);
- :mod:`repro_torch.obs.health`: the on-device activity health monitor
  (``build(monitor=)``);
- :mod:`repro_torch.obs.profile`: wall-clock phases and the
  ``torch.profiler`` capture hook.
"""
from repro_torch.obs import profile, trace  # noqa: F401
from repro_torch.obs.health import HealthConfig, HealthReport  # noqa: F401
from repro_torch.obs.telemetry import (LatencyWindow,  # noqa: F401
                                       MetricsRegistry)

__all__ = ["trace", "profile", "HealthConfig", "HealthReport",
           "LatencyWindow", "MetricsRegistry"]
