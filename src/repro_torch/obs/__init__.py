"""Observation for the port.  Counterpart of ``repro/obs``:

- :mod:`repro_torch.obs.trace`: structured spans and Chrome trace_event
  export (host time only);
- :mod:`repro_torch.obs.profile`: wall-clock phases and the
  ``torch.profiler`` capture hook;
- :mod:`repro_torch.obs.health`: the on-device activity health monitor
  (``build(monitor=)``).

Its telemetry module (counters, gauges, Prometheus text) is not ported
yet."""
from repro_torch.obs import profile, trace  # noqa: F401
from repro_torch.obs.health import HealthConfig, HealthReport  # noqa: F401

__all__ = ["trace", "profile", "HealthConfig", "HealthReport"]
