"""Observation for the port: the on-device activity health monitor
(``repro_torch.obs.health``).  Counterpart of ``repro/obs``; its tracing,
profiling and telemetry modules are not ported yet."""
