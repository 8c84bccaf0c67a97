"""On-device activity health monitoring inside the step loop.

Counterpart of ``repro/obs/health.py``.  The paper's tuning concern is
scaling synaptic conductances "to ensure sufficient spiking": a silent or
saturated population is the failure mode.  ``HealthConfig`` (passed as
``build(..., monitor=...)``) adds a small accumulator to every step:

- per-population spike totals and an exponential-moving-average firing
  rate (Hz, time constant ``ema_tau_ms``);
- silent / saturated detectors: the final EMA below / above a
  per-population ``bands_hz`` entry (or ``default_band_hz``);
- a NaN/Inf guard on every population's ``V`` and every state-resident
  ``g`` (invalid ELL slots masked), recording the first bad step.

Every leaf carries the batch axis [B] (the JAX package vmaps instead);
``run`` reports a single member in the JAX package's scalar shapes, and
``serve_chunk`` one report a chunk with a stream axis (``summary(slot)``).
Monitoring off (``monitor=None`` or ``enabled=False``) adds no device op:
the step loop never mentions it.  The guard here is the JAX monitor's, not
the simulator's carried ``finite`` flag (which also folds u, m, h, n and
custom-update writes), so the two may trip on different steps.

The float operations are the JAX package's, with the same float32
constants (``alpha``, ``1/(n dt)``): per-step counts are exact integer
sums, and the EMA rounds as the JAX fold does up to the order of float32
operations, which is the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["HealthConfig", "HealthState", "HealthReport", "NO_BAD_STEP",
           "init_state", "accumulate", "combine_across_devices",
           "finalize"]

# "no non-finite value seen yet"; -1 in the finalized report
NO_BAD_STEP = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the monitor (the JAX package's).

    enabled: ``HealthConfig(enabled=False)`` builds the unmonitored step.
    ema_tau_ms: the rate EMA's time constant; a step does
        ``ema += alpha * (rate - ema)``, ``alpha = 1 - exp(-dt/tau)``.
    bands_hz: population -> (lo_hz, hi_hz) healthy band; others take
        ``default_band_hz`` (None: no silent/saturated detection).
    nan_guard: fold ``isfinite`` of every ``V`` and state-resident ``g``
        into the report, recording the first offending step.
    """
    enabled: bool = True
    ema_tau_ms: float = 20.0
    bands_hz: Mapping[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    default_band_hz: Optional[Tuple[float, float]] = (1.0, 200.0)
    nan_guard: bool = True

    def validate(self, pop_names) -> None:
        """Raise ValueError on unknown populations / malformed bands."""
        if self.ema_tau_ms <= 0:
            raise ValueError(
                f"ema_tau_ms must be > 0, got {self.ema_tau_ms}")
        unknown = set(self.bands_hz) - set(pop_names)
        if unknown:
            raise ValueError(
                f"unknown band population(s) {sorted(unknown)}; declared "
                f"populations: {sorted(pop_names)}")
        for name, band in list(self.bands_hz.items()) + (
                [("<default>", self.default_band_hz)]
                if self.default_band_hz is not None else []):
            lo, hi = band
            if not lo <= hi:
                raise ValueError(
                    f"band for {name!r} has lo > hi: ({lo}, {hi})")

    def band(self, pop: str) -> Optional[Tuple[float, float]]:
        return self.bands_hz.get(pop, self.default_band_hz)

    def alpha(self, dt_ms: float) -> float:
        return float(1.0 - math.exp(-float(dt_ms) / self.ema_tau_ms))


@dataclasses.dataclass
class HealthState:
    """The accumulator a run carries; every leaf [B] (dicts by
    population)."""
    spike_total: Dict[str, torch.Tensor]   # int32
    rate_ema_hz: Dict[str, torch.Tensor]   # float32
    steps: torch.Tensor                    # int32, steps accumulated
    nonfinite: torch.Tensor                # bool
    first_bad_step: torch.Tensor           # int32, NO_BAD_STEP sentinel


@dataclasses.dataclass
class HealthReport:
    """The finalized monitor output; leaves [B], or scalars for a
    single-member ``run``."""
    spike_total: Dict[str, torch.Tensor]    # int32: population total
    rate_ema_hz: Dict[str, torch.Tensor]    # float32: final EMA rate
    mean_rate_hz: Dict[str, torch.Tensor]   # float32: total/(n steps dt)
    silent: Dict[str, torch.Tensor]         # bool: EMA below band lo
    saturated: Dict[str, torch.Tensor]      # bool: EMA above band hi
    steps: torch.Tensor                     # int32
    nonfinite: torch.Tensor                 # bool
    first_bad_step: torch.Tensor            # int32, -1 when never tripped

    def summary(self, slot: Optional[int] = None) -> dict:
        """Plain-Python view (of one batch member or served stream slot,
        for a batched report)."""
        def sel(x):
            a = x.detach().cpu().numpy()
            return a[slot] if slot is not None else a

        pops = {}
        for p in sorted(self.spike_total):
            pops[p] = {
                "spikes": int(sel(self.spike_total[p])),
                "rate_ema_hz": float(sel(self.rate_ema_hz[p])),
                "mean_rate_hz": float(sel(self.mean_rate_hz[p])),
                "silent": bool(sel(self.silent[p])),
                "saturated": bool(sel(self.saturated[p])),
            }
        return {"steps": int(sel(self.steps)),
                "nonfinite": bool(sel(self.nonfinite)),
                "first_bad_step": int(sel(self.first_bad_step)),
                "populations": pops}


def _f32(x: float) -> float:
    """A Python float rounded to float32, as the JAX package's
    ``jnp.float32`` constants."""
    return float(np.float32(x))


def init_state(pop_sizes: Mapping[str, int], batch: int,
               device) -> HealthState:
    def z(dtype):
        return torch.zeros(batch, dtype=dtype, device=device)
    return HealthState(
        spike_total={p: z(torch.int32) for p in pop_sizes},
        rate_ema_hz={p: z(torch.float32) for p in pop_sizes},
        steps=z(torch.int32), nonfinite=z(torch.bool),
        first_bad_step=torch.full((batch,), NO_BAD_STEP, dtype=torch.int32,
                                  device=device))


def accumulate(cfg: HealthConfig, hs: HealthState,
               counts: Mapping[str, torch.Tensor], ok: torch.Tensor,
               dt_ms: float, pop_sizes: Mapping[str, int],
               gate: Optional[torch.Tensor] = None) -> HealthState:
    """One post-step update.  counts: population -> int32 [B] spikes this
    step; ok: bool [B], True where V and state-resident g are all finite
    this step; gate: bool [B] (serving's lane mask), where False the
    member's accumulator passes through untouched."""
    alpha = _f32(cfg.alpha(dt_ms))
    new_total, new_ema = {}, {}
    for p, n in pop_sizes.items():
        c = counts[p]
        new_total[p] = hs.spike_total[p] + c
        rate = c.to(torch.float32) * _f32(1.0 / (n * dt_ms * 1e-3))
        ema = hs.rate_ema_hz[p]
        new_ema[p] = ema + alpha * (rate - ema)
    if cfg.nan_guard:
        bad = ~ok
        first = torch.where(bad & (hs.first_bad_step == NO_BAD_STEP),
                            hs.steps, hs.first_bad_step)
        nonfinite = hs.nonfinite | bad
    else:
        first, nonfinite = hs.first_bad_step, hs.nonfinite
    new = HealthState(spike_total=new_total, rate_ema_hz=new_ema,
                      steps=hs.steps + 1, nonfinite=nonfinite,
                      first_bad_step=first)
    if gate is None:
        return new

    def pick(a, b):
        return {k: torch.where(gate, a[k], b[k]) for k in a} \
            if isinstance(a, dict) else torch.where(gate, a, b)
    return HealthState(**{f.name: pick(getattr(new, f.name),
                                       getattr(hs, f.name))
                          for f in dataclasses.fields(HealthState)})


def combine_across_devices(hs: HealthState, mesh) -> HealthState:
    """Merge the ranks' NaN-guard verdicts at a run's end (the sharded
    engine): spike totals, EMAs and step counts are the same on every rank
    (built from all-reduced counts); only the guard differs, so
    ``nonfinite`` ORs (pmax) and ``first_bad_step`` takes the earliest
    step (pmin over the NO_BAD_STEP sentinel)."""
    return HealthState(spike_total=hs.spike_total,
                       rate_ema_hz=hs.rate_ema_hz, steps=hs.steps,
                       nonfinite=mesh.pmax(hs.nonfinite),
                       first_bad_step=mesh.pmin(hs.first_bad_step))


def finalize(cfg: HealthConfig, hs: HealthState, dt_ms: float,
             pop_sizes: Mapping[str, int]) -> HealthReport:
    """HealthState -> HealthReport (elementwise over [B])."""
    steps_f = torch.clamp(hs.steps.to(torch.float32), min=1.0)
    mean, silent, saturated = {}, {}, {}
    for p, n in pop_sizes.items():
        inv = _f32(1.0 / (n * float(dt_ms) * 1e-3))
        mean[p] = hs.spike_total[p].to(torch.float32) * inv / steps_f
        band = cfg.band(p)
        if band is None:
            silent[p] = torch.zeros_like(hs.nonfinite)
            saturated[p] = torch.zeros_like(hs.nonfinite)
        else:
            lo, hi = band
            silent[p] = hs.rate_ema_hz[p] < _f32(lo)
            saturated[p] = hs.rate_ema_hz[p] > _f32(hi)
    first = torch.where(hs.first_bad_step == NO_BAD_STEP,
                        torch.full_like(hs.first_bad_step, -1),
                        hs.first_bad_step)
    return HealthReport(spike_total=hs.spike_total,
                        rate_ema_hz=hs.rate_ema_hz, mean_rate_hz=mean,
                        silent=silent, saturated=saturated, steps=hs.steps,
                        nonfinite=hs.nonfinite, first_bad_step=first)
