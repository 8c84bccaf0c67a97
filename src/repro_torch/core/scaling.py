"""Fan-in-indexed weight scaling for the LM stack: the paper's conductance
scaling carried to deep networks, the counterpart of
``repro/core/scaling.py``.

A linear layer's fan-in plays nConn, the activation RMS after the layer
plays the post-synaptic rate, and a non-finite RMS plays the paper's
overflow guard.  ``probe_scale_for_fanin`` is the guarded search of the
paper's Fig. 1 (probe, band check, bisect) on one layer's output RMS;
``probe_and_fit`` probes a sweep of fan-ins and fits the paper's hyperbola

  scale(fan_in)^2 = k1 / (k2 + fan_in) + k3

(``core/conductance.py``'s ``fit_hyperbola``) on the variance, so that both
regimes (sparse spike-like inputs: 1/n; dense Gaussian ones:
1/sqrt(n)) can be represented.  ``ScalingPolicy`` is what a model config
carries; ``DEFAULT_POLICY`` is the probe's closed-form limit for dense
Gaussian activations.

The probe draws x and w0 from ``repro_torch.random``'s threefry keys, as
the JAX probe draws them from ``jax.random`` (within the normal's 4 ulp),
and runs on ``cuda`` unless the caller passes ``device="cpu"``.  Its
product ``x @ (s * w0)`` is ``torch.matmul``: the JAX package computes it
outside any Pallas kernel.  Each bisection step reads the RMS on the host
once, as the JAX loop does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch import random as RND
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.conductance import fit_hyperbola, hyperbola

__all__ = ["ScalingPolicy", "probe_scale_for_fanin", "probe_and_fit",
           "DEFAULT_POLICY"]


@dataclasses.dataclass(frozen=True)
class ScalingPolicy:
    """init std = scale(fan_in) * base; residual branches additionally
    multiplied by residual_alpha / sqrt(2 * n_layers) (muP-style depth
    term)."""

    k1: float
    k2: float
    k3: float
    base: float = 1.0
    residual_alpha: float = 1.0
    squared: bool = True   # law fitted on scale^2 (variance) vs fan_in

    def scale(self, fan_in: int) -> float:
        v = hyperbola(np.asarray([fan_in], np.float64), self.k1, self.k2,
                      self.k3)[0]
        v = max(float(v), 1e-12)
        return self.base * (math.sqrt(v) if self.squared else v)

    def init_std(self, fan_in: int) -> float:
        return self.scale(fan_in)

    def residual_std(self, fan_in: int, n_layers: int) -> float:
        return self.scale(fan_in) * self.residual_alpha / math.sqrt(
            max(1, 2 * n_layers))


# the closed-form limit of the probe for dense Gaussian activations: the
# variance law 1/fan_in is the hyperbola with k2 = k3 = 0, k1 = 1
DEFAULT_POLICY = ScalingPolicy(k1=1.0, k2=0.0, k3=0.0)


def probe_scale_for_fanin(
    key: torch.Tensor, fan_in: int, fan_out: int = 256,
    target_rms: float = 1.0, band: float = 0.05, batch: int = 512,
    max_iters: int = 40, device: DeviceLike = None,
) -> float:
    """Guarded bisection (paper Fig. 1) on one linear layer's output RMS:
    the scale s in (0, 16) that brings sqrt(mean((x @ (s w0))^2)) into
    ``target_rms`` (1 +- ``band``), a non-finite RMS counted as too high.
    ``key``: a ``repro_torch.random`` key, split into x's and w0's."""
    dev = resolve_device(device)
    kx, kw = RND.split(key.to(dev))
    x = RND.normal(kx, (batch, fan_in))
    w0 = RND.normal(kw, (fan_in, fan_out))
    lo, hi = 0.0, 16.0
    s = 1.0
    for _ in range(max_iters):
        s = 0.5 * (lo + hi)
        y = torch.matmul(x, w0 * torch.tensor(s, dtype=torch.float32,
                                              device=dev))
        r = float(torch.sqrt(torch.mean(y * y)))
        if not math.isfinite(r) or r > target_rms * (1 + band):
            hi = s
        elif r < target_rms * (1 - band):
            lo = s
        else:
            break
    return s


def probe_and_fit(
    key: torch.Tensor, fanins: Sequence[int] = (64, 128, 256, 512, 1024,
                                                2048, 4096, 8192),
    device: DeviceLike = None, **probe_kw,
) -> ScalingPolicy:
    """Probe a fan-in sweep (the i-th fan-in with ``fold_in(key, i)``) and
    fit the paper's hyperbola on the variance."""
    dev = resolve_device(device)
    scales = [probe_scale_for_fanin(RND.fold_in(key.to(dev), i), int(f),
                                    device=dev, **probe_kw)
              for i, f in enumerate(fanins)]
    var = np.asarray(scales, np.float64) ** 2
    k1, k2, k3, _ = fit_hyperbola(np.asarray(fanins, np.float64), var)
    return ScalingPolicy(k1=k1, k2=k2, k3=k3)
