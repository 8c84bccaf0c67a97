"""Synaptic-conductance scaling (the paper's central contribution, §2/§5.1).

Counterpart of ``repro/core/conductance.py``.  Given a network whose fan-in
(`nConn`) differs from the reference configuration, find the multiplier
`gScale` that restores the reference spiking behaviour, subject to the two
constraints of the paper's Fig. 1 pseudocode: (a) the population mean rate
stays inside a band, and (b) no float32 overflow / NaN anywhere in the
state (one ``finite`` flag per run suffices, since NaNs spread through the
connectivity).

  * `search_bisect`: the paper's guarded halving, O(log) runs.
  * `search_sweep`: a whole candidate grid in ONE batched run (the grid
    rides the batch axis of the ELL kernel); picks the finite candidate
    whose rate is closest to the target.

A run function over ``CompiledModel.run`` (or ``sweep_gscale``) takes the
compiled step loop: its runner is cached per (gscale keys, batch, ...), so
every candidate of a search with one group and step count replays one
capture, its gScale a copy into a device buffer.  The searches read each
run's rate and ``finite`` on the host between runs, outside the graphs.

`fit_hyperbola` reproduces the paper's regression
    gScale = k1/(k2 + nConn) + k3
via its linearization, refined by a 1-D search over k2 with exact linear
solves for (k1, k3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

__all__ = [
    "RateResult", "search_bisect", "search_sweep",
    "fit_hyperbola", "hyperbola", "mape",
]

# run_fn(gscale: float) -> (rate_hz: scalar, finite: bool scalar)
RunFn = Callable[[float], Tuple[object, object]]


@dataclasses.dataclass
class RateResult:
    gscale: float
    rate_hz: float
    finite: bool
    iters: int


def search_bisect(
    run_fn: RunFn, lo: float, hi: float,
    target_band: Tuple[float, float], max_iters: int = 24,
) -> RateResult:
    """Paper Fig-1: guarded bisection on the (monotone) rate-vs-gscale curve.

    NaN/overflow counts as rate-too-high (constraint (b) dominates (a)).
    ``run_fn`` receives each candidate rounded to float32."""
    target_lo, target_hi = target_band
    mid_rate, mid_finite = 0.0, True
    lo, hi = float(lo), float(hi)
    it = 0
    gs = 0.5 * (lo + hi)
    for it in range(1, max_iters + 1):
        gs = 0.5 * (lo + hi)
        rate, finite = run_fn(float(np.float32(gs)))
        mid_rate = float(rate)
        mid_finite = bool(finite)
        too_high = (not mid_finite) or (mid_rate > target_hi)
        too_low = mid_finite and (mid_rate < target_lo)
        if too_high:
            hi = gs
        elif too_low:
            lo = gs
        else:  # in band
            break
        if hi - lo < 1e-6 * max(1.0, abs(hi)):
            break
    return RateResult(gscale=gs, rate_hz=mid_rate, finite=mid_finite,
                      iters=it)


def search_sweep(
    run_fn_batched: Callable[[torch.Tensor], Tuple[object, object]],
    candidates, target_rate: float,
) -> RateResult:
    """Evaluate all candidates in one batched run; pick the finite
    candidate with rate closest to target.  `run_fn_batched(gscales[B]) ->
    (rates[B], finite[B])`."""
    cands = torch.as_tensor(candidates, dtype=torch.float32)
    rates, finite = run_fn_batched(cands)
    rates = torch.as_tensor(rates, dtype=torch.float32).cpu()
    finite = torch.as_tensor(finite, dtype=torch.bool).cpu()
    penalty = torch.where(finite, 0.0, float("inf"))
    score = (rates - target_rate).abs() + penalty
    i = int(torch.argmin(score))
    return RateResult(gscale=float(cands[i]), rate_hz=float(rates[i]),
                      finite=bool(finite[i]), iters=len(cands))


# ---------------------------------------------------------------------------
# Regression (paper Tables 1 & 2)
# ---------------------------------------------------------------------------

def hyperbola(n: np.ndarray, k1: float, k2: float, k3: float) -> np.ndarray:
    return k1 / (k2 + np.asarray(n, np.float64)) + k3


def mape(pred: np.ndarray, obs: np.ndarray) -> float:
    obs = np.asarray(obs, np.float64)
    pred = np.asarray(pred, np.float64)
    return float(np.mean(np.abs(pred - obs) / np.abs(obs))) * 100.0


def _solve_k1k3(n: np.ndarray, g: np.ndarray, k2: float):
    """Exact least-squares (k1, k3) for fixed k2 (model linear in both)."""
    x = 1.0 / (k2 + n)
    A = np.stack([x, np.ones_like(x)], axis=1)
    coef, *_ = np.linalg.lstsq(A, g, rcond=None)
    k1, k3 = float(coef[0]), float(coef[1])
    sse = float(np.sum((A @ coef - g) ** 2))
    return k1, k3, sse


def fit_hyperbola(
    nconn: np.ndarray, gscale: np.ndarray, refine: bool = True,
) -> Tuple[float, float, float, float]:
    """Fit gScale = k1/(k2+nConn) + k3.  Returns (k1, k2, k3, mape_pct)."""
    n = np.asarray(nconn, np.float64)
    g = np.asarray(gscale, np.float64)

    # paper's linearization: g*n = -k2*g + k3*n + (k1 + k2*k3)
    X = np.stack([g, n, np.ones_like(n)], axis=1)
    y = g * n
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    a, b, c = coef
    k2 = float(-a)
    k3 = float(b)
    k1 = float(c - k2 * k3)

    if refine:
        # 1-D refinement over k2 (grid on SSE, bracketed around the
        # linearized estimate; guards the pole k2 = -min(n)).
        lo = k2 - 10.0 * (abs(k2) + 1.0)
        hi = k2 + 10.0 * (abs(k2) + 1.0)
        pole = -np.min(n)
        grid = np.linspace(lo, hi, 2001)
        grid = grid[np.abs(grid - pole) > 1e-6]
        best = (np.inf, k1, k2, k3)
        for k2c in grid:
            k1c, k3c, sse = _solve_k1k3(n, g, k2c)
            if sse < best[0]:
                best = (sse, k1c, k2c, k3c)
        _, k1, k2, k3 = best

    err = mape(hyperbola(n, k1, k2, k3), g)
    return k1, k2, k3, err
