"""Container-level propagation ops, one signature per op.

Counterpart of ``repro/kernels/ops.py`` for the ELL spmv family.  There is
no backend switch: each op goes by the device its tensors lie on (see
``repro_torch.kernels.ell_spmv``).

The event-driven variants keep the JAX signatures and run the same kernel.
The kernel returns at once for rows whose spike is 0, which is the work the
TPU's row compaction saves, so no compaction, capacity or dense fallback is
needed and the result is the dense pass's.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ell_spmv as _k

__all__ = ["ell_spmv", "ell_spmv_batched", "ell_spmv_delay",
           "ell_spmv_delay_batched", "ell_spmv_event",
           "ell_spmv_event_delay"]


def ell_spmv_batched(ell, spikes: torch.Tensor) -> torch.Tensor:
    """spikes [B, n_pre] -> currents [B, n_post]."""
    return _k.ell_spmv(ell.g, ell.post_ind, ell.valid,
                       spikes.to(torch.float32), ell.n_post)


def ell_spmv(ell, spikes: torch.Tensor) -> torch.Tensor:
    """spikes [n_pre] -> currents [n_post]."""
    return ell_spmv_batched(ell, spikes[None, :])[0]


def ell_spmv_delay_batched(ell, spikes: torch.Tensor,
                           n_slots: int) -> torch.Tensor:
    """Fused delay-scatter: spikes [B, n_pre] -> ring contributions
    [B, n_slots, n_post] (slot d = contributions arriving d steps from now,
    before cursor rotation).  Requires ell.delay."""
    if ell.delay is None:
        raise ValueError("ell_spmv_delay needs an ELL with a delay slot")
    return _k.ell_spmv_delay(ell.g, ell.post_ind, ell.valid, ell.delay,
                             spikes.to(torch.float32), ell.n_post, n_slots)


def ell_spmv_delay(ell, spikes: torch.Tensor, n_slots: int) -> torch.Tensor:
    """spikes [n_pre] -> ring contributions [n_slots, n_post]."""
    return ell_spmv_delay_batched(ell, spikes[None, :], n_slots)[0]


def _check_capacity(capacity: int) -> None:
    if not isinstance(capacity, int) or capacity < 1:
        raise ValueError(f"capacity must be a positive int, got {capacity!r}")


def ell_spmv_event(ell, spikes: torch.Tensor, capacity: int) -> torch.Tensor:
    """Event-driven spmv: spikes [n_pre] -> currents [n_post], equal to
    ``ell_spmv``.  ``capacity`` is accepted for the JAX signature; the
    kernel needs no bound on the number of spiking rows."""
    _check_capacity(capacity)
    return ell_spmv(ell, spikes)


def ell_spmv_event_delay(ell, spikes: torch.Tensor, n_slots: int,
                         capacity: int) -> torch.Tensor:
    """Event-driven fused delay-scatter: spikes [n_pre] ->
    [n_slots, n_post], equal to ``ell_spmv_delay``."""
    _check_capacity(capacity)
    return ell_spmv_delay(ell, spikes, n_slots)
