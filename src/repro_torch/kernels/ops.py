"""Container-level ops, one signature per op.

Counterpart of ``repro/kernels/ops.py`` for the ELL spmv family, the fused
neuron updates, flash attention and the SSD scan, plus the dendritic ring's
scatter-and-fold (``ell_spmv_delay_into``, ``delay_ring_fold``) and GeNN's
spike bitmask (``pack_spikes``, ``pack_spikes_into``).  There is
no backend switch: each op goes by the device its tensors lie on (see
``repro_torch.kernels._dispatch``).

The event-driven variants keep the JAX signatures and run the same kernel.
The kernel reads nothing of a row whose spike is 0, which is the work the
TPU's row compaction saves, so no compaction, capacity or dense fallback is
needed and the result is the dense pass's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import delay_ring as _ring
from repro_torch.kernels import ell_spmv as _k
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hh_step as _hh
from repro_torch.kernels import izhikevich_step as _iz
from repro_torch.kernels import spike_bitmask as _bm
from repro_torch.kernels import ssd_scan as _ssd

__all__ = ["ell_spmv", "ell_spmv_batched", "ell_spmv_delay",
           "ell_spmv_delay_batched", "ell_spmv_delay_into",
           "delay_ring_fold", "ell_spmv_event",
           "ell_spmv_event_delay", "izhikevich_step", "hh_step",
           "flash_attention", "ssd_scan", "ssd_scan_state", "pack_spikes",
           "pack_spikes_into"]


def _spikes(spikes: torch.Tensor) -> torch.Tensor:
    """The kernels read bool and float32 spikes as they are (no cast on
    the simulator's path); other types are cast to float32."""
    if spikes.dtype not in (torch.bool, torch.float32):
        spikes = spikes.to(torch.float32)
    return spikes


def ell_spmv_batched(ell, spikes: torch.Tensor) -> torch.Tensor:
    """spikes [B, n_pre] -> currents [B, n_post]."""
    return _k.ell_spmv(ell.g, ell.post_ind, ell.valid, _spikes(spikes),
                       ell.n_post)


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
                             _spikes(spikes), ell.n_post, n_slots)


def ell_spmv_delay_into(ell, spikes: torch.Tensor,
                        acc: torch.Tensor) -> None:
    """The fused delay-scatter of spikes [B, n_pre] added into ``acc``
    [n_slots, n_post, B] float64 in place (the scratch that
    ``delay_ring_fold`` folds into the ring and zeroes)."""
    if ell.delay is None:
        raise ValueError("ell_spmv_delay needs an ELL with a delay slot")
    _k.ell_spmv_delay_into(ell.g, ell.post_ind, ell.valid, ell.delay,
                           _spikes(spikes), acc)


def delay_ring_fold(ring: torch.Tensor, acc: torch.Tensor,
                    cursor: torch.Tensor, sign: float, gscale):
    """(new_ring, inj, new_cursor): the scratch ``acc`` scaled by sign *
    gscale and rolled by each member's ``cursor`` (an int32 [B] tensor)
    into the ring [B, S, n_post], then each cursor's row read out and
    cleared and the cursors advanced; ``acc`` is left zeroed."""
    return _ring.delay_ring_fold(ring, acc, cursor, sign, gscale)


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


# -- fused neuron updates -----------------------------------------------------

def izhikevich_step(v, u, isyn, a, b, c, d, dt: float):
    """Fused Izhikevich update: state [n] or [B, n]; a..d scalars or [n]
    (broadcast to [n] float32 on v's device, as the JAX entry point does).
    Returns (v', u', spiked)."""
    n = v.shape[-1]

    def bcast(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=v.device).broadcast_to((n,)).contiguous()

    return _iz.izhikevich_step(v, u, isyn, bcast(a), bcast(b), bcast(c),
                               bcast(d), dt)


def hh_step(v, m, h, n, isyn, dt: float, **params):
    """Fused Traub-Miles HH update; params: ``substeps`` and the seven
    scalar conductances/potentials of ``hh_step.hh_step``.  Returns
    (v, m, h, n), as the JAX entry point does."""
    return _hh.hh_step(v, m, h, n, isyn, dt, **params)[:4]


# -- spike bitmask ------------------------------------------------------------

def pack_spikes(bits: torch.Tensor) -> torch.Tensor:
    """bool [B, n] -> GeNN's 32x bitmask words int32 [B, ceil(n / 32)]
    (``repro/core/snn/bitmask.py``'s layout, uint32 bits in int32)."""
    return _bm.spike_bitmask(bits)


def pack_spikes_into(bits: torch.Tensor, ring: torch.Tensor, slot,
                     active: Optional[torch.Tensor] = None) -> None:
    """The words of bits [B, n] written as row ``slot`` of ring
    [cap, B, W] (slot and active may be device tensors, see
    ``spike_bitmask.spike_bitmask_into``)."""
    _bm.spike_bitmask_into(bits, ring, slot, active)


# -- LM kernels ---------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    softcap: Optional[float] = None,
                    prefix: Optional[int] = None):
    """q [B, Hq, Tq, D]; k, v [B, Hkv, Tk, D] -> [B, Hq, Tq, D], with a
    gradient (``FlashAttention``: the forward kernel and the backward
    kernels on the card, their plain versions on the CPU).

    CPU tensors take the plain versions, CUDA tensors the kernels, whatever
    the options: the kernels compute prefix-LM masking too (the JAX entry
    point sends ``prefix`` to XLA, though its Pallas kernel has the mask).
    ``window`` is a Python int or None; the JAX package's roofline stand-ins
    and its traced-window route have no counterpart here."""
    return _fa.FlashAttention.apply(q, k, v, causal, window, scale,
                                    q_offset, softcap, prefix)


def ssd_scan(x, dt, A, B, C, D=None):
    """Mamba2 SSD: x [b, t, h, dh], dt [b, t, h], A [h], B/C [b, t, 1, ds],
    D [h] or None -> y [b, t, h, dh], with a gradient (``SSDScan``: the
    kernel forward on the card, ``ssd_chunked`` on the CPU; the backward is
    autograd through ``ssd_chunked`` on both, as the JAX package trains).
    The JAX entry point's roofline stand-in has no counterpart here."""
    return _ssd.SSDScan.apply(x, dt, A, B, C, D)


def ssd_scan_state(x, dt, A, B, C, D=None, initial_state=None):
    """Mamba2 SSD for prefill: (y [b, t, h, dh], the state after the last
    chunk [b, h, ds, dh] float32).  The kernel with its final state on the
    card (from a zero state), ``ssd_chunked(..., return_final_state=True)``
    on the CPU; no gradient."""
    return _ssd.ssd_scan_state(x, dt, A, B, C, D, initial_state)
