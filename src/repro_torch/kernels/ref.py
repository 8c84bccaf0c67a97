"""Plain PyTorch versions of the kernels.

These are the semantics the CUDA kernels are held to (to float tolerance;
exactly with integer-valued weights, whose sums do not depend on the order
of the atomics).  The kernel wrappers take them for tensors that lie on the
CPU; the tests and ``chip_smoke.py`` compare the kernels with them.  They
repeat the kernels' arithmetic with ``index_add_`` over the flattened
``(i, k)`` slots and are no yardstick of speed.

``g`` may carry a leading batch axis (``[B, n_pre, K]``): plastic groups in
a batched run hold one weight matrix per batch member.
"""

from __future__ import annotations

import torch

__all__ = ["ell_spmv_ref", "ell_spmv_delay_ref"]


def _contributions(g: torch.Tensor, valid: torch.Tensor,
                   spikes: torch.Tensor) -> torch.Tensor:
    """[B, n_pre*K] per-slot contributions spikes[b,i] * g[i,k] * valid."""
    gm = torch.where(valid, g, torch.zeros((), dtype=g.dtype,
                                           device=g.device))
    contrib = spikes[:, :, None] * gm                      # [B, n_pre, K]
    return contrib.reshape(spikes.shape[0], -1)


def ell_spmv_ref(g: torch.Tensor, post_ind: torch.Tensor,
                 valid: torch.Tensor, spikes: torch.Tensor,
                 n_post: int) -> torch.Tensor:
    """Batched ELL scatter-accumulate.

    g: [n_pre, K] or [B, n_pre, K];  post_ind, valid: [n_pre, K];
    spikes: [B, n_pre]  ->  [B, n_post]
    out[b, j] = sum_{i,k} spikes[b,i] * g[i,k] * valid[i,k] * (post_ind[i,k]==j)
    """
    flat = _contributions(g, valid, spikes)
    out = torch.zeros((spikes.shape[0], n_post), dtype=flat.dtype,
                      device=flat.device)
    return out.index_add_(1, post_ind.reshape(-1).long(), flat)


def ell_spmv_delay_ref(g: torch.Tensor, post_ind: torch.Tensor,
                       valid: torch.Tensor, delay: torch.Tensor,
                       spikes: torch.Tensor, n_post: int,
                       n_slots: int) -> torch.Tensor:
    """Fused delay-scatter: every synapse's contribution lands at its own
    (delay_slot, post) coordinate in one pass.

    g: [n_pre, K] or [B, n_pre, K];  post_ind, valid, delay: [n_pre, K];
    spikes: [B, n_pre]  ->  [B, n_slots, n_post]
    out[b, d, j] = sum_{i,k} spikes[b,i] * g[i,k] * valid[i,k]
                             * (delay[i,k]==d) * (post_ind[i,k]==j)
    """
    flat = _contributions(g, valid, spikes)
    d = torch.where(valid, delay, torch.zeros((), dtype=delay.dtype,
                                              device=delay.device))
    idx = (d.long() * n_post + post_ind.long()).reshape(-1)
    out = torch.zeros((spikes.shape[0], n_slots * n_post),
                      dtype=flat.dtype, device=flat.device)
    out.index_add_(1, idx, flat)
    return out.reshape(spikes.shape[0], n_slots, n_post)
