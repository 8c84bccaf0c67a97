"""Synaptic propagation ops over the sparse/dense representations.

`accumulate_*` computes the post-synaptic current vector
    I_post[j] = sum_i spike[i] * g[i, j]
for one step, the inner loop the paper's GPU kernels optimize.  Spikes may
be [n_pre] or carry a leading batch axis [B, n_pre].
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.sparse.formats import ELLSynapses

__all__ = ["accumulate_dense", "accumulate_ell"]


def accumulate_dense(w: torch.Tensor, spikes: torch.Tensor) -> torch.Tensor:
    """I = spikes @ W with W: [n_pre, n_post].  A plain matrix product, as
    the JAX package leaves it to XLA; on the card it runs in full float32
    while ``torch.backends.cuda.matmul.allow_tf32`` is False (the
    default)."""
    return spikes.to(w.dtype) @ w


def accumulate_ell(s: ELLSynapses, spikes: torch.Tensor) -> torch.Tensor:
    """Scatter-add over the valid ELL slots, through the ELL spmv kernel
    (its plain version for tensors on the CPU)."""
    if spikes.dim() == 1:
        return kops.ell_spmv(s, spikes)
    return kops.ell_spmv_batched(s, spikes)
