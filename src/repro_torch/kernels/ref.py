"""Plain PyTorch versions of the kernels.

These are the semantics the CUDA kernels are held to (to float tolerance;
exactly with integer-valued weights, whose sums do not depend on the order
of the atomics).  The kernel wrappers take them for tensors that lie on the
CPU; the tests and ``chip_smoke.py`` compare the kernels with them.  They
repeat the kernels' arithmetic with ``index_add_`` over the flattened
``(i, k)`` slots and are no yardstick of speed.

``g`` may carry a leading batch axis (``[B, n_pre, K]``): plastic groups in
a batched run hold one weight matrix per batch member.

The neuron updates take state ``[B, n]`` (or ``[n]``) and parameters that
are scalars or ``[n]``.  They repeat the statements of the codegen'd
``IZHIKEVICH`` and ``make_traubmiles(substeps)`` in the same order, with
``dt`` as a float32 scalar as the simulator hands it to codegen, so on the
CPU they round exactly as codegen does.  HH keeps the TPU kernel's
``n*n*n*n`` (the JAX reference's ``n ** 4`` rounds otherwise).

``flash_attention_ref`` is plain softmax attention with the flash kernel's
masks and casts (see its docstring).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["ell_spmv_ref", "ell_spmv_delay_ref", "izhikevich_step_ref",
           "hh_step_ref", "flash_attention_ref"]


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


def izhikevich_step_ref(v, u, isyn, a, b, c, d, dt):
    """Fused Izhikevich update (two half-steps on V): (v', u', spiked)."""
    dt = torch.as_tensor(dt, dtype=torch.float32)
    v = v + 0.5 * dt * (0.04 * v * v + 5.0 * v + 140.0 - u + isyn)
    v = v + 0.5 * dt * (0.04 * v * v + 5.0 * v + 140.0 - u + isyn)
    u = u + dt * a * (b * v - u)
    v = torch.clamp(v, max=30.0)
    spiked = v >= 29.99
    return torch.where(spiked, c, v), torch.where(spiked, u + d, u), spiked


def _vtrap(x):
    """x / (exp(x) - 1), guarded at the pole (Taylor: 1 - x/2)."""
    return torch.where(x.abs() > 1e-4, x / (torch.exp(x) - 1.0),
                       1.0 - x / 2.0)


def hh_step_ref(v, m, h, n, isyn, dt, substeps=5, gNa=7.15, ENa=50.0,
                gK=1.43, EK=-95.0, gl=0.02672, El=-63.563, C=0.143):
    """Fused Traub-Miles HH update: ``substeps`` Euler substeps of
    dt / substeps; returns (v, m, h, n)."""
    hdt = torch.as_tensor(dt, dtype=torch.float32) / float(substeps)
    for _ in range(substeps):
        imem = -(m * m * m * h * gNa * (v - ENa)
                 + n * n * n * n * gK * (v - EK) + gl * (v - El) - isyn)
        v = v + hdt * imem / C
        a_m = 1.28 * _vtrap((-52.0 - v) / 4.0)
        b_m = 1.4 * _vtrap((v + 25.0) / 5.0)
        a_h = 0.128 * torch.exp((-48.0 - v) / 18.0)
        b_h = 4.0 / (torch.exp((-25.0 - v) / 5.0) + 1.0)
        a_n = 0.16 * _vtrap((-50.0 - v) / 5.0)
        b_n = 0.5 * torch.exp((-55.0 - v) / 40.0)
        m = torch.clamp(m + hdt * (a_m * (1.0 - m) - b_m * m), 0.0, 1.0)
        h = torch.clamp(h + hdt * (a_h * (1.0 - h) - b_h * h), 0.0, 1.0)
        n = torch.clamp(n + hdt * (a_n * (1.0 - n) - b_n * n), 0.0, 1.0)
    return v, m, h, n


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0,
                        softcap: Optional[float] = None,
                        prefix: Optional[int] = None) -> torch.Tensor:
    """Plain softmax attention, computing what the flash kernel computes.

    q: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D] with Hq % Hkv == 0 (query head
    h reads key/value head h // (Hq / Hkv)).  q, k and v are upcast to
    float32; logits = (q . k) * scale (default 1 / sqrt(D)), then
    ``softcap * tanh(logits / softcap)``; query position p = row +
    ``q_offset`` sees key s when (s <= p, or s and p both below ``prefix``)
    under ``causal``, and s > p - ``window`` when a window is given; softmax
    and p . v in float32; a row that sees no key gives 0; the output is cast
    to q's dtype.

    These are the casts of the TPU kernel (``flash_attention_pallas``),
    which upcasts its tiles to float32.  The JAX package's
    ``flash_attention_ref`` differs for bfloat16 inputs: it rounds the
    logits' product and the softmax weights to bfloat16.  For float32
    inputs the two agree."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    logits = torch.matmul(q.float(), kf.transpose(-1, -2)).mul_(s)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device)
    if causal:
        cm = kpos <= qpos
        if prefix is not None:
            cm = cm | ((kpos < prefix) & (qpos < prefix))
        mask &= cm
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(logits.masked_fill_(~mask, float("-inf")), dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros((), device=p.device), p)
    return torch.matmul(p, vf).to(q.dtype)
