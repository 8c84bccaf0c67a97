"""Plain PyTorch versions of the kernels.

These are the semantics the CUDA kernels are held to (to float tolerance;
exactly with integer-valued weights, whose sums do not depend on the order
of the atomics).  The kernel wrappers take them for tensors that lie on the
CPU; the tests and ``chip_smoke.py`` compare the kernels with them.  They
repeat the kernels' arithmetic with ``index_add_`` over the flattened
``(i, k)`` slots and are no yardstick of speed.  ``ell_spmv_ref`` and
``ell_spmv_delay_ref`` add their float32 products in float64 and round
once, as the kernels do, so each agrees with its kernel bit for bit
whatever order either adds in (see ``csrc/ell_spmv.cu``).
``delay_ring_fold_ref`` is the dendritic ring's update that the fold
kernel fuses: scale, roll, add, read and clear the cursor's slot.

``g`` may carry a leading batch axis (``[B, n_pre, K]``): plastic groups in
a batched run hold one weight matrix per batch member.

``izhikevich_step_ref`` also takes the Izhikevich kernel's input as the
simulator's sequence of eager ops (``_izhikevich_input_ref``): zeros plus
each synapse group's current, plus the thalamic normal draw of the lanes
given, plus the stim, so that on the CPU the fused route equals the
unfused sequence bit for bit.

The neuron updates take state ``[B, n]`` (or ``[n]``) and parameters that
are scalars or ``[n]``.  They repeat the statements of the codegen'd
``IZHIKEVICH`` and ``make_traubmiles(substeps)`` in the same order, with
``dt`` as a float32 scalar as the simulator hands it to codegen, so on the
CPU they round exactly as codegen does.  HH keeps the TPU kernel's
``n*n*n*n`` (the JAX reference's ``n ** 4`` rounds otherwise).  Both take
the NaN guard's flag ``finite`` [B] and clear it in place where a member's
new state is not all finite, as the kernels do in their epilogues.

``flash_attention_ref`` is plain softmax attention with the flash kernel's
masks and casts (see its docstring); ``flash_attention_fwd_ref`` also
returns the rows' log-sum-exp, and ``flash_attention_bwd_ref`` is the
gradient by the recompute schedule of ``repro/kernels/flash_xla.py``.

``ssd_scan_ref`` is the naive Mamba2 state-space recurrence, the oracle of
the chunked SSD (``repro_torch.models.ssm.ssd_chunked``) and its kernel.

``threefry_split_ref`` and ``threefry_draw_ref`` are JAX's threefry2x32
key schedule and draws (``jax_threefry_partitionable``): 32-bit integer
arithmetic done in int64 masked to 32 bits, keys and bits as int32 tensors
holding the uint32 bit patterns.  Keys, bits and uniforms equal
``jax.random``'s bit for bit; normals go through XLA's float32 ``erf_inv``
polynomial (``erf_inv_ref``) and agree within a few ulp, as ``log1p``
differs between libraries.  ``threefry_fold_in_ref`` folds a word into
each of many keys, and the "randint" draw is ``jax.random.randint`` over
int32; ``fma_f32`` is a float32 fused multiply-add rounded once (the
product and sum in float64, rounded to odd, then to float32), the affine
draw's ``lo + (hi - lo) * u`` as XLA's CPU backend contracts it.

``spike_bitmask_ref`` is GeNN's 32x spike packing, as the JAX package's
``bitmask.pack_spikes`` computes it: bool [B, n] -> words [B, W] stored as
int32 with uint32's bit pattern, neuron j at bit j % 32 of word j // 32.
``spike_bitmask_into_ref`` writes such a row into a ring [cap, B, W] at a
slot (and under an active flag) given as device tensors, with index ops
only, as the kernel's ring variant reads them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["ell_spmv_ref", "ell_spmv_delay_ref", "ell_spmv_delay_into_ref",
           "delay_scratch_to_bsn", "delay_ring_fold_ref",
           "izhikevich_step_ref", "hh_step_ref", "flash_attention_ref", "flash_attention_fwd_ref",
           "flash_attention_bwd_ref", "ssd_scan_ref", "chunk_size",
           "threefry2x32_ref", "threefry_split_ref", "threefry_draw_ref",
           "threefry_fold_in_ref", "fma_f32",
           "erf_inv_ref", "DRAWS", "spike_bitmask_ref",
           "spike_bitmask_into_ref"]


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

    The float32 products are summed in float64 and rounded once: the
    correctly rounded sum, in any order of the adds.
    """
    flat = _contributions(g, valid, spikes)
    out = torch.zeros((spikes.shape[0], n_post), dtype=torch.float64,
                      device=flat.device)
    out.index_add_(1, post_ind.reshape(-1).long(), flat.to(torch.float64))
    return out.to(flat.dtype)


def ell_spmv_delay_into_ref(g: torch.Tensor, post_ind: torch.Tensor,
                            valid: torch.Tensor, delay: torch.Tensor,
                            spikes: torch.Tensor, out: torch.Tensor) -> None:
    """The delay scatter added into ``out`` [n_slots, n_post, B] float64 in
    place (the kernel's scratch layout, members side by side): every
    synapse's float32 contribution lands at its own (delay_slot, post)
    cell, summed in float64."""
    flat = _contributions(g, valid, spikes)                # [B, n_pre*K]
    batch, n_post = spikes.shape[0], out.shape[1]
    d = torch.where(valid, delay, torch.zeros((), dtype=delay.dtype,
                                              device=delay.device))
    cell = (d.long() * n_post + post_ind.long()).reshape(1, -1)
    idx = cell * batch + torch.arange(batch, device=cell.device)[:, None]
    out.view(-1).index_add_(0, idx.reshape(-1),
                            flat.reshape(-1).to(torch.float64))


def delay_scratch_to_bsn(acc: torch.Tensor) -> torch.Tensor:
    """A delay scratch [n_slots, n_post, B] float64 as the delay scatter's
    result [B, n_slots, n_post] float32, rounded once (one copy)."""
    out = torch.empty((acc.shape[2], acc.shape[0], acc.shape[1]),
                      dtype=torch.float32, device=acc.device)
    return out.copy_(acc.permute(2, 0, 1))


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

    The float32 products are summed in float64 and rounded once.
    """
    acc = torch.zeros((n_slots, n_post, spikes.shape[0]),
                      dtype=torch.float64, device=g.device)
    ell_spmv_delay_into_ref(g, post_ind, valid, delay, spikes, acc)
    return delay_scratch_to_bsn(acc)


def delay_ring_fold_ref(ring: torch.Tensor, acc: torch.Tensor,
                        cursor: torch.Tensor, sign: float, gscale) -> tuple:
    """One step of the dendritic ring [B, S, n_post] float32: the delay
    scatter ``acc`` [S, n_post, B] float64 (slot d = currents due d steps
    from now), rounded to float32 and scaled by ``sign * gscale`` (a scalar
    or [B]), lands at member b's ring row (c_b + d) % S, c_b =
    ``cursor[b]`` mod S (``cursor`` an int32 [B] tensor, read by index ops
    and never on the host); member b's row c_b is read out and cleared.
    Returns (new_ring, inj [B, n_post], new_cursor = (c + 1) mod S [B]),
    all fresh tensors; ``ring`` is left as it is and ``acc`` is zeroed, as
    the fold kernel leaves them."""
    contrib = delay_scratch_to_bsn(acc)
    acc.zero_()
    if isinstance(gscale, torch.Tensor) and gscale.dim() == 1:
        gscale = gscale.reshape((-1,) + (1,) * (contrib.dim() - 1))
    contrib = sign * gscale * contrib
    batch, n_slots, n_post = ring.shape
    cur = torch.remainder(cursor.reshape(batch, 1).long(), n_slots)
    rows = torch.remainder(
        torch.arange(n_slots, device=ring.device) - cur, n_slots)
    new_ring = ring + torch.gather(
        contrib, 1, rows[:, :, None].expand(batch, n_slots, n_post))
    at = cur[:, :, None].expand(batch, 1, n_post)
    inj = torch.gather(new_ring, 1, at)[:, 0]
    new_ring.scatter_(1, at, 0.0)
    new_cursor = torch.remainder(cur[:, 0] + 1, n_slots).to(torch.int32)
    return new_ring, inj, new_cursor


def _clear_if_not_finite(finite, *arrays) -> None:
    """The NaN guard's flag: clear ``finite`` [B] in place for each member
    whose row of any array is not all finite (the fold the simulator makes
    for codegen'd populations, in its order)."""
    if finite is not None:
        for arr in arrays:
            finite &= torch.isfinite(arr).all(dim=-1)


def _izhikevich_input_ref(v, isyn=None, currents=None, drive=None,
                          stim=None):
    """A population's summed input as the simulator builds it op by op:
    ``isyn``, or zeros plus each of ``currents`` in order; plus the drive
    (``(keys, scale, first, n_real)``: each member's normal of the lanes
    ``first + j`` for ``j < n_real`` times the float32 scale, as
    ``random.normal`` draws it, zeros past ``n_real``); plus ``stim``."""
    if (isyn is None) == (currents is None):
        raise ValueError("give isyn or currents, not both")
    if currents is not None:
        isyn = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for cur in currents:
            isyn = isyn + cur
    if drive is not None:
        keys, scale, first, n_real = drive
        noise = _draw_lanes_ref(keys, torch.arange(
            first, first + n_real, dtype=torch.int64, device=keys.device),
            "normal", scale)
        pad = v.shape[-1] - n_real
        if pad:
            noise = torch.nn.functional.pad(noise, (0, pad))
        isyn = isyn + noise.reshape(v.shape)
    if stim is not None:
        isyn = isyn + stim
    return isyn


def izhikevich_step_ref(v, u, isyn, a, b, c, d, dt, finite=None, *,
                        currents=None, drive=None, stim=None):
    """Fused Izhikevich update (two half-steps on V): (v', u', spiked);
    clears ``finite`` [B] where v' or u' is not all finite.  The input is
    ``_izhikevich_input_ref``'s: ``isyn``, or ``currents`` summed, plus the
    drive and the stim where given."""
    isyn = _izhikevich_input_ref(v, isyn, currents, drive, stim)
    dt = torch.as_tensor(dt, dtype=torch.float32)
    v = v + 0.5 * dt * (0.04 * v * v + 5.0 * v + 140.0 - u + isyn)
    v = v + 0.5 * dt * (0.04 * v * v + 5.0 * v + 140.0 - u + isyn)
    u = u + dt * a * (b * v - u)
    v = torch.clamp(v, max=30.0)
    spiked = v >= 29.99
    v, u = torch.where(spiked, c, v), torch.where(spiked, u + d, u)
    _clear_if_not_finite(finite, v, u)
    return v, u, spiked


def _vtrap(x):
    """x / (exp(x) - 1), guarded at the pole (Taylor: 1 - x/2)."""
    return torch.where(x.abs() > 1e-4, x / (torch.exp(x) - 1.0),
                       1.0 - x / 2.0)


def hh_step_ref(v, m, h, n, isyn, dt, substeps=5, gNa=7.15, ENa=50.0,
                gK=1.43, EK=-95.0, gl=0.02672, El=-63.563, C=0.143,
                finite=None):
    """Fused Traub-Miles HH update: ``substeps`` Euler substeps of
    dt / substeps; returns (v, m, h, n, above = v >= 0); clears ``finite``
    [B] where v, m, h or n is not all finite."""
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
    _clear_if_not_finite(finite, v, m, h, n)
    return v, m, h, n, v >= 0.0


def _attn_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: Optional[int], prefix: Optional[int]) -> torch.Tensor:
    """[len(qpos), len(kpos)]: which keys each query position sees."""
    mask = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        cm = kpos[None, :] <= qpos[:, None]
        if prefix is not None:
            cm = cm | ((kpos[None, :] < prefix) & (qpos[:, None] < prefix))
        mask &= cm
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None, q_offset: int = 0,
                            softcap: Optional[float] = None,
                            prefix: Optional[int] = None):
    """(out, lse): ``flash_attention_ref``'s output and the log-sum-exp of
    each row's visible logits, ``[B, Hq, Tq]`` in float32 (``-inf`` for a
    row that sees no key, as ``flash_xla.py`` writes it)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    logits = torch.matmul(q.float(), kf.transpose(-1, -2)).mul_(s)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _attn_mask(torch.arange(tq, device=q.device) + q_offset,
                      torch.arange(tk, device=q.device), causal, window,
                      prefix)
    logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros((), device=p.device), p)
    return torch.matmul(p, vf).to(q.dtype), lse


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
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset,
                                   softcap=softcap, prefix=prefix)[0]


def chunk_size(t: int, pref: int) -> int:
    """The JAX package's chunk rule (``flash_xla._chunks``, ``ssd_chunked``):
    min(pref, t), halved until it divides t."""
    c = min(pref, t)
    while t % c:
        c //= 2
    return c


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None, q_offset: int = 0,
                            softcap: Optional[float] = None,
                            prefix: Optional[int] = None,
                            q_chunk: int = 512, k_chunk: int = 1024):
    """(dq, dk, dv) of attention from its saved (q, k, v, o, lse) and the
    output's gradient ``do``, by ``flash_xla.py``'s recompute schedule
    (``_bwd``), over chunks of ``q_chunk`` queries and ``k_chunk`` keys, the
    last ones shorter where they do not divide T (the JAX package halves
    its chunks until they divide T: chunks of 4 at whisper's 1500 frames,
    ~10^5 blocks a call): per (query chunk, key chunk) block the
    probabilities are
    recomputed as exp(logits - lse), masked to 0 where the key is hidden
    (and so everywhere in a row with lse = -inf); delta = rowsum(do * o);
    dS = P (dP - delta), times 1 - tanh^2(raw / softcap) under a softcap,
    times the scale.  GQA sums the query heads of a KV head into its dk
    and dv.  Float32 throughout; the gradients are cast to the inputs'
    dtypes."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qc, kc = min(q_chunk, tq), min(k_chunk, tk)
    qf = q.float().reshape(b, hkv, rep, tq, d)
    gf = do.float().reshape(b, hkv, rep, tq, d)
    delta = (gf * o.float().reshape(b, hkv, rep, tq, d)).sum(-1)
    lse = lse.float().reshape(b, hkv, rep, tq)
    lse_safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    kf, vf = k.float(), v.float()
    dq = torch.zeros_like(qf)
    dk = torch.zeros(b, hkv, tk, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    zero = torch.zeros((), device=q.device)
    for q0 in range(0, tq, qc):
        q1 = min(q0 + qc, tq)
        qpos = torch.arange(q0, q1, device=q.device) + q_offset
        qb, gb = qf[:, :, :, q0:q1], gf[:, :, :, q0:q1]
        lb = lse_safe[..., q0:q1, None]
        db = delta[..., q0:q1, None]
        for k0 in range(0, tk, kc):
            k1 = min(k0 + kc, tk)
            kb, vb = kf[:, :, k0:k1], vf[:, :, k0:k1]
            msk = _attn_mask(qpos, torch.arange(k0, k1, device=q.device),
                             causal, window, prefix)
            raw = torch.einsum("bgrqd,bgkd->bgrqk", qb, kb) * s
            capped = (softcap * torch.tanh(raw / softcap)
                      if softcap is not None else raw)
            p = torch.where(msk, torch.exp(capped - lb), zero)
            dv[:, :, k0:k1] += torch.einsum("bgrqk,bgrqd->bgkd", p, gb)
            dp = torch.einsum("bgrqd,bgkd->bgrqk", gb, vb)
            ds = p * (dp - db)
            if softcap is not None:
                th = torch.tanh(raw / softcap)
                ds = ds * (1.0 - th * th)
            ds = ds * s
            dq[:, :, :, q0:q1] += torch.einsum("bgrqk,bgkd->bgrqd", ds, kb)
            dk[:, :, k0:k1] += torch.einsum("bgrqk,bgrqd->bgkd", ds, qb)
    return (dq.reshape(b, hq, tq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def ssd_scan_ref(x, dt, A, B, C, D=None):
    """Mamba2 SSD by its naive sequential recurrence (the oracle).

    x [b, t, h, dh]; dt [b, t, h] (softplus'd, > 0); A [h] (< 0);
    B, C [b, t, g, ds] (g groups, each shared by h / g heads); D [h] or
    None.  State s [b, h, dh, ds]: s' = exp(dt A) s + (dt x) outer B,
    y = s' . C (+ D x).  Returns y [b, t, h, dh]."""
    b, t, h, dh = x.shape
    rep = h // B.shape[2]
    Bh = B.repeat_interleave(rep, dim=2)
    Ch = C.repeat_interleave(rep, dim=2)
    st = torch.zeros(b, h, dh, B.shape[3], dtype=x.dtype, device=x.device)
    ys = []
    for i in range(t):
        decay = torch.exp(dt[:, i] * A[None, :])[:, :, None, None]
        st = st * decay + (dt[:, i, :, None] * x[:, i])[..., None] \
            * Bh[:, i, :, None, :]
        ys.append(torch.einsum("bhds,bhs->bhd", st, Ch[:, i]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + x * D[None, None, :, None]
    return y


# -- threefry2x32 -------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
DRAWS = ("bits", "uniform", "normal", "randint")
# normal's uniform range starts at nextafter(-1, 0) in float32
_NORMAL_LO = -0.99999994039535522
# XLA's float32 erf_inv (Giles): coefficients for w < 5 and for w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_SQRT2_F32 = 1.41421354


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits (or any integers) as int64 in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) as int32 with the same bits."""
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


def threefry2x32_ref(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counters (x0, x1) under key
    (k0, k1), all int64 tensors in [0, 2^32) (broadcast together); returns
    the two output words the same way.  The rounds run in place on int32
    words: int32 addition wraps as uint32 addition does, and a rotation's
    right shift keeps only the low bits the arithmetic shift brings down."""
    shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    ks = (_as_i32(k0), _as_i32(k1), _as_i32(k0 ^ k1 ^ 0x1BD11BDA))
    y0 = (_as_i32(x0) + ks[0]).expand(shape).contiguous()
    y1 = (_as_i32(x1) + ks[1]).expand(shape).contiguous()
    low = torch.empty_like(y1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0.add_(y1)
            torch.bitwise_right_shift(y1, 32 - r, out=low)
            low.bitwise_and_((1 << r) - 1)
            y1.bitwise_left_shift_(r).bitwise_or_(low).bitwise_xor_(y0)
        y0.add_(ks[(i + 1) % 3])
        y1.add_(ks[(i + 2) % 3]).add_(i + 1)
    return _u32(y0), _u32(y1)


def _key_words(keys: torch.Tensor):
    k = _u32(keys)
    return k[:, 0:1], k[:, 1:2]


def threefry_split_ref(keys: torch.Tensor, num: int,
                       first: int = 0) -> torch.Tensor:
    """keys [B, 2] -> [B, num, 2]: member b's key i hashes the counter
    (0, first + i) under keys[b], as ``jax.random.split`` (first 0) and
    ``fold_in(key, first)`` (num 1) do."""
    k0, k1 = _key_words(keys)
    lo = torch.arange(num, dtype=torch.int64, device=keys.device) + first
    b0, b1 = threefry2x32_ref(k0, k1, torch.zeros_like(lo), lo)
    return _as_i32(torch.stack([b0, b1], dim=-1))


def sqrt_f32(w: torch.Tensor) -> torch.Tensor:
    """float32 sqrt of ``w``, correctly rounded whatever the library's
    sqrt returns: two Newton steps in float64 from it, then the float32
    root moved to the neighbour whose rounding interval holds the exact
    root (a midpoint of two float32 numbers, squared, is exact in float64
    and never equals a float32 w).  On the CPU, torch's sqrt of a large
    tensor goes to MKL on its worker threads, and a whole thread's chunk
    of a process's first call has come back ~1e-4 off."""
    w64 = w.double()
    s = torch.sqrt(w64)
    ok = torch.isfinite(s) & (s > 0)
    for _ in range(2):
        s = torch.where(ok, 0.5 * (s + w64 / s), s)
    c = s.float()
    c64 = c.double()
    below = torch.nextafter(c, torch.zeros_like(c))
    above = torch.nextafter(c, torch.full_like(c, float("inf")))
    c = torch.where(ok & (((c64 + below.double()) * 0.5) ** 2 > w64),
                    below, c)
    return torch.where(ok & (((c64 + above.double()) * 0.5) ** 2 < w64),
                       above, c)


def erf_inv_ref(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv as its CPU backend computes it: w =
    -log1p(-x*x); Giles' polynomial in w - 2.5 (w < 5) or sqrt(w) - 3 by
    Horner steps that XLA contracts into fused multiply-adds (here the
    product and sum in float64, rounded to float32 once); times x; +-inf
    at +-1."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    z = torch.where(small, w - 2.5, sqrt_f32(w) - 3.0).double()

    def coef(i):
        return torch.where(small, torch.tensor(_ERFINV_SMALL[i]),
                           torch.tensor(_ERFINV_LARGE[i])).double()
    p = coef(0).float()
    for i in range(1, len(_ERFINV_SMALL)):
        p = (coef(i) + p.double() * z).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as ``fmaf`` rounds it: the
    product of two float32 numbers is exact in float64, their sum with c
    is rounded there to odd (the nearest float64, moved one step towards
    the exact sum where it is inexact and its last bit even), and that
    rounds to the nearest float32 as the exact sum would."""
    a = a.double()
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device).double()
    c = torch.as_tensor(c, dtype=torch.float32, device=a.device).double()
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)          # p + c == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def threefry_draw_ref(keys: torch.Tensor, n: int, dist: str,
                      scale: float = 1.0, offset: Optional[float] = None, *,
                      lo: int = 0, span: Optional[int] = None
                      ) -> torch.Tensor:
    """keys [B, 2] -> [B, n]: member b's ``jax.random.bits`` (int32 holding
    the uint32 bits), ``uniform`` in [0, 1) or ``normal`` of shape (n,)
    under keys[b] (element j hashes the counter (j >> 32, j & 0xFFFFFFFF)
    and keeps the xor of the two words).  Draws are float32; ``scale``
    (float32) multiplies them after the draw, or with an ``offset``
    ``fma_f32(draw, scale, offset)``.  The "randint" draw is int32
    ``jax.random.randint(keys[b], (n,), lo, lo + span)`` (``_randint_ref``)."""
    if dist not in DRAWS:
        raise ValueError(f"dist must be one of {DRAWS}, got {dist!r}")
    if dist == "randint":
        return _randint_ref(keys, n, lo, span)
    return _draw_lanes_ref(keys, torch.arange(n, dtype=torch.int64,
                                              device=keys.device),
                           dist, scale, offset)


def _draw_lanes_ref(keys: torch.Tensor, j: torch.Tensor, dist: str,
                    scale: float = 1.0, offset: Optional[float] = None
                    ) -> torch.Tensor:
    """``threefry_draw_ref``'s bits, uniform or normal draw of the
    elements ``j`` (int64 [m]) only: [B, m]."""
    k0, k1 = _key_words(keys)
    b0, b1 = threefry2x32_ref(k0, k1, j >> 32, j & _M32)
    bits = b0 ^ b1
    if dist == "bits":
        return _as_i32(bits)
    # 23 random mantissa bits under the exponent of 1.0: [1, 2), minus 1
    f = _as_i32((bits >> 9) | 0x3F800000).view(torch.float32) - 1.0
    if dist == "normal":
        u = torch.clamp(f * 2.0 + _NORMAL_LO, min=_NORMAL_LO)
        f = erf_inv_ref(u) * _SQRT2_F32
    if offset is not None:
        return fma_f32(f, scale, offset)
    return f * scale if scale != 1.0 else f


def threefry_fold_in_ref(keys: torch.Tensor, data) -> torch.Tensor:
    """keys [B, 2] (or [1, 2] for every row) and data (an int32 [B] tensor
    of uint32 bits, or one uint32) -> [B, 2]: ``fold_in(keys[b],
    data[b])``, the hash of the counter (0, data[b])."""
    k0, k1 = _key_words(keys)
    if isinstance(data, torch.Tensor):
        d = _u32(data)
    else:
        d = torch.full((keys.shape[0],), int(data) & _M32,
                       dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32_ref(k0[:, 0], k1[:, 0], torch.zeros_like(d), d)
    return _as_i32(torch.stack([b0, b1], dim=-1))


def _rem_u32(x: torch.Tensor, span: int) -> torch.Tensor:
    """x mod span for x in [0, 2^32), and x where span is 0 (XLA's unsigned
    remainder by zero)."""
    return x % span if span else x


def _randint_ref(keys: torch.Tensor, n: int, lo: int,
                 span: int) -> torch.Tensor:
    """keys [R, 2] -> [R, n] int32: ``jax.random.randint(keys[r], (n,),
    lo, lo + span)`` for an int32 ``lo`` and a uint32 ``span`` (0 standing
    for 2^32): k1, k2 = split(key); offset = ((hi mod span) * m + lo_bits
    mod span) mod span in uint32 arithmetic, m = (2^16 mod span)^2 mod
    span; uint32 held in int64."""
    sub = threefry_split_ref(keys, 2)
    hi = _u32(threefry_draw_ref(sub[:, 0], n, "bits"))
    lob = _u32(threefry_draw_ref(sub[:, 1], n, "bits"))
    m0 = 65536 % span if span else 65536
    mult = ((m0 * m0) & _M32) % span if span else (m0 * m0) & _M32
    off = _rem_u32(((_rem_u32(hi, span) * mult) + _rem_u32(lob, span))
                   & _M32, span)
    return _as_i32((off + (int(lo) & _M32)) & _M32)


# -- spike bitmask -------------------------------------------------------------

def spike_bitmask_ref(bits: torch.Tensor) -> torch.Tensor:
    """bool [B, n] -> int32 [B, max(1, ceil(n / 32))]: neuron j is bit
    j % 32 of word j // 32 (least significant first), trailing bits zero.
    The shifted bits are summed in int64 (bit 31 overflows int32) and the
    sum wrapped to int32 once."""
    n = bits.shape[-1]
    w = max(1, -(-n // 32))
    b = bits.to(torch.int64)
    b = torch.nn.functional.pad(b, (0, w * 32 - n))
    b = b.reshape(b.shape[:-1] + (w, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    # the bits are disjoint within a word, so the sum is exact (< 2^32)
    return _as_i32((b << shifts).sum(dim=-1))


def spike_bitmask_into_ref(bits: torch.Tensor, ring: torch.Tensor,
                           slot: torch.Tensor,
                           active: Optional[torch.Tensor] = None) -> None:
    """Row ``slot`` (an int32 0-dim tensor) of ``ring`` [cap, B, W] set to
    ``spike_bitmask_ref(bits)``, unless ``active`` (a bool 0-dim tensor) is
    False; no value is read on the host."""
    words = spike_bitmask_ref(bits)
    row = slot.reshape(1).long()
    if active is not None:
        words = torch.where(active, words, ring.index_select(0, row)[0])
    ring.index_copy_(0, row, words[None])
