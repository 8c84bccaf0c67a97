"""Mamba2 (SSD, state-space duality) blocks, the counterpart of
``repro/models/ssm.py``.

``ssd_chunked`` is the O(T) chunked algorithm in plain torch: inside a
chunk the recurrence is computed in its quadratic "dual" (attention-like)
form, and the state passes from chunk to chunk.  ``ssm_apply`` runs the
full-sequence block (input projection to [z | x | B | C | dt], causal
depthwise conv on (x, B, C), the SSD core through ``kernels.ops.ssd_scan``,
gated RMSNorm, output projection): the hand-written kernel on the card,
its plain version (``ssd_chunked``) on the CPU.

The recurrent forms serve prefill and decode: ``ssm_apply(return_state=
True)`` also returns the block's state after the prompt (the conv
history, the padded input's last ``d_conv - 1`` rows before the conv, and
the SSD state after the last chunk, float32 ``[b, h, ds, dh]``), the SSD
through the same kernel, which then writes its final state
(``kernels.ops.ssd_scan_state``); ``ssm_init_cache`` makes the float32
caches and ``ssm_decode_step`` runs one token in O(1), in plain torch
with the JAX package's float32 promotions.

With a mesh active and the heads divisible by "model", each rank runs its
block of the heads (the JAX package's ``shard(xs, "batch", None, "heads",
None)``): the input projection ``w_in`` concatenates z, x, B, C and dt,
so a contiguous block of its columns is not a block of heads; it is
joined and projected whole (as are the conv over x, B and C and its
cache), then each rank takes its heads' z, x and dt (``shard``), B and C
(their group block, or whole for one group), runs the SSD on its heads,
normalises with the sum of squares reduced over "model", and
``w_out``'s partial sums reduce.  The SSD cache holds the rank's heads.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import chunk_size
from repro_torch.models import layers as L
from repro_torch.models.layers import dense_init, rmsnorm

__all__ = ["SSMConfig", "ssm_init", "ssm_apply", "ssm_decode_step",
           "ssm_init_cache", "ssd_chunked", "chunk_size"]

@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128          # N: SSM state size per head
    d_head: int = 64            # P: channels per head
    expand: int = 2
    n_groups: int = 1           # B/C groups (like KV heads)
    d_conv: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.d_head


def ssm_init(gen: torch.Generator, cfg: SSMConfig, dtype=torch.float32):
    """Random block weights on ``gen``'s device with the JAX initializers'
    distributions; ``dt_bias``, ``A_log`` and ``D`` stay float32 whatever
    ``dtype`` is, as in the JAX package."""
    d, di, g, n, hh = (cfg.d_model, cfg.d_inner, cfg.n_groups, cfg.d_state,
                       cfg.n_heads)
    dev = gen.device
    d_in_proj = 2 * di + 2 * g * n + hh
    conv_dim = di + 2 * g * n
    w_in = dense_init(gen, d, d_in_proj, dtype)
    conv_w = (torch.randn((cfg.d_conv, conv_dim), generator=gen, device=dev)
              / math.sqrt(cfg.d_conv)).to(dtype)
    # dt bias: softplus^-1 of log-uniform(dt_min, dt_max) samples
    u = torch.rand((hh,), generator=gen, device=dev)
    dt0 = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                    + math.log(cfg.dt_min))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    a0 = 1.0 + 15.0 * torch.rand((hh,), generator=gen, device=dev)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "dt_bias": dt_bias,
        "A_log": torch.log(a0),
        "D": torch.ones(hh, dtype=torch.float32, device=dev),
        "norm_scale": torch.zeros(di, dtype=dtype, device=dev),
        "w_out": dense_init(gen, di, d, dtype),
    }


# ---------------------------------------------------------------------------
# chunked SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B, C, D=None, chunk: int = 256,
                initial_state=None, return_final_state: bool = False):
    """O(T) chunked SSD, the plain version of the ``ssd_scan`` kernel.
    x [b, t, h, dh], dt [b, t, h], A [h], B/C [b, t, g, ds] -> y [b, t, h,
    dh], and with ``return_final_state`` the state after the last chunk
    [b, h, ds, dh]; ``initial_state`` (default zeros) is the state entering
    the first chunk.  Differentiable by autograd (the kernel's backward
    recomputes it)."""
    b, t, h, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    rep = h // g
    q = chunk_size(t, chunk)
    nc = t // q

    Bh = B.repeat_interleave(rep, dim=2)             # [b,t,h,ds]
    Ch = C.repeat_interleave(rep, dim=2)

    la = dt * A[None, None, :]                       # [b,t,h] (negative)
    xc = x.reshape(b, nc, q, h, dh)
    dtc = dt.reshape(b, nc, q, h)
    lac = la.reshape(b, nc, q, h)
    Bc = Bh.reshape(b, nc, q, h, ds)
    Cc = Ch.reshape(b, nc, q, h, ds)

    cum = torch.cumsum(lac, dim=2)                   # within-chunk logs
    total = cum[:, :, -1]                            # [b,nc,h]

    # intra-chunk (dual form), i >= j:
    #   att[i,j] = C_i . B_j * exp(cum_i - cum_j) * dt_j
    # the upper triangle (cum_i - cum_j > 0, which can overflow) is masked
    # before it is exponentiated, so neither it nor its gradient is inf*0
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b,nc,q,q,h]
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    mask = mask[None, None, :, :, None]
    dec = torch.where(mask, torch.exp(diff.masked_fill(~mask, 0.0)),
                      torch.zeros((), dtype=diff.dtype, device=x.device))
    cb = torch.einsum("bcihs,bcjhs->bcijh", Cc, Bc)
    att = cb * dec * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", att, xc)

    # chunk states: S_c = sum_j exp(total - cum_j) * dt_j * B_j x_j^T
    w = torch.exp(total[:, :, None, :] - cum) * dtc          # [b,nc,q,h]
    S = torch.einsum("bcjh,bcjhs,bcjhd->bchsd", w, Bc, xc)   # [b,nc,h,ds,dh]

    # inter-chunk: the state entering each chunk
    s_prev = (initial_state if initial_state is not None else
              torch.zeros(b, h, ds, dh, dtype=x.dtype, device=x.device))
    prevs = []
    for c in range(nc):
        prevs.append(s_prev)
        s_prev = s_prev * torch.exp(total[:, c])[:, :, None, None] + S[:, c]
    s_prevs = torch.stack(prevs, dim=1)                      # [b,nc,h,ds,dh]

    # y_inter[i] = C_i . (exp(cum_i) * S_prev)
    y_inter = torch.einsum("bcihs,bchsd->bcihd",
                           Cc * torch.exp(cum)[..., None], s_prevs)

    y = (y_intra + y_inter).reshape(b, t, h, dh)
    if D is not None:
        y = y + x * D[None, None, :, None]
    if return_final_state:
        return y, s_prev
    return y


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------

def _local_heads(cfg: SSMConfig):
    """This rank's number of heads with a mesh active, None when they run
    whole."""
    if not L.parallel() or cfg.n_heads % L.model_size():
        return None
    return cfg.n_heads // L.model_size()


def _to_local_heads(cfg: SSMConfig, z, xs, dt, Bm, Cm):
    """Each rank's block of the heads of z [.., di], xs [.., h, dh], dt
    [.., h] and of the groups of B / C [.., g, n] (a group per local head
    when the groups and the axis do not divide evenly; one group is kept
    whole), all of them whole on the model ranks before."""
    mp = L.model_size()
    z = L.model_split(z, -1)
    xs = L.shard(xs, *(["batch"] + [None] * (xs.dim() - 3)
                       + ["heads", None]))
    dt = L.model_split(dt, -1)
    g = Bm.shape[-2]
    if g == 1:
        Bm, Cm = L.model_enter(Bm), L.model_enter(Cm)
    else:
        if g % mp:
            rep = cfg.n_heads // g
            Bm = Bm.repeat_interleave(rep, dim=-2)
            Cm = Cm.repeat_interleave(rep, dim=-2)
        Bm, Cm = L.model_split(Bm, -2), L.model_split(Cm, -2)
    return z, xs, dt, Bm, Cm


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                d_inner: int, tp: bool) -> torch.Tensor:
    """rmsnorm(y * silu(z)) over d_inner; with ``tp`` y and z hold this
    rank's block and the sum of squares reduces over "model"."""
    if not tp:
        return rmsnorm(y * F.silu(z), scale)
    x = y * F.silu(z)
    dt = x.dtype
    x = x.float()
    # the whole sum, on every rank, then used by this rank's block alone
    ss = L.model_enter(L.model_reduce(torch.sum(x * x, dim=-1,
                                                keepdim=True)))
    x = x * torch.rsqrt(ss / d_inner + 1e-6)
    return (x * (1.0 + scale.float())).to(dt)


def _split_proj(cfg: SSMConfig, zxbcdt: torch.Tensor):
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, xbc, dt


def ssm_apply(p, cfg: SSMConfig, u: torch.Tensor, conv_state=None,
              ssd_state=None, return_state: bool = False):
    """u: [B, T, d_model] -> [B, T, d_model] (full sequence); with
    ``return_state`` also (conv state [B, d_conv - 1, conv_dim] in u's
    dtype, SSD state [B, h, ds, dh] float32).  ``conv_state`` replaces the
    zero history before the first row; ``ssd_state`` is the SSD's initial
    state (the plain version takes one, the kernel starts from zeros, as
    prefill does)."""
    b, t, _ = u.shape
    di, g, n, h, dh = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                       cfg.d_head)
    zxbcdt = u @ p["w_in"]
    z, xbc, dt = _split_proj(cfg, zxbcdt)

    # causal depthwise conv over time (window d_conv)
    w = p["conv_w"]                                  # [d_conv, conv_dim]
    pad = cfg.d_conv - 1
    xbc_pad = F.pad(xbc, (0, 0, pad, 0))
    if conv_state is not None:
        xbc_pad = torch.cat([conv_state.to(xbc_pad.dtype), xbc_pad[:, pad:]],
                            dim=1)
    xbc_conv = sum(xbc_pad[:, i: i + t] * w[i][None, None, :]
                   for i in range(cfg.d_conv)) + p["conv_b"]
    xbc_conv = F.silu(xbc_conv)
    new_conv_state = xbc_pad[:, t: t + pad]

    xs = xbc_conv[..., :di].reshape(b, t, h, dh)
    Bmat = xbc_conv[..., di: di + g * n].reshape(b, t, g, n)
    Cmat = xbc_conv[..., di + g * n:].reshape(b, t, g, n)
    hl = _local_heads(cfg)
    if hl is not None:
        z, xs, dt, Bmat, Cmat = _to_local_heads(cfg, z, xs, dt, Bmat, Cmat)
        di = hl * dh
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    args = (xs.float(), dt, A, Bmat.float(), Cmat.float(), p["D"])
    if return_state:
        y, s_last = kops.ssd_scan_state(*args, initial_state=ssd_state)
    elif ssd_state is not None:
        raise ValueError("ssd_state is an initial state for return_state="
                         "True")
    else:
        y = kops.ssd_scan(*args)
    y = y.reshape(b, t, di).to(u.dtype)
    y = _gated_norm(y, z, p["norm_scale"], cfg.d_inner, hl is not None)
    out = y @ p["w_out"]
    if hl is not None:
        out = L.model_reduce(out)
    if return_state:
        return out, (new_conv_state, s_last)
    return out


def ssm_init_cache(cfg: SSMConfig, batch: int, dtype=torch.float32,
                   device=None):
    """Zero caches of one block: ``conv`` [batch, d_conv - 1, conv_dim] in
    ``dtype`` (float32 by default, as the JAX package's), ``ssd`` [batch,
    h, ds, dh] float32."""
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    heads = _local_heads(cfg) or cfg.n_heads
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, heads, cfg.d_state, cfg.d_head),
                           dtype=torch.float32, device=device),
    }


def ssm_decode_step(p, cfg: SSMConfig, u: torch.Tensor, cache):
    """u: [B, 1, d_model] -> (out [B, 1, d_model], new cache): the O(1)
    recurrent step.  The conv history is held in the cache's dtype and
    convolved in float32; the state update is float32."""
    b = u.shape[0]
    di, g, n, h, dh = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                       cfg.d_head)
    zxbcdt = u[:, 0] @ p["w_in"]
    z, xbc, dt = _split_proj(cfg, zxbcdt)

    hist = torch.cat([cache["conv"], xbc[:, None, :].to(cache["conv"].dtype)],
                     dim=1)                          # [b, d_conv, conv_dim]
    w = p["conv_w"]
    xbc_conv = torch.einsum("btc,tc->bc", hist.float(), w.float()) \
        + p["conv_b"]
    xbc_conv = F.silu(xbc_conv)
    new_conv = hist[:, 1:]

    xs = xbc_conv[..., :di].reshape(b, h, dh)
    Bm = xbc_conv[..., di: di + g * n].reshape(b, g, n)
    Cm = xbc_conv[..., di + g * n:].reshape(b, g, n)
    hl = _local_heads(cfg)
    if hl is not None:
        z, xs, dt, Bm, Cm = _to_local_heads(cfg, z, xs, dt, Bm, Cm)
        h, di, g = hl, hl * dh, Bm.shape[-2]
    rep = h // g
    Bm = Bm.repeat_interleave(rep, dim=1)            # [b, h, n]
    Cm = Cm.repeat_interleave(rep, dim=1)
    dt = F.softplus(dt.float() + p["dt_bias"])       # [b, h]
    A = -torch.exp(p["A_log"])

    s = cache["ssd"]
    decay = torch.exp(dt * A[None, :])[:, :, None, None]
    s_new = s * decay + (dt[:, :, None] * xs)[:, :, None, :] \
        * Bm[:, :, :, None]                          # [b, h, n, dh]
    y = torch.einsum("bhsd,bhs->bhd", s_new, Cm) + xs * p["D"][None, :, None]
    y = y.reshape(b, di).to(u.dtype)
    y = _gated_norm(y, z, p["norm_scale"], cfg.d_inner, hl is not None)
    out = y @ p["w_out"]
    if hl is not None:
        out = L.model_reduce(out)
    return out[:, None, :], {"conv": new_conv, "ssd": s_new}
