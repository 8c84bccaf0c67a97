"""Attention: GQA/MQA/MHA with RoPE, qk-norm, bias, sliding windows and KV
caches; the counterpart of ``repro/models/attention.py``.

The sliding window is the GeNN tie-in: the position -> position attention
pattern is a synapse connectivity matrix, a window makes it banded-sparse,
and the cache representation (a ring buffer of ``window`` slots vs a dense
cache of ``max_seq``) is chosen with the paper's eq. (1)/(2) memory model
(``window_cache_elements`` vs ``dense_cache_elements``).

  attention_forward : full sequence (prefill), through
                      ``kernels.ops.flash_attention`` (the CUDA kernel on
                      the card, its plain version on the CPU)
  attention_decode  : one token against a KV cache (dense or ring), plain
                      torch with the JAX casts; it writes the new key and
                      value into the cache in place, or (``cross=True``)
                      attends to an encoder's cached keys and values; on
                      a mesh, over this rank's block of the sequence with
                      the blocks' partial softmax merged

Cross-attention (the encdec family) passes the encoder's projected keys
and values as ``kv=``: the query is projected (bias, qk-norm) without
rope, and the keys are not causal-masked.

A layer's cache is ``{"k", "v": [B, S, n_kv, D], "pos": [S] int32 (absolute
positions, -1 = empty), "ring": bool}``; ``ring`` is a Python bool, so a
decode step needs no host sync.

With a mesh active (``launch/sharding.py``'s ``activate``) and the heads
divisible by the "model" axis, each rank computes its block of the heads
(the JAX package's ``shard(q, "batch", None, "heads", None)``): ``wq``
and ``wo`` hold the rank's head blocks, the input enters through
``model_enter`` and ``wo``'s partial sums reduce (``model_reduce``).  KV
heads that the axis divides are split the same way; others (qwen2's 2 on
a 4-wide axis) are projected whole and each local query head takes its
group's (``_heads_plan``), and the cache then holds every KV head.  Heads
the axis does not divide (qwen2-0.5b's 14 on 4) run whole on every rank,
with every weight joined.  Weights placed whole (the dry run's
``serve_replicate_weights``) give each rank its heads' blocks locally
(``rank_blocks``).  A decode's cache stays in the layout
``cache_shardings`` stores it in: a sequence split over "model" (the KV
heads do not divide it) or over the batch axes (a batch-1 wave) is
attended block by block (``attention_decode``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.layers import (apply_rope, dense_init, norm_init,
                                       rmsnorm)

__all__ = [
    "AttnConfig", "attn_init", "attention_forward", "attention_decode",
    "init_cache", "fill_cache", "window_cache_elements",
    "dense_cache_elements", "rank_blocks",
]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None         # sliding window (None = full)
    causal: bool = True
    softcap: Optional[float] = None      # logit soft-capping (gemma-style)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim


def _heads_plan(cfg: AttnConfig):
    """This rank's share of the heads with a mesh active: None when the
    heads run whole (no mesh, or "model" does not divide them), else
    (local config, kv_sel): the config's ``n_heads`` is the rank's block
    of query heads and its ``n_kv`` the KV heads the rank projects (its
    block, or all of them); ``kv_sel`` (a list, or None) picks each local
    query head's KV head out of all of them."""
    if not L.parallel() or cfg.n_heads % L.model_size():
        return None
    mp, r = L.model_size(), L.model_rank()
    hl = cfg.n_heads // mp
    if cfg.n_kv % mp == 0:
        return dataclasses.replace(cfg, n_heads=hl, n_kv=cfg.n_kv // mp), None
    rep = cfg.n_heads // cfg.n_kv
    sel = [(r * hl + i) // rep for i in range(hl)]
    return dataclasses.replace(cfg, n_heads=hl), sel


def rank_blocks(p, cfg: AttnConfig, plan):
    """``p`` as ``plan``'s rank computes with it: the weights themselves
    where they hold the rank's head blocks (placed on "model"), else, for
    whole weights (the dry run's ``serve_replicate_weights`` places every
    weight whole), the rank's blocks taken out of them locally, with no
    collective, as GSPMD slices a replicated weight under ``shard(q,
    "batch", None, "heads", None)``: ``wq``'s and ``wo``'s query heads and
    the biases', and ``wk``'s and ``wv``'s KV heads where they are split."""
    if plan is None:
        return p
    local = plan[0]
    if p["wq"].shape[-1] == local.q_dim:
        return p
    r = L.model_rank()
    qs = slice(r * local.q_dim, (r + 1) * local.q_dim)
    out = dict(p, wq=p["wq"][:, qs], wo=p["wo"][qs])
    if "bq" in p:
        out["bq"] = p["bq"][qs]
    if local.n_kv != cfg.n_kv:
        ks = slice(r * local.kv_dim, (r + 1) * local.kv_dim)
        out.update(wk=p["wk"][:, ks], wv=p["wv"][:, ks])
        for name in ("bk", "bv"):
            if name in p:
                out[name] = p[name][ks]
    return out


def _pick_heads(t: torch.Tensor, sel) -> torch.Tensor:
    """[B, T, n_kv, D] -> the KV head of each local query head."""
    if sel is None:
        return t
    return t.index_select(2, torch.tensor(sel, device=t.device))


def _cache_config(cfg: AttnConfig) -> AttnConfig:
    """The config whose ``n_kv`` is the KV heads this rank's cache holds."""
    plan = _heads_plan(cfg)
    return cfg if plan is None else dataclasses.replace(
        cfg, n_kv=plan[0].n_kv)


def attn_init(gen: torch.Generator, cfg: AttnConfig, dtype=torch.float32):
    d = cfg.d_model
    p = {
        "wq": dense_init(gen, d, cfg.q_dim, dtype),
        "wk": dense_init(gen, d, cfg.kv_dim, dtype),
        "wv": dense_init(gen, d, cfg.kv_dim, dtype),
        "wo": dense_init(gen, cfg.q_dim, d, dtype),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.q_dim, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(cfg.kv_dim, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(cfg.kv_dim, dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = norm_init("rmsnorm", cfg.head_dim, dtype, dev)
        p["k_norm"] = norm_init("rmsnorm", cfg.head_dim, dtype, dev)
    return p


def _project_qkv(p, cfg: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor, xq: Optional[torch.Tensor] = None):
    """q from ``xq`` (default ``x``), k and v from ``x``."""
    b, t, _ = x.shape
    q = (x if xq is None else xq) @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.n_kv, cfg.head_dim)
    v = v.reshape(b, t, cfg.n_kv, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"]["scale"])
        k = rmsnorm(k, p["k_norm"]["scale"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_forward(p, cfg: AttnConfig, x: torch.Tensor,
                      positions: Optional[torch.Tensor] = None,
                      window: Optional[int] = None,
                      kv: Optional[tuple] = None,
                      return_kv: bool = False,
                      prefix: Optional[int] = None):
    """x: [B, T, d] -> [B, T, d] (and the layer's (k, v) [B, Tk, n_kv, D]
    with ``return_kv``).  ``window`` overrides ``cfg.window``.  ``kv``:
    a cross-attention source (k, v) [B, Tk, n_kv, D], taken as given; the
    query then gets no rope."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)
    plan = _heads_plan(cfg)
    p = rank_blocks(p, cfg, plan)
    sel, xq = None, x
    if plan is not None:
        # x enters this rank's heads; with the KV heads whole, k and v are
        # projected whole and enter as they are picked (below)
        cfg, sel = plan
        xq = L.model_enter(x)
        if sel is None:
            x = xq
    if kv is None:
        q, k, v = _project_qkv(p, cfg, x, positions, xq)
    else:
        q = (xq @ p["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(cfg.n_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"]["scale"])
        k, v = kv
    eff_window = window if window is not None else cfg.window
    # the kernel runs on the local heads (a KV head per local query head
    # when the KV heads are whole)
    kl, vl = k, v
    if sel is not None:
        kl = _pick_heads(L.model_enter(k), sel)
        vl = _pick_heads(L.model_enter(v), sel)
    out = kops.flash_attention(
        q.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
        causal=cfg.causal, window=eff_window,
        scale=1.0 / math.sqrt(cfg.head_dim), softcap=cfg.softcap,
        prefix=prefix)
    out = out.transpose(1, 2).reshape(b, t, cfg.q_dim)
    y = out @ p["wo"]
    if plan is not None:
        y = L.model_reduce(y)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def dense_cache_elements(seq: int, n_kv: int, head_dim: int) -> int:
    return 2 * seq * n_kv * head_dim


def window_cache_elements(window: int, n_kv: int, head_dim: int) -> int:
    return 2 * window * n_kv * head_dim + window  # + position ring


def init_cache(cfg: AttnConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Ring vs dense by the paper's memory model."""
    use_ring = (cfg.window is not None and window_cache_elements(
        cfg.window, cfg.n_kv, cfg.head_dim) < dense_cache_elements(
        max_seq, cfg.n_kv, cfg.head_dim))
    s = cfg.window if use_ring else max_seq
    shape = (batch, s, _cache_config(cfg).n_kv, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((s,), -1, dtype=torch.int32, device=device),
        "ring": use_ring,
    }


def fill_cache(cache, k: torch.Tensor, v: torch.Tensor, start: int = 0):
    """Prefill: write [B, T, n_kv, D] into the cache at [start, start + T),
    in place.  A ring smaller than the prompt keeps the last S positions in
    slots 0..S-1, as the JAX package does."""
    t = k.shape[1]
    s = cache["k"].shape[1]
    dev = cache["pos"].device
    if t >= s:
        cache["k"].copy_(k[:, -s:])
        cache["v"].copy_(v[:, -s:])
        cache["pos"].copy_(torch.arange(t - s, t, dtype=torch.int32,
                                        device=dev) + start)
        return cache
    cache["k"][:, start:start + t] = k
    cache["v"][:, start:start + t] = v
    cache["pos"][start:start + t] = torch.arange(t, dtype=torch.int32,
                                                 device=dev) + start
    return cache


def _seq_split(s_local: int, s: int):
    """The axis ("model" or "batch") that this rank's cache block of an
    ``s``-slot sequence lies on, and the block's index along it; (None, 0)
    when the rank holds every slot.  ``cache_shardings`` puts a cache's
    sequence on the batch axes when the batch does not divide them (the
    entry points then leave the batch whole: a batch-1 wave), else on
    "model" when the KV heads do not divide it, never on both."""
    if s_local == s:
        return None, 0
    nb = L.batch_size()
    if not L.batch_sharded() and nb > 1 and s % nb == 0:
        axis, n, r = "batch", nb, L.batch_rank()
    else:
        axis, n, r = "model", L.model_size(), L.model_rank()
    if s_local * n != s:
        raise ValueError(f"a cache block of {s_local} slots is not one "
                         f"of {n} blocks of {s} on {axis!r}")
    return axis, r


def attention_decode(p, cfg: AttnConfig, x: torch.Tensor, cache,
                     index: int, cross: bool = False):
    """One-token step.  x: [B, 1, d]; index: the token's absolute position.
    Writes its key and value into ``cache`` (in place) and returns
    (y [B, 1, d], cache).  With ``cross`` the cache holds an encoder's keys
    and values: nothing is written, no rope is applied, and every slot with
    ``pos >= 0`` is attended to.

    Under a mesh the cache may be this rank's block of the sequence (its
    ``pos`` whole): the rank that holds the new token's slot writes it,
    each rank attends over its own slots, and the blocks' partial softmax
    merges over their axis as flash-decoding merges it (the max, then the
    sum of exponentials, then the weighted values, in float32).  A block
    with no valid slot adds weight 0.  Where the sequence lies on "model",
    every rank needs every query head's logits over its block: the local
    heads' queries are joined over "model", and after the merge the rank
    keeps its heads for its ``wo`` block."""
    b = x.shape[0]
    plan = _heads_plan(cfg)
    p = rank_blocks(p, cfg, plan)
    sel = None
    if plan is not None:
        cfg, sel = plan
        x = L.model_enter(x)
    q = (x @ p["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"]["scale"])
    kc, vc, kpos = cache["k"], cache["v"], cache["pos"]
    s_local, s = kc.shape[1], kpos.shape[0]
    axis, blk = _seq_split(s_local, s)
    lo = blk * s_local
    if not cross:
        pos1 = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
        k1 = (x @ p["wk"]).reshape(b, 1, cfg.n_kv, cfg.head_dim)
        v1 = (x @ p["wv"]).reshape(b, 1, cfg.n_kv, cfg.head_dim)
        if cfg.qkv_bias:
            k1 = k1 + p["bk"].reshape(cfg.n_kv, cfg.head_dim)
            v1 = v1 + p["bv"].reshape(cfg.n_kv, cfg.head_dim)
        if cfg.qk_norm:
            k1 = rmsnorm(k1, p["k_norm"]["scale"])
        q = apply_rope(q, pos1, cfg.rope_theta)
        k1 = apply_rope(k1, pos1, cfg.rope_theta)
        slot = index % s if cache["ring"] else min(index, s - 1)
        if lo <= slot < lo + s_local:
            kc[:, slot - lo] = k1[:, 0]
            vc[:, slot - lo] = v1[:, 0]
        kpos[slot] = index
    if axis is not None:
        kpos = kpos[lo:lo + s_local]
    all_heads = axis == "model" and plan is not None
    if all_heads:
        q = L.model_gather(q, 2)      # [B, 1, H, D]
    elif sel is not None:
        kc, vc = _pick_heads(kc, sel), _pick_heads(vc, sel)

    # one query against the cache, grouped: the GQA-repeated cache is never
    # built.  Logits in float32; the softmax weights are cast to the cache's
    # dtype before p . v, as the JAX package does.
    heads = q.shape[2]
    n_kv = kc.shape[2]
    rep = heads // n_kv
    qg = q.reshape(b, n_kv, rep, cfg.head_dim).float()
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, kc.float())
    logits = logits / math.sqrt(cfg.head_dim)
    if cfg.softcap is not None:
        logits = cfg.softcap * torch.tanh(logits / cfg.softcap)
    valid = kpos >= 0
    if not cross:
        valid = valid & (kpos <= index)
        if cfg.window is not None:
            valid = valid & (kpos > index - cfg.window)
    logits = logits.masked_fill(~valid, float("-inf"))
    if axis is None:
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgrs,bsgd->bgrd", w.to(vc.dtype).float(),
                           vc.float())
    else:
        # the partial softmax of this block, merged over the blocks: every
        # block together holds a valid slot, so the max is finite and an
        # empty block's exponentials are 0
        mx = L.model_max if axis == "model" else L.batch_max
        total = L.model_reduce if axis == "model" else L.batch_reduce
        m = mx(torch.amax(logits, dim=-1, keepdim=True))
        e = torch.exp(logits - m)
        w = e / total(e.sum(dim=-1, keepdim=True))
        out = total(torch.einsum("bgrs,bsgd->bgrd", w.to(vc.dtype).float(),
                                 vc.float()))
    out = out.reshape(b, 1, heads * cfg.head_dim)
    if all_heads:
        hl = cfg.q_dim
        out = out[..., L.model_rank() * hl:(L.model_rank() + 1) * hl]
    y = out.to(x.dtype) @ p["wo"]
    if plan is not None:
        y = L.model_reduce(y)
    return y, cache
