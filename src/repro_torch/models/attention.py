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
                      attends to an encoder's cached keys and values

Cross-attention (the encdec family) passes the encoder's projected keys
and values as ``kv=``: the query is projected (bias, qk-norm) without
rope, and the keys are not causal-masked.

A layer's cache is ``{"k", "v": [B, S, n_kv, D], "pos": [S] int32 (absolute
positions, -1 = empty), "ring": bool}``; ``ring`` is a Python bool, so a
decode step needs no host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (apply_rope, dense_init, norm_init,
                                       rmsnorm)

__all__ = [
    "AttnConfig", "attn_init", "attention_forward", "attention_decode",
    "init_cache", "fill_cache", "window_cache_elements",
    "dense_cache_elements",
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
                 positions: torch.Tensor):
    b, t, _ = x.shape
    q = x @ p["wq"]
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
    if kv is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
    else:
        q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(cfg.n_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"]["scale"])
        k, v = kv
    eff_window = window if window is not None else cfg.window
    out = kops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal, window=eff_window,
        scale=1.0 / math.sqrt(cfg.head_dim), softcap=cfg.softcap,
        prefix=prefix)
    out = out.transpose(1, 2).reshape(b, t, cfg.q_dim)
    y = out @ p["wo"]
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
    shape = (batch, s, cfg.n_kv, cfg.head_dim)
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


def attention_decode(p, cfg: AttnConfig, x: torch.Tensor, cache,
                     index: int, cross: bool = False):
    """One-token step.  x: [B, 1, d]; index: the token's absolute position.
    Writes its key and value into ``cache`` (in place) and returns
    (y [B, 1, d], cache).  With ``cross`` the cache holds an encoder's keys
    and values: nothing is written, no rope is applied, and every slot with
    ``pos >= 0`` is attended to."""
    b = x.shape[0]
    q = (x @ p["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"]["scale"])
    kc, vc, kpos = cache["k"], cache["v"], cache["pos"]
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
        s = kc.shape[1]
        slot = index % s if cache["ring"] else min(index, s - 1)
        kc[:, slot] = k1[:, 0]
        vc[:, slot] = v1[:, 0]
        kpos[slot] = index

    # one query against the cache, grouped: the GQA-repeated cache is never
    # built.  Logits in float32; the softmax weights are cast to the cache's
    # dtype before p . v, as the JAX package does.
    rep = cfg.n_heads // cfg.n_kv
    qg = q.reshape(b, cfg.n_kv, rep, cfg.head_dim).float()
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
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", w.to(vc.dtype).float(), vc.float())
    y = out.reshape(b, 1, cfg.q_dim).to(x.dtype) @ p["wo"]
    return y, cache
