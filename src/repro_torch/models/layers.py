"""Shared building blocks of the LM family (plain functions over nested
dicts of tensors), the counterpart of ``repro/models/layers.py``.

Initializers draw from an explicit ``torch.Generator``, on its device, with
the JAX initializers' distributions (the numbers differ: a test that holds
the port to the JAX package carries the JAX weights over with
``repro_torch.convert.load_lm_params``).  The JAX package's sharding hints
(``shard``) have no counterpart: the port runs on one device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "embed_init", "rmsnorm", "layernorm", "norm_apply",
           "norm_init", "rope_freqs", "apply_rope", "mlp_init", "mlp_apply",
           "ACTIVATIONS", "cross_entropy"]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, fan_in: int, fan_out: int,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in), as the JAX package's default."""
    return (_normal(gen, (fan_in, fan_out)) / math.sqrt(fan_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return (_normal(gen, (vocab, d)) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms (computed in float32, cast back to the input's dtype)
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + gamma)."""
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + gamma.float())).to(dt)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def norm_apply(kind: str, x: torch.Tensor, p) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def norm_init(kind: str, d: int, dtype=torch.float32, device=None):
    if kind == "rmsnorm":
        return {"scale": torch.zeros(d, dtype=dtype, device=device)}
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# rotary position embeddings: half-split (the first and second halves of
# the head dim rotate together), angles in float32
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T] or [T]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # [B, T, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# jax.nn.gelu approximates with tanh by default, so "gelu" is the tanh form
# too (torch's default, the exact erf form, would differ).
ACTIVATIONS = {"silu": F.silu, "gelu": _gelu_tanh, "gelu_tanh": _gelu_tanh,
               "relu": F.relu}


def mlp_init(gen: torch.Generator, d: int, f: int, gated: bool,
             dtype=torch.float32):
    """Draws in the JAX key order (gate/in, up, out) and returns the JAX
    tree's keys."""
    first = dense_init(gen, d, f, dtype)
    if gated:
        up = dense_init(gen, d, f, dtype)
        return {"w_out": dense_init(gen, f, d, dtype), "w_gate": first,
                "w_up": up}
    return {"w_out": dense_init(gen, f, d, dtype), "w_in": first}


def mlp_apply(p, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    act = ACTIVATIONS[activation]
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_in"])
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1,
                  true_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean CE over non-ignored tokens; logits [.., V], labels [..].

    As the JAX package computes it: in float32, padded vocab entries
    (``true_vocab`` and up) masked to -inf, the row max held out of the
    gradient, and the label's logit picked by an iota mask (a sum over
    the vocab), not a gather."""
    v = logits.shape[-1]
    x = logits.float()
    vidx = torch.arange(v, device=x.device)
    if true_vocab is not None and true_vocab < v:
        x = x.masked_fill(vidx >= true_vocab, float("-inf"))
    lmax = torch.amax(x, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(x - lmax), dim=-1)) + lmax[..., 0]
    label_hit = vidx == labels[..., None].clamp(min=0)
    ll = torch.sum(torch.where(label_hit, x, torch.zeros((), device=x.device)),
                   dim=-1)
    mask = (labels != ignore_id).float()
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
