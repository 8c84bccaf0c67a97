"""Shared building blocks of the LM family (plain functions over nested
dicts of tensors), the counterpart of ``repro/models/layers.py``.

Initializers draw from an explicit ``torch.Generator``, on its device, with
the JAX initializers' distributions (the numbers differ: a test that holds
the port to the JAX package carries the JAX weights over with
``repro_torch.convert.load_lm_params``).

Model parallelism (``launch/sharding.py``'s ``activate``): the JAX package
binds logical axes ("batch", "heads", "ffn", "vocab", ...) to mesh axes
and leaves the collectives to GSPMD.  The port runs SPMD over
``torch.distributed``: every rank holds its block of each tensor and the
model code issues the collectives that GSPMD would insert, through the
autograd functions below (Megatron's conjugate pairs, named for the axis
they run over):

  model_enter   identity forward, all-reduce of the gradient: a tensor
                that is whole on every "model" rank enters a computation
                that differs by rank (a column-parallel product, local
                heads, local experts)
  model_reduce  all-reduce forward, identity backward: the partial sums of
                a row-parallel product (``wo``, ``w_out``), the vocab
                reductions of the cross entropy
  model_gather / model_split (and batch_*): a tensor's blocks joined, or
                this rank's block taken; each the other's backward
  batch_enter / batch_reduce: the same pair over the batch axes (a
                module that runs on this rank's rows with weights whole
                on every batch rank, a loss term summed over the rows)

The loss is whole and equal on every rank, so a gradient that reaches a
tensor whole on every rank is the whole gradient.  ``shard()`` is the
identity when no mesh is active; with one it takes this rank's block of a
tensor that is whole on the ranks along the dims whose logical axis
resolves to "model" (``model_split``), by the JAX package's divisibility
rule.  The batch is split by the entry points (``launch/serve.py``,
``launch/train.py``), so "batch" resolves to nothing here.
"""

from __future__ import annotations

import math
import sys
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["set_axis_env", "clear_axis_env", "shard", "parallel",
           "batch_sharded", "model_size", "model_rank", "batch_size",
           "batch_rank", "model_enter", "model_reduce", "model_max",
           "model_gather", "model_split", "batch_enter", "batch_reduce",
           "batch_max", "batch_gather", "batch_split", "from_placed",
           "dense_init", "embed_init", "rmsnorm", "layernorm", "norm_apply",
           "norm_init", "rope_freqs", "apply_rope", "mlp_init", "mlp_apply",
           "ACTIVATIONS", "cross_entropy"]


# ---------------------------------------------------------------------------
# logical-axis resolution (set by repro_torch.launch.sharding.activate()),
# divisibility-aware as the JAX package's: a logical axis is dropped for a
# dim the mesh axis does not divide
# ---------------------------------------------------------------------------
_AXIS_ENV: dict = {
    "active": False, "batch": None, "model": None,
    "batch_size": 1, "model_size": 1, "mesh": None, "batch_sharded": False,
}


def set_axis_env(batch_axes, model_axis, batch_size: int = 1,
                 model_size: int = 1, mesh=None,
                 batch_sharded: bool = False) -> None:
    """Bind the logical axes (the JAX signature); ``mesh``: the
    ``launch.mesh.NamedMesh`` whose process groups carry the collectives;
    ``batch_sharded``: whether the entry point split the batch over the
    batch axes (a batch they do not divide stays whole on every rank)."""
    _AXIS_ENV.update(active=True, batch=batch_axes, model=model_axis,
                     batch_size=batch_size, model_size=model_size, mesh=mesh,
                     batch_sharded=bool(batch_sharded))


def clear_axis_env() -> None:
    _AXIS_ENV.update(active=False, batch=None, model=None, batch_size=1,
                     model_size=1, mesh=None, batch_sharded=False)


_LOGICAL = {
    "batch": "batch", "heads": "model", "ffn": "model", "vocab": "model",
    "experts": "model", "kv_heads": "model", "model_d": None, "seq": None,
}


def parallel() -> bool:
    """Whether a mesh is active (the model code then runs on blocks)."""
    return _AXIS_ENV["active"] and _AXIS_ENV["mesh"] is not None


def batch_sharded() -> bool:
    return parallel() and _AXIS_ENV["batch_sharded"]


def model_size() -> int:
    return _AXIS_ENV["model_size"] if parallel() else 1


def model_rank() -> int:
    return _AXIS_ENV["mesh"].coord("model") if parallel() else 0


def batch_size() -> int:
    """The ranks over the batch axes together (1 without a mesh)."""
    return _AXIS_ENV["mesh"].size("batch") if parallel() else 1


def batch_rank() -> int:
    """This rank's index over the batch axes, rank-major in their order
    (a DTensor sharded on them holds that block)."""
    return _AXIS_ENV["mesh"].coord("batch") if parallel() else 0


def _group(axis: str):
    """(process group, size, this rank's index) of "model" or "batch"."""
    mesh = _AXIS_ENV["mesh"]
    return mesh.group(axis), mesh.size(axis), mesh.coord(axis)


def _all_gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The blocks of every rank along ``axis``, joined along ``dim`` in
    rank order (a group of one: ``x`` itself)."""
    group, n, _ = _group(axis)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=xs.device)
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def _block(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (its size divides)."""
    _, n, r = _group(axis)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


def _all_reduce(x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    # issued at a group of one too, so a one-rank mesh runs it for real
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=_group(axis)[0])
    return out


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.axis), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _block(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.dim, ctx.axis), None, None


def model_enter(x: torch.Tensor) -> torch.Tensor:
    return _Enter.apply(x, "model")


def model_reduce(x: torch.Tensor) -> torch.Tensor:
    return _Reduce.apply(x, "model")


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the "model" ranks (no gradient)."""
    return _all_reduce(x.detach(), "model", dist.ReduceOp.MAX)


def model_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _Gather.apply(x, dim % x.dim(), "model")


def model_split(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _Split.apply(x, dim % x.dim(), "model")


def batch_enter(x: torch.Tensor) -> torch.Tensor:
    return _Enter.apply(x, "batch")


def batch_reduce(x: torch.Tensor) -> torch.Tensor:
    return _Reduce.apply(x, "batch")


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the batch ranks (no gradient)."""
    return _all_reduce(x.detach(), "batch", dist.ReduceOp.MAX)


def batch_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _Gather.apply(x, dim % x.dim(), "batch")


def batch_split(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _Split.apply(x, dim % x.dim(), "batch")


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """This rank's block of ``x`` (whole on the "model" ranks) along the
    dims whose logical axis resolves to "model" and which the axis
    divides; the identity when no mesh is active.  Its gradient joins the
    blocks again (``model_split``)."""
    if not parallel():
        return x
    for i, name in enumerate(logical):
        if i < x.dim() and _LOGICAL.get(name) == "model" \
                and _AXIS_ENV["model"] \
                and x.shape[i] % max(1, _AXIS_ENV["model_size"]) == 0:
            x = model_split(x, i)
    return x


def from_placed(t, keep_model: bool = True,
                batch_specific: bool = True) -> torch.Tensor:
    """A placed parameter (a DTensor on the active mesh, or a plain tensor,
    taken as it is) as the tensor the model code computes with: its
    blocks on the batch axes joined (FSDP's gather; the gradient keeps
    this rank's block), and on "model" joined too unless ``keep_model``
    (the module computes on the model rank's block).  ``batch_specific``:
    the model runs it on this rank's part of the batch, so its gradient
    sums over the batch axes (a module that runs on the whole batch on
    every rank, the MoE, passes False)."""
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is None or not isinstance(t, dt.DTensor):
        return t
    mesh = _AXIS_ENV["mesh"]
    x = t.to_local()
    batch_dim = model_dim = None
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            if name == "model":
                model_dim = pl.dim
            else:
                batch_dim = pl.dim
    if batch_dim is not None:
        x = _Gather.apply(x, batch_dim, "batch")
    if batch_specific and mesh.size("batch") > 1 and batch_sharded():
        x = _Enter.apply(x, "batch")
    if model_dim is not None and not keep_model:
        x = _Gather.apply(x, model_dim, "model")
    return x


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


def mlp_apply(p, x: torch.Tensor, activation: str = "silu",
              d_ff: Optional[int] = None) -> torch.Tensor:
    """With a mesh active and ``w_out`` holding this rank's block of the
    ``d_ff`` rows (the JAX package's ``shard(h, "batch", None, "ffn")``):
    column-parallel in, row-parallel out, the partial sums all-reduced."""
    act = ACTIVATIONS[activation]
    tp = parallel() and d_ff is not None and p["w_out"].shape[-2] != d_ff
    if tp:
        x = model_enter(x)
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_in"])
    y = h @ p["w_out"]
    return model_reduce(y) if tp else y


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1,
                  true_vocab: Optional[int] = None,
                  vocab_start: Optional[int] = None) -> torch.Tensor:
    """Mean CE over non-ignored tokens; logits [.., V], labels [..].

    As the JAX package computes it: in float32, padded vocab entries
    (``true_vocab`` and up) masked to -inf, the row max held out of the
    gradient, and the label's logit picked by an iota mask (a sum over
    the vocab), not a gather.  With ``vocab_start`` (a mesh active) the
    logits are this rank's block of the vocab, from that entry on: the row
    max, the sum of exponentials and the label term reduce over "model".
    Under a mesh that split the batch, the loss and the token count sum
    over the batch axes."""
    v = logits.shape[-1]
    x = logits.float()
    par = vocab_start is not None and parallel()
    vidx = torch.arange(v, device=x.device) + (vocab_start if par else 0)
    if true_vocab is not None and (par or true_vocab < v):
        x = x.masked_fill(vidx >= true_vocab, float("-inf"))
    lmax = torch.amax(x, dim=-1, keepdim=True).detach()
    if par:
        lmax = model_max(lmax)
    sumexp = torch.sum(torch.exp(x - lmax), dim=-1)
    label_hit = vidx == labels[..., None].clamp(min=0)
    ll = torch.sum(torch.where(label_hit, x, torch.zeros((), device=x.device)),
                   dim=-1)
    if par:
        sumexp, ll = model_reduce(sumexp), model_reduce(ll)
    lse = torch.log(sumexp) + lmax[..., 0]
    mask = (labels != ignore_id).float()
    nll = (lse - ll) * mask
    total, count = torch.sum(nll), torch.sum(mask)
    if batch_sharded():
        total, count = batch_reduce(total), batch_reduce(count)
    return total / torch.clamp(count, min=1.0)
