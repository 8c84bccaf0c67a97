"""AdamW with float32 master copies of half-precision params and clipping
by the global norm, the counterpart of ``repro/optim/adamw.py``.

Functional in shape, as the JAX package's: ``init(cfg, params) -> state``;
``update(cfg, grads, state, params) -> (params, state, metrics)``; the
trees are the model's nested dicts and lists of tensors.  The arithmetic
is JAX's, statement for statement, in float32: the gradient scaled by
min(1, clip / global norm), the moments, bias correction, and the weight
decay inside the learning-rate product (``p - lr * (mhat / (sqrt(vhat) +
eps) + wd * p)``), which is why this is not ``torch.optim.AdamW`` (it
decays before the update, outside the product).

Unlike JAX's arrays, the port's tensors are updated in place (params,
master copies and moments), and a large leaf is updated a slice of its
leading (layer) axis at a time: a full-width model's optimizer state is
most of the card's memory, and a whole-leaf temporary of a 64-layer
stacked weight would be gigabytes.  The returned params and state are the
same tensors as those passed in.

Placed params (DTensors on a mesh, ``launch/sharding.py``) take moments
and master copies of the same placements, so the param specs shard the
optimizer state as in the JAX package (ZeRO); the update runs on each
rank's blocks, and the global norm sums every block once over the whole
process group.  Gradient compression (error-feedback int8) is
``optim/grad_compression.py``; the update does not call it, as the JAX
package's does not.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "AdamWState", "init", "update", "global_norm"]

# leaves above this many elements are updated a slice at a time
_SLICE_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[Any], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # keep a fp32 master copy when params are half precision
    master_fp32: bool = True


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any
    master: Any          # fp32 master params (None if disabled)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _lr_at(cfg: AdamWConfig, step: int) -> torch.Tensor:
    return _f32(cfg.lr(step) if callable(cfg.lr) else cfg.lr)


def _slices(t: torch.Tensor):
    """``t`` whole, or views of it that cut its leading axis into the
    fewest pieces of at most ``_SLICE_ELEMENTS`` elements (one row at
    least) when it is larger."""
    if t.numel() <= _SLICE_ELEMENTS or t.dim() < 2:
        return [t]
    rows = max(1, _SLICE_ELEMENTS // (t.numel() // t.shape[0]))
    return list(torch.split(t, rows, dim=0))


def _placed(x) -> bool:
    # no DTensor exists before its module is imported (importing it costs
    # seconds, which an unmeshed run need not pay)
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


def _local(x):
    """A placed leaf's block on this rank (its own storage), else ``x``."""
    return x.to_local() if _placed(x) else x


def _owner(x) -> bool:
    """Whether this rank counts a placed leaf's block in a sum over the
    process group: the first rank along every mesh axis the leaf is
    whole on (a block held by several ranks counts once)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, x.placements)
               if not pl.is_shard())


def _sum_sq(x) -> torch.Tensor:
    return sum(torch.sum(torch.square(s.float())) for s in _slices(x))


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum over leaves of sum(x^2)), in float32; placed leaves sum
    their blocks over the process group."""
    leaves = tree_flatten(tree)[0]
    if not any(_placed(x) for x in leaves):
        return torch.sqrt(torch.sum(torch.stack([_sum_sq(x)
                                                 for x in leaves])))
    parts = [_sum_sq(x.to_local()) * float(_owner(x)) for x in leaves]
    total = torch.sum(torch.stack(parts))
    dist.all_reduce(total)
    return torch.sqrt(total)


def init(cfg: AdamWConfig, params) -> AdamWState:
    def zeros(p):
        if _placed(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                       params) if cfg.master_fp32 else None)
    return AdamWState(step=0, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params), master=master)


@torch.no_grad()
def _update_leaf(g, m, v, p32, scale, lr, bc1, bc2, cfg: AdamWConfig):
    """One leaf (or slice), in place on m, v and p32."""
    b1, b2 = cfg.b1, cfg.b2
    t1 = g.to(torch.float32) * scale                   # g
    m.mul_(b1).add_(t1 * (1.0 - b1))                   # b1 m + (1 - b1) g
    t2 = torch.mul(t1, 1.0 - b2).mul_(t1)              # (1 - b2) g g
    v.mul_(b2).add_(t2)
    torch.div(m, bc1, out=t1)                          # mhat
    torch.div(v, bc2, out=t2).sqrt_().add_(cfg.eps)    # sqrt(vhat) + eps
    t1.div_(t2)
    t1.add_(torch.mul(p32, cfg.weight_decay, out=t2))  # + wd p
    p32.sub_(t1.mul_(lr))                              # p - lr (..)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params
           ) -> Tuple[Any, AdamWState, dict]:
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                         max=1.0) if cfg.grad_clip
             else _f32(1.0).to(gnorm.device))
    stepf = _f32(step)
    bc1 = 1.0 - _f32(cfg.b1) ** stepf
    bc2 = 1.0 - _f32(cfg.b2) ** stepf
    lr = _lr_at(cfg, step)

    p_leaves, spec = tree_flatten(params)
    g_leaves = [_local(x) for x in tree_flatten(grads)[0]]
    m_leaves = [_local(x) for x in tree_flatten(state.mu)[0]]
    v_leaves = [_local(x) for x in tree_flatten(state.nu)[0]]
    ref = ([_local(x) for x in tree_flatten(state.master)[0]]
           if cfg.master_fp32 else [_local(p).float() for p in p_leaves])
    for g, m, v, p32, p in zip(g_leaves, m_leaves, v_leaves, ref,
                               [_local(p) for p in p_leaves]):
        dev = m.device
        args = (scale.to(dev), lr.to(dev), bc1.to(dev), bc2.to(dev), cfg)
        for gs, ms, vs, ps in zip(_slices(g), _slices(m), _slices(v),
                                  _slices(p32)):
            _update_leaf(gs, ms, vs, ps, *args)
        if p32 is not p:
            p.copy_(p32)
    new_state = AdamWState(step=step, mu=state.mu, nu=state.nu,
                           master=state.master)
    return (tree_unflatten(p_leaves, spec), new_state,
            {"grad_norm": gnorm, "lr": lr})
