"""Mixture-of-Experts FFN with top-k routing and group-wise capacity, the
counterpart of ``repro/models/moe.py``.

Tokens are routed within fixed-size groups of the flattened ``[B*T]``
tokens (a group can hold tokens of two requests): a float32 router, the
top-k experts of each token (the lower expert index first among equal
probabilities, as ``jax.lax.top_k``), the k gates renormalised, then each
(token, slot) pair takes the next place in its expert's queue, token-major
and slot-minor.  A pair at a place past the capacity is dropped: its gate
is zeroed after the renormalisation and the gates are not renormalised
again.  The Switch load-balance loss ``aux_loss_weight * e * sum_e f_e
P_e`` is float32.

The JAX package has two dispatches that compute the same function
(``tests/test_moe.py`` holds them within 2e-5): ``"onehot"`` contracts
dense ``[g, gs, e, cap]`` one-hot tensors, ``"gather"`` inverts the
(token, slot) -> (expert, place) map.  The port computes both by index
(``dispatch`` is checked and kept for the JAX signature): each place in
the experts' ``[e, g * cap, d]`` queues gathers its pair's token row
(empty places are zero rows, as in the JAX package), three batched
products per expert (``torch.bmm``, plain large matrix products, as the
JAX package leaves them to XLA), and each pair gathers its place's output,
weighted by the pair's gate; both moves are gathers in the backward too
(``_Moved``).  At granite's prefill the dense one-hot tensors would be
~168M elements a layer; the index route moves none of them.

With a mesh active (``launch/sharding.py``): the rule table gives the
experts' leading axis to "model" when it divides the experts (granite's
32: ``expert_sharding="expert"``), else their ffn axis (mixtral's 8 on a
16-wide axis: ``"ffn"``), so the placed weights say which.  The group
size and capacity come from the global token count, as in the JAX
package's global view.  When the batch is split and this rank's rows are
whole groups, the rank routes its own groups (the JAX package's
``shard(xg, "batch", None, None)``): routing and drops are the
single-device ones group for group, the weights enter the rank's rows
(``batch_enter``: their gradient sums over the batch axes) and the load
balance's counts and probabilities sum over the batch axes
(``batch_reduce``) before they are divided by the global counts.
Otherwise (a decode wave: one group of the whole wave, which the JAX
package replicates too) the block's input is joined over the batch axes
(``batch_gather``), routed whole on every rank, and this rank's rows are
taken back out after.  "expert": each rank dispatches the pairs of its
own experts into their queues and runs ``_Moved`` and the products on
them; "ffn": each rank runs every expert on its ffn block, ``w_out``
row-parallel.  Either way the combined output is a partial sum over
"model" (``model_reduce``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import ACTIVATIONS, dense_init

__all__ = ["MoEConfig", "moe_init", "moe_apply", "moe_route",
           "group_and_capacity"]

_DISPATCHES = ("onehot", "gather")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden size
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"
    aux_loss_weight: float = 0.01
    group_size: int = 1024
    expert_sharding: str = "expert"   # 'expert' | 'ffn' (the full config's)
    dispatch: str = "onehot"          # 'onehot' | 'gather' (both by index)


def moe_init(gen: torch.Generator, cfg: MoEConfig, dtype=torch.float32):
    """Random expert weights on ``gen``'s device with the JAX initializers'
    distributions; the router stays float32 whatever ``dtype`` is."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dev = gen.device

    def normal(shape, std):
        return (std * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    return {
        "router": dense_init(gen, d, e, torch.float32),
        "w_gate": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_up": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_out": normal((e, f, d), 1.0 / math.sqrt(f)),
    }


def group_and_capacity(cfg: MoEConfig, n: int) -> Tuple[int, int]:
    """(group size, capacity) for ``n`` tokens, the JAX package's host
    arithmetic: the group size halves until it divides ``n``."""
    gs = min(cfg.group_size, n)
    while n % gs:
        gs //= 2
    cap = max(cfg.top_k, int(cfg.capacity_factor * gs * cfg.top_k
                             / cfg.n_experts))
    return gs, min(cap, gs)


def moe_route(p, cfg: MoEConfig, xg: torch.Tensor, cap: int,
              n_ranks: int = 1):
    """Routing of the groups ``xg`` [g, gs, d]: (expert_idx [g, gs, k]
    int64, place [g, gs, k] int64, keep [g, gs, k] bool, gates [g, gs, k]
    float32 with the dropped pairs zeroed, aux float32 scalar).
    ``n_ranks`` > 1: ``xg`` is this rank's share of the groups of that
    many batch ranks, and the aux loss is the global one (its counts and
    probabilities summed over the batch axes)."""
    g, gs, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = xg.float() @ p["router"]                        # [g, gs, e]
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the k largest, the lower index first among equal values
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = order.values[..., :k], order.indices[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    onehot = torch.nn.functional.one_hot(expert_idx, e)      # [g, gs, k, e]
    if n_ranks == 1:
        f_e = onehot.sum(dim=(0, 1, 2)).float() / (g * gs * k)
        p_e = probs.mean(dim=(0, 1))
    else:
        n = g * gs * n_ranks
        f_e = L.batch_reduce(onehot.sum(dim=(0, 1, 2)).float()) / (n * k)
        p_e = L.batch_reduce(probs.sum(dim=(0, 1))) / n
    aux = cfg.aux_loss_weight * e * torch.sum(f_e * p_e)

    # each pair's place in its expert's queue, token-major and slot-minor:
    # a running count over the group's pairs, expert by expert (int32 and
    # the pairs innermost: an int64 scan over the middle axis took 1.9 ms a
    # layer of granite's training step on the card)
    flat = onehot.reshape(g, gs * k, e).transpose(1, 2).to(torch.int32)
    flat = flat.contiguous()                                 # [g, e, gs * k]
    before = torch.cumsum(flat, dim=2) - flat
    place = (before * flat).sum(1).reshape(g, gs, k).long()
    keep = place < cap
    return expert_idx, place, keep, gate * keep, aux


def _own_groups(tokens: int, gs: int) -> bool:
    """Whether a rank's ``tokens`` rows are whole groups of ``gs``: it then
    routes them itself (the global groups fall evenly on the batch ranks,
    rank-major, as GSPMD shards them)."""
    return tokens % gs == 0


class _Moved(torch.autograd.Function):
    """Rows of ``src`` [m, d] picked by ``pick`` (index m: a zero row):
    the MoE's dispatch and combine, which move each row to at most one
    place.  Its gradient picks the output's gradient rows by ``back``, the
    inverse map (index len(pick): a zero row), summed over each ``fold``
    consecutive picks (a token's k slots in the dispatch).  So both
    directions are gathers: autograd's gradient of a gather would add
    every empty place's zero row into one row, a sorted accumulation that
    took 86% of a granite training step on the card."""

    @staticmethod
    def forward(ctx, src, pick, back, fold: int):
        ctx.save_for_backward(back)
        ctx.rows, ctx.fold = src.shape[0], fold
        return F.pad(src, (0, 0, 0, 1)).index_select(0, pick)

    @staticmethod
    def backward(ctx, grad):
        (back,) = ctx.saved_tensors
        g = F.pad(grad, (0, 0, 0, 1)).index_select(0, back)
        if ctx.fold > 1:
            g = g.reshape(ctx.rows, ctx.fold, -1).sum(dim=1)
        return g, None, None, None


def moe_apply(p, cfg: MoEConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (y [B, T, d] in x's dtype, aux loss scalar)."""
    if cfg.dispatch not in _DISPATCHES:
        raise ValueError(f"dispatch must be one of {_DISPATCHES}, got "
                         f"{cfg.dispatch!r}")
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    nb = L.batch_size() if L.batch_sharded() else 1
    gs, cap = group_and_capacity(cfg, b * t * nb)
    gather = nb > 1 and not _own_groups(b * t, gs)
    if gather:
        x = L.batch_gather(x, 0)          # the whole batch on every rank
        b = x.shape[0]
    elif nb > 1:
        p = {name: L.batch_enter(w) for name, w in p.items()}
    g = b * t // gs
    xg = x.reshape(g, gs, d)
    expert_idx, place, keep, gate, aux = moe_route(
        p, cfg, xg, cap, 1 if gather else nb)

    # this rank's experts [lo, lo + el) ("expert"), or every expert on an
    # ffn block ("ffn"); tp: the output is a partial sum over "model"
    el = p["w_gate"].shape[0]
    tp = L.parallel() and (el != e or p["w_gate"].shape[-1] != cfg.d_ff)
    lo = L.model_rank() * el if el != e else 0
    if tp:
        x, gate = L.model_enter(x), L.model_enter(gate)
        keep = keep & (expert_idx >= lo) & (expert_idx < lo + el)

    # each pair's slot in the experts' queues [el, g, cap] (n_slots when it
    # was dropped or is another rank's), and each slot's pair (n_pairs when
    # it is empty)
    dev = x.device
    grp = torch.arange(g, device=dev)[:, None, None]
    n_slots, n_pairs = el * g * cap, g * gs * k
    pair_slot = torch.where(keep, ((expert_idx - lo) * g + grp) * cap + place,
                            n_slots).reshape(-1)
    slot_pair = torch.full((n_slots + 1,), n_pairs, dtype=torch.long,
                           device=dev)
    slot_pair.scatter_(0, pair_slot, torch.arange(n_pairs, device=dev))
    slot_pair = slot_pair[:n_slots]

    # dispatch: each slot takes its pair's token row (an empty one a zero
    # row, as in the JAX package)
    slot_tok = torch.where(slot_pair < n_pairs, slot_pair // k, g * gs)
    xe = _Moved.apply(x.reshape(g * gs, d), slot_tok, pair_slot, k)
    xe = xe.reshape(el, g * cap, d)

    act = ACTIVATIONS[cfg.activation]
    h = act(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_out"]).reshape(n_slots, d)

    # combine: each pair takes its slot's output (a dropped one a zero
    # row), weighted by its gate, summed over the k slots of a token
    picked = _Moved.apply(ye, pair_slot, slot_pair, 1).reshape(g, gs, k, d)
    y = (picked * gate[..., None].to(picked.dtype)).sum(dim=2)
    y = y.reshape(b, t, d)
    if tp:
        y = L.model_reduce(y)
    if gather:
        y = L.batch_split(y, 0)
    return y, aux
