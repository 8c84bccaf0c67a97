"""Custom updates: codegen'd on-demand / scheduled state rewrites.

Counterpart of ``repro/core/snn/custom_updates.py``.  GeNN 4's
CustomUpdate: a snippet of update code targeting one neuron population or
synapse group, compiled through the same AST whitelist as every other model
snippet (``repro_torch.core.codegen``), run on demand
(``CompiledModel.custom_update(name, state)``) or every ``n`` steps inside
the run (weight normalization, homeostatic scaling, state resets):

    spec.add_custom_update(
        "normalize", "KC_DN",
        update_code="g = g * g_target / maximum(w_sum, 1e-9)",
        params={"g_target": 1.0},
        reduce={"w_sum": ("sum", "g", "post")})

Reductions are declared as data and computed from the state before the
update code runs:

- synapse-group targets take ``(op, var, axis)`` with axis ``"post"`` (per
  post neuron, gathered back to synapse shape), ``"pre"`` (per row) or
  ``"all"`` (one value);
- population targets take ``(op, var)``: one value over the neuron axis.

``op`` is sum / mean / max / min.  Every reduction keeps the batch axis:
each member of a batched state reduces its own tensors.

The "post" sum and mean are one launch of the ELL kernel
(``kernels.ops.ell_spmv_batched`` with every presynaptic row spiking):
it sums each post's valid slots in float64 and rounds once, so the result
does not depend on the order of its atomics (``index_add_`` on the card
would).  The mean divides by the post's valid-slot count, computed once.
max and min are ``scatter_reduce`` (exact in any order); "pre" and "all"
are masked reductions of rows or of the whole matrix.

A custom update that writes ``g`` makes the group's conductances
state-resident (``SynapseGroup.mutable_g``), which takes the ELL path as a
learning rule does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import codegen
from repro_torch.core.snn.errors import SpecError
from repro_torch.core.snn.probes import REDUCE_OPS, reduce_neutral
from repro_torch.kernels import ops as kops
from repro_torch.sparse import formats as F

__all__ = ["CustomUpdateSpec", "ResolvedCustomUpdate",
           "validate_update_scalars", "written_targets",
           "resolve_custom_updates", "group_reduce_host", "pop_reduce",
           "gather_post", "post_degree", "GROUP_AXES"]

GROUP_AXES = ("pre", "post", "all")


@dataclasses.dataclass(frozen=True)
class CustomUpdateSpec:
    """A custom update as declared on the ModelSpec (unresolved)."""

    name: str
    target: str
    update_code: str
    params: Mapping[str, float]
    reduce: Mapping[str, tuple]
    every: Optional[int]


@dataclasses.dataclass(frozen=True)
class ResolvedCustomUpdate:
    """A custom update bound to a built Network.

    kind:   "population" | "group"
    writes: target state vars the update code assigns
    reduce: reduction name -> (op, var, axis); axis "pop" for populations
    fn:     compiled apply(vars, params, reductions, externals)
    """

    name: str
    kind: str
    target: str
    update_code: str
    params: Dict[str, object]
    reduce: Dict[str, Tuple[str, str, str]]
    every: Optional[int]
    writes: frozenset
    denom_all: float
    fn: object


def validate_update_scalars(name: str, every) -> None:
    """The name/every checks, shared by ``ModelSpec.add_custom_update``
    and ``resolve_custom_updates``."""
    if not name or not isinstance(name, str):
        raise SpecError(f"custom update name must be a non-empty "
                        f"string, got {name!r}")
    if every is not None and (not isinstance(every, int)
                              or isinstance(every, bool) or every <= 0):
        raise SpecError(
            f"custom update {name!r}: every must be a positive int or "
            f"None (on-demand), got {every!r}")


def written_targets(spec: CustomUpdateSpec) -> frozenset:
    """Names the update code assigns (temporaries included)."""
    try:
        return frozenset(codegen.assigned_names(spec.update_code))
    except SyntaxError:
        return frozenset()


def resolve_custom_updates(specs, net) -> Tuple[ResolvedCustomUpdate, ...]:
    """Validate custom-update declarations against a built Network."""
    groups = {g.name: g for g in net.synapses}
    seen = set()
    out = []
    for cu in specs:
        validate_update_scalars(cu.name, cu.every)
        if cu.name in seen:
            raise SpecError(f"duplicate custom update name {cu.name!r}")
        seen.add(cu.name)
        where = f"custom update {cu.name!r}"
        if cu.target in net.populations:
            kind = "population"
            pop = net.populations[cu.target]
            var_keys = tuple(pop.model.state)
            param_keys = dict(pop.params)
            denom_all = float(pop.n)
        elif cu.target in groups:
            kind = "group"
            grp = groups[cu.target]
            var_keys = ("g",) + tuple(grp.wum.syn_state)
            param_keys = {}
            denom_all = float(int(grp.ell.valid.sum()))
        else:
            raise SpecError(
                f"{where}: unknown target {cu.target!r}; valid targets: "
                f"populations {sorted(net.populations)}, synapse groups "
                f"{sorted(groups)}")
        for k in list(cu.params) + list(dict(cu.reduce or {})):
            if k in ("dt", "t"):
                raise SpecError(
                    f"{where}: name {k!r} is reserved (the dt/t externals "
                    "are always visible to update code)")
        for k in cu.params:
            if k in var_keys or k in param_keys:
                raise SpecError(
                    f"{where}: parameter {k!r} shadows a state variable or "
                    f"model parameter of target {cu.target!r}")
        merged_params = {**param_keys, **dict(cu.params)}

        reduce_norm: Dict[str, Tuple[str, str, str]] = {}
        for rname, rspec in dict(cu.reduce or {}).items():
            if rname in var_keys or rname in merged_params:
                raise SpecError(
                    f"{where}: reduction name {rname!r} shadows a state "
                    f"variable or parameter of target {cu.target!r}")
            rspec = (tuple(rspec) if isinstance(rspec, (tuple, list))
                     else (rspec,))
            if kind == "population":
                if len(rspec) != 2:
                    raise SpecError(
                        f"{where}: population reductions are declared as "
                        f"(op, var); got {rspec!r}")
                op, var = rspec
                axis = "pop"
            else:
                if len(rspec) != 3:
                    raise SpecError(
                        f"{where}: synapse-group reductions are declared "
                        f"as (op, var, axis) with axis in {GROUP_AXES}; "
                        f"got {rspec!r}")
                op, var, axis = rspec
                if axis not in GROUP_AXES:
                    raise SpecError(
                        f"{where}: unknown reduction axis {axis!r}; valid "
                        f"axes: {list(GROUP_AXES)}")
            if op not in REDUCE_OPS:
                raise SpecError(
                    f"{where}: unknown reduction op {op!r}; valid ops: "
                    f"{list(REDUCE_OPS)}")
            if var not in var_keys:
                raise SpecError(
                    f"{where}: reduction {rname!r} reads unknown state "
                    f"variable {var!r} of target {cu.target!r}; valid "
                    f"variables: {sorted(var_keys)}")
            reduce_norm[rname] = (op, var, axis)

        try:
            fn = codegen.compile_custom_update(
                cu.name, cu.update_code, var_keys, tuple(merged_params),
                tuple(reduce_norm))
        except (codegen.CodegenError, SyntaxError) as e:
            raise SpecError(f"{where}: {e}") from None
        writes = written_targets(cu) & set(var_keys)
        if not writes:
            raise SpecError(
                f"{where}: update_code assigns none of target "
                f"{cu.target!r}'s state variables {sorted(var_keys)}; the "
                "update would be a no-op")
        if kind == "group" and "g" in writes and not groups[cu.target].plastic:
            raise SpecError(
                f"{where}: writes 'g' of synapse group {cu.target!r} but "
                "the group's conductances are not state-resident; build "
                "through ModelSpec (which marks the group mutable) or use "
                "a plastic weight-update model")
        out.append(ResolvedCustomUpdate(
            name=cu.name, kind=kind, target=cu.target,
            update_code=cu.update_code, params=merged_params,
            reduce=reduce_norm, every=cu.every, writes=writes,
            denom_all=denom_all, fn=fn))
    return tuple(out)


# ---------------------------------------------------------------------------
# reductions (the batch axis leads every result)
# ---------------------------------------------------------------------------

def post_degree(ell: F.ELLSynapses) -> torch.Tensor:
    """Valid slots per post neuron, float32 [n_post] (the "post" mean's
    denominator)."""
    deg = torch.zeros(ell.n_post, dtype=torch.float32, device=ell.device)
    deg.index_add_(0, ell.post_ind.reshape(-1).long(),
                   ell.valid.reshape(-1).to(torch.float32))
    return deg


def _as_batched(val: torch.Tensor, batch: int) -> torch.Tensor:
    """A per-synapse array as [B, n_pre, K] float32 (a group's constant
    [n_pre, K] g is shared by every member)."""
    val = val.to(torch.float32)
    if val.dim() == 2:
        val = val.expand((batch,) + tuple(val.shape))
    return val


def _scatter_post(val: torch.Tensor, ell: F.ELLSynapses, op: str,
                  batch: int, degree: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """Per-post-neuron reduction [B, n_post] of a per-synapse array."""
    if op in ("sum", "mean"):
        # every row "spikes": one ELL launch sums each post's valid slots
        ones = torch.ones((batch, ell.n_pre), dtype=torch.bool,
                          device=val.device)
        g = val.to(torch.float32).contiguous()
        tot = kops.ell_spmv_batched(
            F.ELLSynapses(g=g, post_ind=ell.post_ind, valid=ell.valid,
                          n_post=ell.n_post), ones)
        if op == "sum":
            return tot
        deg = post_degree(ell) if degree is None else degree
        return torch.where(deg > 0, tot / torch.clamp(deg, min=1.0), 0.0)
    fill = reduce_neutral(op)
    masked = torch.where(ell.valid, _as_batched(val, batch), fill)
    out = torch.full((batch, ell.n_post), fill, dtype=torch.float32,
                     device=val.device)
    idx = ell.post_ind.reshape(1, -1).long().expand(batch, -1)
    return out.scatter_reduce_(1, idx, masked.reshape(batch, -1),
                               "amax" if op == "max" else "amin")


def gather_post(per_post: torch.Tensor, post_ind: torch.Tensor
                ) -> torch.Tensor:
    """A per-post reduction [B, n_post] broadcast back to synapse shape
    [B, n_pre, K]."""
    return per_post[:, post_ind.long()]


def _row_reduce(val: torch.Tensor, valid: torch.Tensor, op: str
                ) -> torch.Tensor:
    """Per-row reduction [B, n_pre] of a per-synapse array."""
    masked = torch.where(valid, val.to(torch.float32), reduce_neutral(op))
    if op == "sum":
        return masked.sum(dim=-1)
    if op == "mean":
        cnt = valid.to(torch.float32).sum(dim=-1)
        return torch.where(cnt > 0, masked.sum(dim=-1)
                           / torch.clamp(cnt, min=1.0), 0.0)
    if op == "max":
        return masked.amax(dim=-1)
    return masked.amin(dim=-1)


def group_reduce_host(op: str, val: torch.Tensor, ell: F.ELLSynapses,
                      axis: str, denom_all: float, batch: int,
                      degree: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One declared reduction of a group, shaped to broadcast against the
    [B, n_pre, K] update environment: [B, n_pre, K] for "post",
    [B, n_pre, 1] for "pre", [B, 1, 1] for "all"."""
    if axis == "post":
        per_post = _scatter_post(val, ell, op, batch, degree)
        return gather_post(per_post, ell.post_ind)
    if axis == "pre":
        return _row_reduce(_as_batched(val, batch), ell.valid, op)[..., None]
    masked = torch.where(ell.valid, _as_batched(val, batch),
                         reduce_neutral(op))
    if op == "sum":
        r = masked.sum(dim=(-2, -1))
    elif op == "mean":
        r = masked.sum(dim=(-2, -1)) / denom_all
    elif op == "max":
        r = masked.amax(dim=(-2, -1))
    else:
        r = masked.amin(dim=(-2, -1))
    return r[:, None, None]


def pop_reduce(op: str, val: torch.Tensor, denom: float) -> torch.Tensor:
    """A population-axis reduction of [B, n], as [B, 1]."""
    val = val.to(torch.float32)
    if op == "sum":
        r = val.sum(dim=-1)
    elif op == "mean":
        r = val.sum(dim=-1) / denom
    elif op == "max":
        r = val.amax(dim=-1)
    else:
        r = val.amin(dim=-1)
    return r[:, None]
