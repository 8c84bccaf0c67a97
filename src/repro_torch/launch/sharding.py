"""Sharding rules, the counterpart of ``repro/launch/sharding.py``: the LM
half (param / optimizer / batch / cache PartitionSpecs a mesh, placed as
DTensors) and the SNN half (neuron-axis sharding of engine state).

LM: tensor parallelism over "model", FSDP (ZeRO-3-style parameter and
optimizer sharding) over the batch axes, one rule table for every family,
copied rule for rule from the JAX package: candidate axes for each
trailing dim of a leaf, allocated greedily with divisibility and no axis
used twice (granite's 32 experts take "model", mixtral's 8 leave it to
the per-expert ffn dim).  A spec is a tuple, an entry per dim: None, an
axis name, or a tuple of the batch axes (JAX's ``PartitionSpec``
entries).  ``spec_tree_to_shardings`` turns specs into ``NamedSharding``s
(DTensor placements on the mesh's DeviceMesh); ``activate(mesh)`` binds
the logical-axis env the model code reads (``models/layers.py``).  Where
the JAX package lets GSPMD insert the collectives, the port's model code
issues them on the ranks' blocks (``models/layers.py``).

SNN: every population is split along its neuron dimension over the mesh's
ranks: a population of n neurons pads to ``neuron_pad(n, D)`` and rank d
holds lanes [d * S, (d + 1) * S), S = padded / D.  These helpers own that
layout so the engine, ``convert``'s shard / gather and the tests agree on
it.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.launch.mesh import batch_axes
from repro_torch.models.layers import clear_axis_env, set_axis_env

__all__ = ["activate", "param_specs", "param_shardings", "batch_specs",
           "cache_shardings", "spec_tree_to_shardings", "NamedSharding",
           "place_params", "local_rows",
           "neuron_pad", "pad_neuron_axis", "snn_shardings"]


@contextlib.contextmanager
def activate(mesh, batch_sharded: bool = False):
    """Bind logical axes for the model code's sharding points;
    ``batch_sharded``: the entry point gives the model this rank's part
    of a batch split over the batch axes."""
    ba = batch_axes(mesh)
    bs = math.prod(mesh.shape[a] for a in ba) if ba else 1
    ms = mesh.shape.get("model", 1)
    set_axis_env(ba, "model", bs, ms, mesh=mesh, batch_sharded=batch_sharded)
    try:
        yield mesh
    finally:
        clear_axis_env()


# --------------------------------------------------------------------------
# rule table: path-regex -> candidate axes for the trailing dims.
# "fsdp" = the batch axes tuple; "model" = the model axis; None = replicated.
# Leading (stack) dims not covered by a rule are never sharded.
# --------------------------------------------------------------------------
_RULES: List[Tuple[str, List[Optional[str]]]] = [
    # order matters: first match wins; rules align to TRAILING dims so layer
    # stacks ([R, n, ...]) never shard their stack dims.
    (r"moe/(w_gate|w_up)$",       ["model", "fsdp", "model"]),  # [E, d, f]
    (r"moe/w_out$",               ["model", "model", "fsdp"]),  # [E, f, d]
    (r"moe/router$",              ["fsdp", None]),              # [d, E]
    (r"embed$",                   ["model", "fsdp"]),     # [V, d]
    (r"lm_head$",                 ["fsdp", "model"]),     # [d, V]
    (r"img_proj$",                [None, "fsdp"]),        # [1152, d]
    (r"pos_embed$",               [None, "fsdp"]),        # [Ta, d]
    (r"(wq|wk|wv)$",              ["fsdp", "model"]),     # [d, H*hd]
    (r"wo$",                      ["model", "fsdp"]),     # [H*hd, d]
    (r"(bq|bk|bv)$",              ["model"]),             # [H*hd]
    (r"ssm/w_in$",                ["fsdp", "model"]),
    (r"ssm/w_out$",               ["model", "fsdp"]),
    (r"(w_gate|w_up|w_in)$",      ["fsdp", "model"]),     # dense MLP [d, f]
    (r"w_out$",                   ["model", "fsdp"]),     # dense MLP [f, d]
    (r"conv_w$",                  [None, "model"]),       # [4, conv_dim]
    (r"conv_b$",                  ["model"]),
    (r"(dt_bias|A_log|D)$",       ["model"]),
    (r"norm_scale$",              ["model"]),             # [d_inner]
    (r"(scale|bias)$",            [None]),                # norms
]


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``tree``'s structure (dicts, lists, tuples) with each leaf replaced
    by ``fn(path, leaf)``; the path joins dict keys and list indices with
    "/", as the JAX package's ``_leaf_path``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, n),
                                           path + (n,))
                            for n in tree._fields))
    return fn("/".join(path), tree)


def _batch_entry(ba: Tuple[str, ...]):
    return ba if len(ba) > 1 else ba[0]


def _alloc(shape: Tuple[int, ...], cands: List[Optional[str]],
           mesh) -> tuple:
    """Greedy allocation of candidate axes to the trailing dims of shape."""
    ba = batch_axes(mesh)
    bsz = math.prod(mesh.shape[a] for a in ba) if ba else 1
    msz = mesh.shape.get("model", 1)
    ndim = len(shape)
    k = len(cands)
    cands = list(cands)
    if k > ndim:
        cands = cands[k - ndim:]
        k = ndim
    spec: List[Any] = [None] * ndim
    used = set()
    for j, cand in enumerate(cands):
        dim = ndim - k + j
        size = shape[dim]
        if cand == "fsdp":
            if ba and "fsdp" not in used and size % bsz == 0:
                spec[dim] = _batch_entry(ba)
                used.add("fsdp")
        elif cand == "model":
            if "model" in mesh.axis_names and "model" not in used \
                    and size % msz == 0:
                spec[dim] = "model"
                used.add("model")
    return tuple(spec)


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else 0


def param_specs(params, mesh):
    """The spec tree of a parameter tree (of tensors, DTensors or anything
    with a ``shape``)."""

    def spec_of(p, leaf):
        if _ndim(leaf) == 0:
            return ()
        for pat, cands in _RULES:
            if re.search(pat, p):
                return _alloc(tuple(leaf.shape), cands, mesh)
        return (None,) * _ndim(leaf)

    return _map_with_path(spec_of, params)


class NamedSharding:
    """A spec on a mesh (the JAX class's counterpart): ``placements`` are
    its DTensor placements on ``mesh.device_mesh`` (a dim split over
    several batch axes is split by each, outermost first, as JAX
    orders them); ``distribute(full)`` places a tensor that every rank
    holds whole as a DTensor of this rank's block (no communication)."""

    def __init__(self, mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.axis_names:
            dim = None
            for d, entry in enumerate(self.spec):
                names = entry if isinstance(entry, tuple) else (entry,)
                if axis in names:
                    dim = d
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)

    def distribute(self, full: torch.Tensor):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(full, self.mesh.device_mesh,
                                 self.placements, src_data_rank=None)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec})"


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def spec_tree_to_shardings(specs, mesh):
    def conv(tree):
        if _is_spec(tree):
            return NamedSharding(mesh, tree)
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v) for v in tree]
        return tree
    return conv(specs)


def param_shardings(params, mesh):
    return spec_tree_to_shardings(param_specs(params, mesh), mesh)


def local_rows(x, mesh, split: bool):
    """This rank's rows of a batch tensor split over the batch axes (the
    tensor itself when ``split`` is False)."""
    if not split or not isinstance(x, torch.Tensor):
        return x
    n, r = mesh.size("batch"), mesh.coord("batch")
    rows = x.shape[0] // n
    return x[r * rows:(r + 1) * rows]


def place_params(params, mesh):
    """Params that every rank holds whole, placed by ``param_specs``: each
    leaf a DTensor of this rank's block (no communication)."""
    shardings = param_shardings(params, mesh)

    def place(p, s):
        if isinstance(p, dict):
            return {k: place(p[k], s[k]) for k in p}
        if isinstance(p, list):
            return [place(a, b) for a, b in zip(p, s)]
        return s.distribute(p.detach())
    return place(params, shardings)


def batch_specs(batch, mesh):
    """Shard the leading (batch) dim of every batch leaf on the batch axes."""
    ba = batch_axes(mesh)
    bsz = math.prod(mesh.shape[a] for a in ba) if ba else 1

    def spec_of(_, leaf):
        if _ndim(leaf) == 0:
            return ()
        if leaf.shape[0] % bsz == 0:
            return (_batch_entry(ba),) + (None,) * (_ndim(leaf) - 1)
        return (None,) * _ndim(leaf)

    return _map_with_path(spec_of, batch)


def cache_shardings(caches, mesh):
    """KV caches: batch dim on batch axes when divisible, else shard the
    sequence dim (long-context batch=1 decode); kv feature dims on model
    when divisible, else the sequence dim when it is free.  SSM states:
    batch then heads.  Specs as tuples (the JAX package returns them as
    NamedShardings: ``spec_tree_to_shardings`` makes those)."""
    ba = batch_axes(mesh)
    bsz = math.prod(mesh.shape[a] for a in ba) if ba else 1
    msz = mesh.shape.get("model", 1)
    ba_spec = _batch_entry(ba) if ba else None

    def spec_of(p, leaf):
        if _ndim(leaf) == 0:
            return ()
        shape = tuple(leaf.shape)
        name = p.rsplit("/", 1)[-1]
        nd = len(shape)
        spec: List[Any] = [None] * nd
        if name in ("k", "v") and nd >= 4:
            # [..., B, S, kv, hd] with possible leading stack dims
            b_dim, s_dim, kv_dim = nd - 4, nd - 3, nd - 2
            if shape[b_dim] % bsz == 0 and ba:
                spec[b_dim] = ba_spec
            elif shape[s_dim] % bsz == 0 and ba:
                spec[s_dim] = ba_spec
            if shape[kv_dim] % msz == 0:
                spec[kv_dim] = "model"
            elif spec[s_dim] is None and shape[s_dim] % msz == 0:
                # kv heads don't divide the model axis: shard the sequence
                # dim instead (the port's decode joins it for the step)
                spec[s_dim] = "model"
        elif name == "ssd" and nd >= 4:
            b_dim, h_dim = nd - 4, nd - 3
            if shape[b_dim] % bsz == 0 and ba:
                spec[b_dim] = ba_spec
            if shape[h_dim] % msz == 0:
                spec[h_dim] = "model"
        elif name == "conv" and nd >= 3:
            b_dim, c_dim = nd - 3, nd - 1
            if shape[b_dim] % bsz == 0 and ba:
                spec[b_dim] = ba_spec
            if shape[c_dim] % msz == 0:
                spec[c_dim] = "model"
        return tuple(spec)

    return _map_with_path(spec_of, caches)


def neuron_pad(n: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= n (per-population padded size)."""
    return -(-int(n) // int(n_shards)) * int(n_shards)


def pad_neuron_axis(x: torch.Tensor, n_pad: int, axis: int = -1
                    ) -> torch.Tensor:
    """Pad a per-neuron tensor to the sharded size along ``axis``,
    edge-replicating so the padded lanes carry benign (bounded-dynamics)
    values."""
    axis = axis % x.dim()
    n = x.shape[axis]
    if n == n_pad:
        return x
    last = x.narrow(axis, n - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = n_pad - n
    return torch.cat([x, last.repeat(reps)], dim=axis)


def snn_shardings(axis: str) -> Dict[str, tuple]:
    """How each kind of engine state splits, as the JAX package's
    PartitionSpecs spell it (None: that axis is whole on every rank; the
    leading batch axis is never split):

    - "neuron": per-neuron state [B, n] split on its neuron axis
      (neurons, spikes, postsynaptic and trace state, pre traces on the
      pre population's axis);
    - "replicated": t, keys, ring cursors, the NaN guard's flag;
    - "block": connectivity [n_pre, K] and per-synapse state
      [B, n_pre, K], one post-shard block a rank (slots of the rank's
      post neurons, re-indexed locally; ``k_local`` the same on every
      rank);
    - "ring": dendritic rings [B, slots, n_post] split on their post
      axis;
    - "probe": unreduced probe rings [cap, B, n] split on their neuron
      axis (reduced probes are one value a sample, replicated)."""
    return {
        "neuron": (None, axis),
        "replicated": (None,),
        "block": (axis, None, None),
        "ring": (None, None, axis),
        "probe": (None, None, axis),
    }
