"""Carry a model's arrays from the JAX package into the port.

Two kinds of model: a spiking network (``load_arrays``, ``init_state``) and
an LM's parameter tree (``load_lm_params``).

The arrays arrive as plain numpy (this module never imports ``repro`` or
``jax``; the caller exports them), in this layout::

    {"populations": {pop: {"params": {name: array or float},
                           "state":  {var: array [n]}}},
     "synapses":    {group: {"g", "post_ind", "valid": [n_pre, K] arrays,
                             "delay": [n_pre, K] int array or None,
                             "dense": [n_pre, n_post] array or None,
                             "sign": float, "representation": str,
                             "delay_steps": int, "max_delay": int,
                             "cursor": int (optional),
                             "state": {"g": [n_pre, K] array} (optional:
                                      a state-resident g)}},
     "key": uint32 [2] (optional), "t": float (optional)}

``load_arrays`` returns a port model that computes what the exported one
computes: the port model's spec supplies the models and snippets, the
arrays supply the graph, the parameters and the representation and delay
settings, and keeps the model's probes, custom updates and monitor.
``init_state`` starts it from the exported state: each population's
variables and, where given, the JAX state's key
(``jax.random.key_data(state.key)``), ``t``, the delay rings' cursors and
the state-resident ``g`` of plastic or custom-updated groups.
``health_state`` makes the monitor's accumulator from a JAX
``HealthState`` exported to numpy (``{"spike_total": {pop: int},
"rate_ema_hz": {pop: float}, "steps", "nonfinite", "first_bad_step"}``).

An LM's parameters arrive as the JAX tree exported to numpy: nested dicts
and lists with the JAX keys and the ``[n, ...]`` / ``[R, n, ...]`` stacking
(``jax.tree.map(np.asarray, params)``).  ``load_lm_params`` returns the same
tree as tensors in the config's dtype on ``device``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.snn.network import Network
from repro_torch.core.snn.simulator import SimState, Simulator
from repro_torch.core.snn.spec import CompiledModel, _param_on
from repro_torch.core.snn.synapses import SynapseGroup
from repro_torch.models.transformer import resolve_dtype
from repro_torch.obs import health as HE
from repro_torch.sparse import formats as F

__all__ = ["load_arrays", "init_state", "health_state", "load_lm_params"]


def _check_names(what: str, have, got) -> None:
    if set(have) != set(got):
        raise ValueError(f"{what} differ: model has {sorted(have)}, arrays "
                         f"have {sorted(got)}")


def load_arrays(model: CompiledModel, arrays: Mapping) -> CompiledModel:
    """A copy of ``model`` (on its device) whose population parameters and
    synapse groups come from ``arrays``."""
    dev = model.device
    pops_in = arrays["populations"]
    syn_in = arrays["synapses"]
    _check_names("populations", model.network.populations, pops_in)
    _check_names("synapse groups", model.group_names, syn_in)
    net = Network(name=model.network.name)
    for name, pop in model.network.populations.items():
        params = {k: _param_on(v, dev)
                  for k, v in pops_in[name].get("params", {}).items()}
        unknown = set(params) - set(pop.model.params)
        if unknown:
            raise ValueError(f"population {name!r}: unknown parameters "
                             f"{sorted(unknown)}")
        net.add_population(name, pop.model, pop.n,
                           params={**pop.params, **params},
                           input_fn=pop.input_fn,
                           edge_spikes=pop.edge_spikes)
    for grp in model.network.synapses:
        a = syn_in[grp.name]
        delay = a.get("delay")
        dense = a.get("dense")
        net.add_synapse(SynapseGroup(
            name=grp.name, pre=grp.pre, post=grp.post,
            ell=F.triple_to_ell(a["post_ind"], a["g"], a["valid"],
                                net.populations[grp.post].n, delay=delay,
                                device=dev),
            dense=(None if dense is None else torch.tensor(
                np.asarray(dense, np.float32), device=dev)),
            representation=str(a["representation"]),
            propagation=grp.propagation, wum=grp.wum, psm=grp.psm,
            delay_steps=int(a.get("delay_steps", 0)),
            max_delay=(None if delay is None else int(a["max_delay"])),
            sign=float(a["sign"]), mutable_g=grp.mutable_g))
    old = model.simulator
    sim = Simulator(net, dt=model.dt, seed=old.seed, device=dev,
                    probes=old.probes,
                    custom_updates=tuple(old.custom_updates.values()),
                    monitor=old.monitor)
    return CompiledModel(spec=model.spec, network=net, simulator=sim)


def init_state(model: CompiledModel, arrays: Mapping,
               batch: int = 1) -> SimState:
    """``model``'s initial state with each population's variables taken
    from ``arrays`` (copied to every batch member), and the key (uint32
    words, as int32 bits), ``t`` (float32) and each delay ring's cursor
    (int32) where ``arrays`` holds them."""
    key = arrays.get("key")
    if key is not None:
        key = torch.from_numpy(np.asarray(key, np.uint32).view(np.int32)
                               .copy())
    st = model.init_state(batch, key)
    dev = st.t.device
    for name, entry in arrays["populations"].items():
        for var, v in entry.get("state", {}).items():
            cur = st.neurons[name][var]
            t = torch.tensor(np.asarray(v, np.float32), device=cur.device)
            st.neurons[name][var] = t.expand(cur.shape).clone()
    if arrays.get("t") is not None:
        st.t = torch.full((batch,), np.float32(arrays["t"]),
                          dtype=torch.float32, device=dev)
    for name, entry in arrays["synapses"].items():
        if entry.get("cursor") is not None:
            if st.syn[name].cursor is None:
                raise ValueError(f"synapse group {name!r} has no delay ring "
                                 "for the exported cursor")
            st.syn[name].cursor = torch.full((batch,), int(entry["cursor"]),
                                             dtype=torch.int32, device=dev)
        g = entry.get("state", {}).get("g")
        if g is not None:
            cur = st.syn[name].g
            if cur is None:
                raise ValueError(f"synapse group {name!r} keeps no g in its "
                                 "state for the exported one")
            t = torch.tensor(np.asarray(g, np.float32), device=dev)
            st.syn[name].g = t.expand(cur.shape).clone()
    return st


def health_state(model: CompiledModel, arrays: Mapping,
                 batch: int = 1) -> HE.HealthState:
    """The monitor's accumulator [batch] of ``model`` from a JAX
    ``HealthState`` exported to numpy, copied to every batch member."""
    pops = model.network.populations
    _check_names("health populations", pops, arrays["spike_total"])
    dev = model.device

    def leaf(v, dtype):
        return torch.full((batch,), np.asarray(v).item(), dtype=dtype,
                          device=dev)

    return HE.HealthState(
        spike_total={p: leaf(arrays["spike_total"][p], torch.int32)
                     for p in pops},
        rate_ema_hz={p: leaf(np.float32(arrays["rate_ema_hz"][p]),
                             torch.float32) for p in pops},
        steps=leaf(arrays["steps"], torch.int32),
        nonfinite=leaf(bool(arrays["nonfinite"]), torch.bool),
        first_bad_step=leaf(arrays["first_bad_step"], torch.int32))


# leaves that the JAX package keeps in float32 whatever cfg.dtype: Mamba2's
# dt_bias, A_log and D, and the MoE router
_FLOAT32_LEAVES = ("dt_bias", "A_log", "D", "router")


def load_lm_params(cfg, arrays, device=None) -> Any:
    """The JAX parameter tree ``arrays`` (numpy leaves) as the port's tree:
    tensors in ``cfg.dtype`` on ``device`` (default: ``cuda``, raising
    without a card), the structure and keys unchanged.  That covers the
    dense family (embed, final_norm, lm_head; each layer's ln1, attn, ln2,
    mlp), the MoE layers' (ln1, attn, ln2 and moe: router, w_gate, w_up,
    w_out), Mamba2's (each layer's norm and ssm: w_in, conv_w, conv_b,
    dt_bias, A_log, D, norm_scale, w_out), zamba2's unstacked shared
    block, and whisper's encoder (``enc``: its stacked layers' ln1, attn,
    ln2, mlp, its norm and pos_embed) with each decoder layer's ln_x and
    xattn (the cross-attention's wq, wk, wv, wo), and paligemma's
    img_proj; Mamba2's dt_bias, A_log and D and the router stay float32, as in
    the JAX package.  bfloat16 leaves (numpy's ``ml_dtypes`` type) pass
    through float32, which holds them exactly."""
    dev = resolve_device(device)
    dtype = resolve_dtype(cfg.dtype)

    def walk(a, key=None):
        if isinstance(a, Mapping):
            return {k: walk(v, k) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return [walk(v) for v in a]
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        to = torch.float32 if key in _FLOAT32_LEAVES else dtype
        return torch.from_numpy(np.array(a)).to(dev, to)

    return walk(arrays)
