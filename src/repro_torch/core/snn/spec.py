"""ModelSpec: the declarative front-end for spiking networks.

Counterpart of ``repro/core/snn/spec.py``.  The network is declared as
data and code snippets, then `build` validates the spec, resolves the
seeded connectivity initializers (``init="host"``: numpy on the host, in
declaration order, then moved to the device; ``init="device"``:
``repro_torch.sparse.device_init`` on the device itself, from counter-based
threefry keys; either way the same spec and seed give the JAX package's
graph of that ``init`` bit for bit), runs the paper's representation
choice (eqs. (1)/(2)) and generates the simulator.

    spec = ModelSpec("demo")
    spec.add_neuron_population("exc", 160, "izhikevich", input_fn=thalamic)
    spec.add_synapse_population("ee", "exc", "exc",
                                connect=FixedFanout(40),
                                weight=UniformWeight(0.0, 0.5),
                                psm=ExpDecay(5.0))
    model = spec.build(dt=1.0, seed=0)          # on "cuda" unless told
    res = model.run(400)
    sweep = model.sweep_gscale("ee", torch.logspace(-1, 1, 16), n_steps=400)

``CompiledModel.run`` and ``sweep_gscale`` go through the simulator's
compiled step loop (``Simulator.run_compiled``: CUDA graphs on the card,
the same chunks eagerly on the CPU), cached as the JAX package caches its
executables; ``Simulator.run`` stays the eager loop.

`post` may be a list of population names: one connectivity draw is made
over the concatenated target space and split per post population (the
paper's cortical-net construction).

Observation and intervention, as in the JAX package: ``probe`` declares a
recording (``run`` and ``sweep_gscale`` return ``Recordings``: [cap, ...]
for a single run, [n_candidates, cap, ...] for a sweep),
``add_custom_update`` a codegen'd state rewrite (on demand through
``CompiledModel.custom_update``, or every n steps inside the run), and
``build(monitor=HealthConfig(...))`` the health monitor (``RunResult.health``).
``memory_report`` accounts the graph, the state, the probe rings (spike
rings at their packed int32 size) and the custom updates.

Serving: ``init_stream_state`` / ``select_streams`` / ``serve_chunk`` and
``serve`` (a ``repro_torch.launch.snn_serve.SNNServer``), the stream axis
being the batch axis; ``serve_chunk`` replays one CUDA graph a
configuration.

Meshes: ``build(mesh=make_snn_mesh(...))`` (``repro_torch.launch.mesh``,
called by every rank) partitions every population along the neuron axis
over the mesh's ranks, and ``run``, ``step``, ``sweep_gscale``, the serving
calls and ``custom_update`` run on the ``ShardedEngine``
(``core/snn/engine.py``) with the single-device results; ``init="device"``
with a mesh makes each rank's blocks from its own rows
(``device_init_local``), though every rank also holds the full graph and a
full ``Simulator`` (see ``build``).  ``plan`` sizes a spec's per-device
memory at any device count without building.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import random as RND
from repro_torch._device import resolve_device
from repro_torch.core.codegen import (NeuronModel, PostsynapticModel,
                                      WeightUpdateModel, assigned_names)
from repro_torch.core.snn import bitmask as BM
from repro_torch.core.snn import custom_updates as CU
from repro_torch.core.snn import probes as PR
from repro_torch.core.snn.custom_updates import CustomUpdateSpec
from repro_torch.core.snn.errors import SpecError
from repro_torch.core.snn.network import InputFn, Network
from repro_torch.core.snn.probes import ProbeSpec, Recordings
from repro_torch.core.snn.simulator import RunResult, SimState, Simulator
from repro_torch.core.snn.synapses import PROPAGATIONS, Pulse, SynapseGroup
from repro_torch.kernels import autotune as AT
from repro_torch.obs import trace
from repro_torch.obs.health import HealthConfig
from repro_torch.sparse import device_init as DI
from repro_torch.sparse import formats as F

__all__ = ["ModelSpec", "CompiledModel", "SweepResult", "SpecError",
           "MAX_DELAY_STEPS"]

# weight initialization: scalar, or (rng, shape) -> array
WeightInit = Union[None, float, int, Callable[..., np.ndarray]]

# delay initialization: steps (int), or a per-synapse DelaySnippet
DelayInit = Union[None, int, F.DelaySnippet]

_REPRESENTATIONS = ("auto", "sparse", "dense")

# Dendritic ring capacity: every delayed group carries a
# [B, max_delay+1, n_post] ring on the device for the whole simulation.
# Delays above this bound are almost certainly a unit error (steps vs ms).
MAX_DELAY_STEPS = 1024


@dataclasses.dataclass
class NeuronPopSpec:
    name: str
    n: int
    model: NeuronModel
    params: Dict[str, object]
    input_fn: Optional[InputFn]
    edge_spikes: Optional[bool]


@dataclasses.dataclass
class SynapsePopSpec:
    name: str
    pre: str
    post: Tuple[str, ...]
    connect: F.ConnectivityInit
    weight: WeightInit
    wum: Optional[WeightUpdateModel]
    psm: PostsynapticModel
    delay_steps: int
    delay: Optional[F.DelaySnippet]
    delay_ms: Optional[float]
    sign: float
    representation: str
    propagation: str = "auto"

    def group_names(self) -> List[str]:
        if len(self.post) == 1:
            return [self.name]
        return [f"{self.name}_{p}" for p in self.post]


def _where(xp, mask, a, b, dtype):
    """``where(mask, a, b)`` as ``dtype`` in numpy (a host build) or torch
    (a device build, on the mask's device)."""
    if xp is np:
        return np.where(mask, a, b).astype(dtype)
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, device=mask.device)
    return torch.where(mask, a, torch.tensor(b, dtype=a.dtype,
                                             device=mask.device)).to(dtype)


def _as_weight_fn(weight: WeightInit):
    """Normalize the weight initializer to the (rng, shape) protocol.
    Scalars consume no rng draws."""
    if weight is None or callable(weight):
        return weight
    w = float(weight)
    return lambda rng, shape: np.full(shape, w, np.float32)


def _param_on(v, device: torch.device):
    """A neuron parameter as the update reads it: Python float for a
    scalar, float32 tensor on ``device`` for a per-neuron array."""
    if isinstance(v, torch.Tensor):
        return (float(v) if v.dim() == 0
                else v.to(device=device, dtype=torch.float32))
    arr = np.asarray(v, np.float32)
    if arr.ndim == 0:
        return float(arr)
    return torch.tensor(arr, device=device)


class ModelSpec:
    """Declarative network description; `build` compiles it."""

    def __init__(self, name: str = "model"):
        self.name = name
        self.populations: Dict[str, NeuronPopSpec] = {}
        self.synapses: List[SynapsePopSpec] = []
        self.probes: List[ProbeSpec] = []
        self.custom_updates: List[CustomUpdateSpec] = []

    def _declared_targets(self) -> Tuple[set, set]:
        """(population names, concrete synapse group names) declared so
        far: the names probes and custom updates address."""
        groups = {n for s in self.synapses for n in s.group_names()}
        return set(self.populations), groups

    # -- declaration ------------------------------------------------------
    def add_neuron_population(
        self, name: str, n: int, model: Union[NeuronModel, str],
        params: Optional[Mapping[str, object]] = None,
        input_fn: Optional[InputFn] = None,
        edge_spikes: Optional[bool] = None,
    ) -> NeuronPopSpec:
        if not name or not isinstance(name, str):
            raise SpecError(f"population name must be a non-empty string, "
                            f"got {name!r}")
        if name in self.populations:
            raise SpecError(f"duplicate population name {name!r}")
        if not isinstance(n, int) or n <= 0:
            raise SpecError(f"population {name!r}: n must be a positive "
                            f"int, got {n!r}")
        if isinstance(model, str):
            from repro_torch.core.snn import neurons as _neurons
            try:
                model = _neurons.get_model(model)
            except KeyError as e:
                raise SpecError(f"population {name!r}: {e.args[0]}") from None
        if not isinstance(model, NeuronModel):
            raise SpecError(f"population {name!r}: model must be a "
                            f"NeuronModel or registry name, got "
                            f"{type(model).__name__}")
        merged = dict(model.params)
        for k, v in (params or {}).items():
            if k not in model.params:
                raise SpecError(
                    f"population {name!r}: unknown parameter {k!r} for "
                    f"neuron model {model.name!r}; valid parameters: "
                    f"{sorted(model.params)}")
            shape = np.shape(v)
            if shape and shape[0] != n:
                raise SpecError(
                    f"population {name!r}: per-neuron parameter {k!r} has "
                    f"leading dimension {shape[0]} != population size {n}")
            merged[k] = v
        pop = NeuronPopSpec(name=name, n=n, model=model, params=merged,
                            input_fn=input_fn, edge_spikes=edge_spikes)
        self.populations[name] = pop
        return pop

    def add_synapse_population(
        self, name: str, pre: str, post: Union[str, Sequence[str]],
        connect: F.ConnectivityInit,
        weight: WeightInit = None,
        wum: Optional[WeightUpdateModel] = None,
        psm: Optional[PostsynapticModel] = None,
        delay_steps: int = 0,
        delay: DelayInit = None,
        delay_ms: Optional[float] = None,
        sign: float = 1.0,
        representation: str = "auto",
        propagation: str = "auto",
    ) -> SynapsePopSpec:
        """Declare a synapse population.

        Delays (dendritic: the weighted current is buffered on the post
        side) come in three forms, at most one per population:
        ``delay_steps=k`` (homogeneous), ``delay=ConstantDelay(k) |
        UniformIntDelay(lo, hi) | int`` (per-synapse slot) and
        ``delay_ms=x`` (homogeneous, converted at build time; x must be an
        integer multiple of dt).

        ``propagation`` ("auto" | "dense" | "event") is validated as in the
        JAX package; the port's ELL kernel skips silent rows in every mode.
        """
        if not name or not isinstance(name, str):
            raise SpecError(f"synapse population name must be a non-empty "
                            f"string, got {name!r}")
        post_t = (post,) if isinstance(post, str) else tuple(post)
        if not post_t:
            raise SpecError(f"synapse population {name!r}: empty post list")
        if len(set(post_t)) != len(post_t):
            raise SpecError(
                f"synapse population {name!r}: duplicate post population "
                f"in {list(post_t)}")
        # declared names and expanded group names share one namespace:
        # gscales/sweep address either
        taken = {s.name for s in self.synapses}
        taken |= {n for s in self.synapses for n in s.group_names()}
        if isinstance(delay, int) and not isinstance(delay, bool):
            try:
                delay = F.ConstantDelay(delay)
            except ValueError as e:
                raise SpecError(
                    f"synapse population {name!r}: {e}") from None
        spec = SynapsePopSpec(
            name=name, pre=pre, post=post_t, connect=connect, weight=weight,
            wum=wum, psm=psm if psm is not None else Pulse(),
            delay_steps=delay_steps, delay=delay, delay_ms=delay_ms,
            sign=sign, representation=representation,
            propagation=propagation)
        new_names = spec.group_names()
        for gname in [name] + new_names:
            if gname in taken or new_names.count(gname) > 1:
                raise SpecError(f"duplicate synapse group name {gname!r}")
        for popname, what in [(pre, "pre")] + [(p, "post") for p in post_t]:
            if popname not in self.populations:
                raise SpecError(
                    f"synapse population {name!r}: unknown {what} "
                    f"population {popname!r}; declared populations: "
                    f"{sorted(self.populations)}")
        if not isinstance(spec.connect, F.ConnectivityInit):
            raise SpecError(
                f"synapse population {name!r}: connect must be a "
                f"ConnectivityInit (FixedFanout / FixedProbability / "
                f"OneToOne / DenseInit), got {type(connect).__name__}")
        if not isinstance(spec.psm, PostsynapticModel):
            raise SpecError(
                f"synapse population {name!r}: psm must be a "
                f"PostsynapticModel, got {type(spec.psm).__name__}")
        if wum is not None and not isinstance(wum, WeightUpdateModel):
            raise SpecError(
                f"synapse population {name!r}: wum must be a "
                f"WeightUpdateModel, got {type(wum).__name__}")
        if representation not in _REPRESENTATIONS:
            raise SpecError(
                f"synapse population {name!r}: representation "
                f"{representation!r} not in {_REPRESENTATIONS}")
        if propagation not in PROPAGATIONS:
            raise SpecError(
                f"synapse population {name!r}: propagation "
                f"{propagation!r} not in {PROPAGATIONS}")
        if propagation == "event" and representation == "dense":
            raise SpecError(
                f"synapse population {name!r}: propagation='event' is "
                "incompatible with representation='dense' (event-driven "
                "delivery reads ELL rows; the dense mirror has none); "
                "use representation 'sparse' or 'auto'")
        if (representation == "dense" and wum is not None
                and not wum.is_static_pulse):
            raise SpecError(
                f"synapse population {name!r}: representation='dense' is "
                f"incompatible with weight-update model {wum.name!r} "
                "(dynamic weights propagate via the ELL path); use "
                "'sparse' or 'auto'")
        if not isinstance(delay_steps, int) or delay_steps < 0:
            raise SpecError(
                f"synapse population {name!r}: delay_steps must be a "
                f"non-negative int, got {delay_steps!r}")
        declared = [d for d, used in [
            ("delay_steps", delay_steps != 0), ("delay", delay is not None),
            ("delay_ms", delay_ms is not None)] if used]
        if len(declared) > 1:
            raise SpecError(
                f"synapse population {name!r}: {' and '.join(declared)} are "
                "mutually exclusive; declare the delay exactly one way")
        if delay_steps > MAX_DELAY_STEPS:
            raise SpecError(
                f"synapse population {name!r}: delay_steps={delay_steps} "
                f"exceeds the dendritic ring capacity "
                f"MAX_DELAY_STEPS={MAX_DELAY_STEPS}")
        if delay is not None:
            if not isinstance(delay, F.DelaySnippet):
                raise SpecError(
                    f"synapse population {name!r}: delay must be an int or "
                    f"a DelaySnippet (ConstantDelay / UniformIntDelay), "
                    f"got {type(delay).__name__}")
            if delay.max_steps > MAX_DELAY_STEPS:
                raise SpecError(
                    f"synapse population {name!r}: "
                    f"{type(delay).__name__} max delay {delay.max_steps} "
                    f"exceeds the dendritic ring capacity "
                    f"MAX_DELAY_STEPS={MAX_DELAY_STEPS}")
            if representation == "dense":
                raise SpecError(
                    f"synapse population {name!r}: representation='dense' "
                    "is incompatible with per-synapse delays (the dense "
                    "mirror has no delay slot); use 'sparse' or 'auto'")
        if delay_ms is not None:
            if not isinstance(delay_ms, (int, float)) or delay_ms < 0:
                raise SpecError(
                    f"synapse population {name!r}: delay_ms must be a "
                    f"non-negative number, got {delay_ms!r}")
        if spec.psm.needs_v:
            for p in post_t:
                if "V" not in self.populations[p].model.state:
                    raise SpecError(
                        f"synapse population {name!r}: postsynaptic model "
                        f"{spec.psm.name!r} references V but post "
                        f"population {p!r} (model "
                        f"{self.populations[p].model.name!r}) has no "
                        "membrane state 'V'")
        self.synapses.append(spec)
        return spec

    # -- observation / intervention ---------------------------------------
    def probe(self, name: str, target: str, var: str, every: int = 1,
              window: Optional[int] = None,
              reduce: Optional[str] = None) -> ProbeSpec:
        """Declare a recording probe on a population or synapse group.

        target: a population or a concrete synapse group (declared first);
        var:    a neuron state variable or ``"spikes"`` (populations); a
                postsynaptic / trace variable, ``"g"`` (state-resident
                weights) or a per-synapse variable (groups);
        every:  sample every k-th step (after the step);
        window: keep only the last ``window`` samples;
        reduce: "sum" | "mean" | "max" | "min" over the neuron axis
                (required for per-synapse variables).
        """
        PR.validate_probe_scalars(name, every, window, reduce)
        if any(p.name == name for p in self.probes):
            raise SpecError(f"duplicate probe name {name!r}")
        pops, groups = self._declared_targets()
        if target not in pops and target not in groups:
            multi = [n for s in self.synapses
                     if len(s.post) > 1 and s.name == target
                     for n in s.group_names()]
            hint = (f"; {target!r} is a multi-post synapse population: "
                    f"probe one of its concrete groups {multi}"
                    if multi else "")
            raise SpecError(
                f"probe {name!r}: unknown target {target!r}; declared "
                f"populations: {sorted(pops)}, synapse groups: "
                f"{sorted(groups)}{hint}")
        p = ProbeSpec(name=name, target=target, var=var, every=every,
                      window=window, reduce=reduce)
        self.probes.append(p)
        return p

    def add_custom_update(self, name: str, group: str, update_code: str,
                          params: Optional[Mapping[str, float]] = None,
                          reduce: Optional[Mapping[str, tuple]] = None,
                          every: Optional[int] = None) -> CustomUpdateSpec:
        """Declare a codegen'd custom update on a population or synapse
        group (GeNN 4's CustomUpdate).

        group:       target population or concrete synapse group;
        update_code: statements rewriting the target's state variables
                     (``g`` and per-synapse variables for groups, model
                     state for populations), AST-validated as every snippet;
        params:      update parameters (populations also read their model
                     parameters);
        reduce:      reductions computed before the code runs:
                     ``{"w_sum": ("sum", "g", "post")}`` for groups (axis
                     "pre" | "post" | "all"), ``{"v_max": ("max", "V")}``
                     for populations;
        every:       run every n steps inside the run; None: on demand only
                     (``CompiledModel.custom_update(name, state)``).
        """
        CU.validate_update_scalars(name, every)
        if any(cu.name == name for cu in self.custom_updates):
            raise SpecError(f"duplicate custom update name {name!r}")
        pops, groups = self._declared_targets()
        if group not in pops and group not in groups:
            raise SpecError(
                f"custom update {name!r}: unknown target {group!r}; "
                f"declared populations: {sorted(pops)}, synapse groups: "
                f"{sorted(groups)}")
        cu = CustomUpdateSpec(name=name, target=group,
                              update_code=update_code,
                              params=dict(params or {}),
                              reduce=dict(reduce or {}), every=every)
        self.custom_updates.append(cu)
        return cu

    def _mutable_groups(self) -> set:
        """Synapse groups whose g a declared custom update writes (their
        conductances become state)."""
        _, groups = self._declared_targets()
        out = set()
        for cu in self.custom_updates:
            if cu.target in groups:
                try:
                    writes = assigned_names(cu.update_code)
                except SyntaxError:
                    writes = set()
                if "g" in writes:
                    out.add(cu.target)
        return out

    # -- pre-flight capacity planning --------------------------------------
    def _plan_groups(self, dt: float) -> List[dict]:
        """Static per-group geometry the planner sizes from: nothing is
        allocated or resolved; connectivity widths come from the bounds
        ``device_init`` pads its slots to."""
        mutable = self._mutable_groups()
        groups = []
        for sp in self.synapses:
            n_pre = self.populations[sp.pre].n
            sizes = [self.populations[p].n for p in sp.post]
            n_post_total = int(sum(sizes))
            c = sp.connect
            if isinstance(c, F.FixedFanout):
                k = int(c.n_conn)
            elif isinstance(c, F.FixedProbability):
                k = DI._binomial_slots(n_post_total, c.p)
            elif isinstance(c, F.OneToOne):
                k = 1
            else:                       # DenseInit / unknown: worst case
                k = n_post_total
            if sp.delay is not None:
                ring_slots = sp.delay.max_steps + 1
            elif sp.delay_ms is not None:
                ring_slots = int(round(sp.delay_ms / dt)) + 1
            elif sp.delay_steps > 0:
                ring_slots = sp.delay_steps + 1
            else:
                ring_slots = 0
            wum = sp.wum
            plastic = ((wum is not None and not wum.is_static_pulse)
                       or any(g in mutable for g in sp.group_names()))
            for pname, n_p, gname in zip(sp.post, sizes, sp.group_names()):
                groups.append({
                    "name": gname, "pre": sp.pre, "post": pname,
                    "n_pre": n_pre, "n_post": n_p,
                    "n_post_total": n_post_total, "k": k,
                    "has_delay": sp.delay is not None,
                    "ring_slots": ring_slots, "plastic": plastic,
                    "n_pre_state": len(wum.pre_state) if wum else 0,
                    "n_post_state": len(wum.post_state) if wum else 0,
                    "n_syn_state": len(wum.syn_state) if wum else 0,
                    "n_psm_state": len(sp.psm.state)})
        return groups

    def _plan_at(self, D: int, dt: float, n_steps: Optional[int],
                 max_streams: int) -> dict:
        """Per-device byte breakdown at device count D (the planner's
        core; the JAX package's arithmetic)."""
        components = []

        def shard(n):
            return -(-int(n) // D)

        constr_fused = constr_part = 0
        steady = 0
        for gi in self._plan_groups(dt):
            K = gi["k"]
            # the post-partitioned slot width concentrates each row's K
            # slots onto D shards: binomial mean + 6 sigma
            q = min(1.0, shard(gi["n_post"]) / max(gi["n_post_total"], 1))
            k_local = int(min(K, np.ceil(
                K * q + 6.0 * np.sqrt(max(K * q * (1.0 - q), 0.0)) + 1)))
            k_local = max(k_local, 1)
            slot_b = F.ell_slot_bytes(gi["has_delay"])
            block_b = gi["n_pre"] * k_local * slot_b
            dyn_b = (gi["n_pre"] * k_local * 4
                     * ((1 if gi["plastic"] else 0) + gi["n_syn_state"])
                     + shard(gi["n_post"]) * 4
                     * (gi["n_psm_state"] + gi["n_post_state"])
                     + shard(gi["n_pre"]) * 4 * gi["n_pre_state"]
                     + gi["ring_slots"] * shard(gi["n_post"]) * 4)
            peak = DI.construction_peak_model(
                gi["n_pre"], K, D, k_local, has_delay=gi["has_delay"])
            constr_fused += peak["fused_local_bytes"]
            constr_part += peak["generate_partition_bytes"]
            steady += block_b + dyn_b * max_streams
            components.append({
                "name": gi["name"], "kind": "synapse_group",
                "bytes_per_device": block_b + dyn_b * max_streams,
                "construction_fused_bytes": peak["fused_local_bytes"],
                "construction_partition_bytes":
                    peak["generate_partition_bytes"],
                "k": K, "k_local": k_local})
        for name, pop in self.populations.items():
            nb = (len(pop.model.state) + 2) * shard(pop.n) * 4 \
                * max_streams
            steady += nb
            components.append({"name": name, "kind": "population",
                               "bytes_per_device": nb})
        if n_steps is not None:
            # probe rings (packed spike rows at their word size)
            pops, _ = self._declared_targets()
            for p in self.probes:
                cap = int(np.ceil(n_steps / p.every))
                if p.window is not None:
                    cap = min(cap, p.window)
                if p.reduce is not None:
                    bps = 4
                elif p.target in pops and p.var == "spikes":
                    bps = BM.words_for(shard(
                        self.populations[p.target].n)) * 4
                else:
                    width = (self.populations[p.target].n
                             if p.target in pops else max(
                                 (gi["n_post"]
                                  for gi in self._plan_groups(dt)
                                  if gi["name"] == p.target), default=1))
                    bps = shard(width) * 4
                nb = cap * bps * max_streams
                steady += nb
                components.append({"name": p.name, "kind": "probe",
                                   "bytes_per_device": nb,
                                   "is_packed": (p.reduce is None
                                                 and p.var == "spikes")})
        return {"steady_state_bytes": int(steady),
                "construction_fused_bytes": int(constr_fused),
                "construction_partition_bytes": int(constr_part),
                "peak_bytes": int(max(steady + constr_fused, steady)),
                "components": components}

    def plan(self, mesh_shape: int = 1, host_gib: float = 16.0,
             dt: float = 0.5, n_steps: Optional[int] = None,
             max_streams: int = 1) -> dict:
        """Pre-flight capacity planner: per-device construction and
        steady-state bytes at ``mesh_shape`` devices against a
        ``host_gib`` budget per device, without building anything (host
        arithmetic over ``construction_peak_model``; the JAX package's
        numbers for the same spec).

        Returns ``devices``, ``budget_bytes_per_device``, ``per_device``
        (``construction_fused_bytes`` for ``device_init_local``,
        ``construction_partition_bytes`` for generate-then-partition,
        ``steady_state_bytes``, ``peak_bytes``), the per-component
        breakdown, ``fits``, ``first_overflow`` (the first component that
        pushes the running total past the budget), ``min_devices`` and
        ``needs`` ("this spec needs N hosts" when it does not fit).

        The fused figure is the peak of a rank that holds only its own
        blocks.  ``build(mesh=)`` does not reach it yet: every rank also
        holds the full graph and a full ``Simulator`` (see ``build``)."""
        if not isinstance(mesh_shape, int) or mesh_shape <= 0:
            raise SpecError(f"plan: mesh_shape must be a positive int, "
                            f"got {mesh_shape!r}")
        budget = int(host_gib * (1 << 30))
        res = self._plan_at(mesh_shape, dt, n_steps, max_streams)
        first_overflow = None
        running = 0
        for comp in res["components"]:
            running += (comp["bytes_per_device"]
                        + comp.get("construction_fused_bytes", 0))
            if first_overflow is None and running > budget:
                first_overflow = comp["name"]
        fits = res["peak_bytes"] <= budget
        out = {"devices": mesh_shape,
               "budget_bytes_per_device": budget,
               "per_device": {
                   "construction_fused_bytes":
                       res["construction_fused_bytes"],
                   "construction_partition_bytes":
                       res["construction_partition_bytes"],
                   "steady_state_bytes": res["steady_state_bytes"],
                   "peak_bytes": res["peak_bytes"]},
               "components": res["components"],
               "fits": fits,
               "first_overflow": first_overflow}
        if not fits:
            D = mesh_shape
            while D < (1 << 24):
                D *= 2
                if self._plan_at(D, dt, n_steps,
                                 max_streams)["peak_bytes"] <= budget:
                    break
            out["min_devices"] = D
            out["needs"] = (f"this spec needs {D} hosts "
                            f"({host_gib} GiB each); first component over "
                            f"budget: {first_overflow}")
        else:
            out["min_devices"] = mesh_shape
            out["needs"] = "fits"
        return out

    # -- build ------------------------------------------------------------
    def build(self, dt: float = 0.5, seed: int = 0, init: str = "host",
              device=None, mesh=None, monitor=None) -> "CompiledModel":
        """Validate, resolve connectivity (seeded) and generate the
        simulator on ``device`` ("cuda" unless the caller asks for another;
        raises when no card is present and none was asked for).

        init="host" (default): initializers are resolved in declaration
        order from one numpy generator seeded with ``seed`` and the graph is
        copied to the device.

        init="device": connectivity is generated on ``device`` itself by
        ``repro_torch.sparse.device_init`` (the threefry kernels on a card,
        their plain versions on the CPU), O(nnz) memory, counter-based: the
        base key is ``PRNGKey(seed)`` and synapse population i's key
        ``fold_in(base, i)``, so the graph equals the JAX package's
        ``build(init="device")`` whatever the row chunking.  Weights must be
        snippets (UniformWeight / NormalWeight / ConstantWeight) or scalars;
        per-synapse delays are DelaySnippets, drawn through the same key
        schedule.

        mesh: a ``repro_torch.launch.mesh.Mesh`` (``make_snn_mesh``; every
        rank builds): populations are partitioned along the neuron axis
        over its ranks and the model runs on the ``ShardedEngine`` on the
        mesh's device (``device``, if given, must be it).  With
        ``init="device"`` each rank draws only its own rows of every group
        (``device_init_local``).  The full graph is drawn too, on every
        rank's device, for the network's accounting and ``gather_state``;
        every rank also builds a full single-device ``Simulator``, and the
        engine builds the full tables before it swaps in its blocks.  So a
        rank's device holds O(nnz) at any rank count: the JAX package's
        one-process mesh makes that full copy once, the port once a rank.
        A net larger than one card cannot be built over a mesh until it
        goes (ROADMAP Queue 1).

        monitor: a ``repro_torch.obs.health.HealthConfig``: the run
        accumulates spike totals, rate EMAs, silent/saturated bands and the
        first non-finite step, returned as ``RunResult.health``.  None or
        ``enabled=False`` builds the unmonitored step (no device op of
        it).

        Build phases are trace spans (``repro_torch.obs.trace``) under the
        JAX package's names: ``build``, ``validate``, ``host_init`` (or
        ``device_init``, its time including the device's work) per
        synapse population, ``codegen``, and a ``choose_block_spmv``
        instant per group (the rows the ELL kernel would walk); a device
        build's samplers add ``device_init.redraw`` instants (their redraw
        rounds)."""
        with trace.span("build", model=self.name, init=init,
                        sharded=mesh is not None):
            return self._build(dt=dt, seed=seed, init=init, device=device,
                               mesh=mesh, monitor=monitor)

    def _build(self, dt: float, seed: int, init: str, device, mesh,
               monitor) -> "CompiledModel":
        with trace.span("validate", populations=len(self.populations),
                        synapses=len(self.synapses)):
            self._validate_build(init, mesh, monitor)
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise SpecError(f"device {str(device)!r} is not the mesh's "
                                f"{str(mesh.device)!r}")
            device = mesh.device
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        base_key = RND.PRNGKey(seed, device=dev) if init == "device" else None
        mutable = self._mutable_groups()
        net = Network(name=self.name)
        for pop in self.populations.values():
            net.add_population(
                pop.name, pop.model, pop.n,
                params={k: _param_on(v, dev) for k, v in pop.params.items()},
                input_fn=pop.input_fn, edge_spikes=pop.edge_spikes)
        # init="device" with a mesh: each group's plan for the engine's
        # fused construction (every rank draws only its own rows)
        local_plans: Dict[str, DI.LocalInitPlan] = {}

        for sidx, sp in enumerate(self.synapses):
            n_pre = self.populations[sp.pre].n
            sizes = [self.populations[p].n for p in sp.post]
            n_post_total = int(sum(sizes))
            where = (f"synapse population {sp.name!r} "
                     f"({sp.pre} -> {'+'.join(sp.post)})")

            delay_steps = sp.delay_steps
            if sp.delay_ms is not None:
                steps_f = sp.delay_ms / dt
                steps = int(round(steps_f))
                if abs(steps_f - steps) > 1e-6:
                    raise SpecError(
                        f"{where}: delay_ms={sp.delay_ms} is not an "
                        f"integer multiple of dt={dt} "
                        f"({steps_f:.6g} steps); dendritic delays are "
                        "ring-buffered in whole dt steps")
                if steps > MAX_DELAY_STEPS:
                    raise SpecError(
                        f"{where}: delay_ms={sp.delay_ms} is {steps} steps "
                        f"at dt={dt}, exceeding the dendritic ring "
                        f"capacity MAX_DELAY_STEPS={MAX_DELAY_STEPS}")
                delay_steps = steps

            if init == "device":
                post_ind, g, valid, dd = self._device_init(
                    sp, base_key, sidx, n_pre, n_post_total, where)
                xp = torch
            else:
                try:
                    with trace.span("host_init", group=sp.name, rows=n_pre,
                                    n_post=n_post_total):
                        post_ind, g, valid = sp.connect.resolve(
                            rng, n_pre, n_post_total,
                            _as_weight_fn(sp.weight))
                except ValueError as e:
                    raise SpecError(f"{where}: {e}") from None
                # delays draw from the same rng *after* connectivity and
                # weights, so delay-free specs reproduce their graphs bit
                # for bit
                dd = (None if sp.delay is None
                      else sp.delay(rng, post_ind.shape))
                xp = np
            # zero delay draws in invalid slots (the ELLSynapses contract:
            # invalid slots -> 0)
            if dd is not None:
                dd = _where(xp, valid, dd, 0, xp.int32)
            lo = 0
            for pname, n_p, gname in zip(sp.post, sizes, sp.group_names()):
                hi = lo + n_p
                if len(sp.post) == 1:
                    idx, gg, vv, dv = post_ind, g, valid, dd
                else:
                    mask = (post_ind >= lo) & (post_ind < hi) & valid
                    idx = _where(xp, mask, post_ind - lo, 0, xp.int32)
                    gg = _where(xp, mask, g, 0.0, xp.float32)
                    vv = mask
                    dv = (None if dd is None
                          else _where(xp, mask, dd, 0, xp.int32))
                try:
                    # SynapseGroup owns the representation conflict rules
                    # (dense vs a custom update writing g included)
                    group = SynapseGroup(
                        name=gname, pre=sp.pre, post=pname,
                        ell=F.triple_to_ell(idx, gg, vv, n_p, delay=dv,
                                            device=dev),
                        representation=sp.representation,
                        propagation=sp.propagation,
                        wum=sp.wum, psm=sp.psm,
                        delay_steps=delay_steps,
                        max_delay=(None if sp.delay is None
                                   else sp.delay.max_steps),
                        sign=sp.sign, mutable_g=gname in mutable)
                except ValueError as e:
                    raise SpecError(f"{where}: {e}") from None
                net.add_synapse(group)
                if init == "device" and mesh is not None:
                    local_plans[gname] = DI.LocalInitPlan(
                        connect=sp.connect, key=RND.fold_in(base_key, sidx),
                        n_pre=n_pre, n_post_total=n_post_total,
                        weight=sp.weight, delay=sp.delay,
                        post_window=((lo, hi) if len(sp.post) > 1
                                     else None))
                lo = hi

        # the observation / intervention surface against the built network
        # (variables, reductions, writability)
        with trace.span("validate", probes=len(self.probes),
                        custom_updates=len(self.custom_updates)):
            probes = PR.resolve_probes(self.probes, net)
            custom = CU.resolve_custom_updates(self.custom_updates, net)
        # audit the rows the ELL kernel would walk for every group at the
        # JAX package's B = 1 (an instant per decision: rows, occupancy,
        # limiter, shared memory; auditable even for groups the
        # representation routed to the dense path): a delayed group's is
        # the delay scatter's plan over its ring's slots
        for g in net.synapses:
            AT.choose_block_spmv(
                g.ell.n_pre, g.ell.max_conn, g.ell.n_post, b=1,
                n_slots=g.ring_slots if g.ell.delay is not None else None,
                tag=f"{g.name}:{g.representation}")
        engine = None
        if mesh is not None:
            from repro_torch.core.snn.engine import ShardedEngine
            with trace.span("shard", devices=mesh.world_size):
                engine = ShardedEngine(net, mesh, dt=dt, seed=seed,
                                       probes=probes, custom_updates=custom,
                                       monitor=monitor,
                                       local_init=local_plans or None)
        with trace.span("codegen", populations=len(net.populations)):
            sim = Simulator(net, dt=dt, seed=seed, device=dev, probes=probes,
                            custom_updates=custom, monitor=monitor)
        return CompiledModel(spec=self, network=net, simulator=sim,
                             engine=engine)

    @staticmethod
    def _device_init(sp: SynapsePopSpec, base_key: torch.Tensor, sidx: int,
                     n_pre: int, n_post_total: int, where: str) -> tuple:
        """(post_ind, g, valid, delay or None) of synapse population ``sp``
        (the ``sidx``-th), generated on the base key's device from
        ``fold_in(base_key, sidx)``.  The span's time includes the device's
        work (it synchronizes the card at its end: a build-time wait)."""
        key = RND.fold_in(base_key, sidx)
        try:
            with trace.span("device_init", group=sp.name, rows=n_pre,
                            n_post=n_post_total):
                post_ind, g, valid = DI.device_resolve(
                    sp.connect, key, n_pre, n_post_total, sp.weight)
                dd = (None if sp.delay is None
                      else DI.device_delays(key, n_pre, post_ind.shape[1],
                                            sp.delay))
                if key.device.type == "cuda":
                    torch.cuda.synchronize(key.device)
        except (ValueError, TypeError, NotImplementedError) as e:
            # TypeError here is the declaration check (numpy weight
            # callables cannot run on the device), not a user bug
            raise SpecError(f"{where}: {e}") from None
        return post_ind, g, valid, dd

    def _validate_build(self, init: str, mesh, monitor) -> None:
        if mesh is not None and not all(
                hasattr(mesh, a) for a in ("rank", "world_size", "device",
                                           "all_gather")):
            raise SpecError(f"mesh must be a repro_torch.launch.mesh.Mesh "
                            f"(make_snn_mesh), got {type(mesh).__name__}")
        if monitor is not None:
            if not isinstance(monitor, HealthConfig):
                raise SpecError(f"monitor must be a HealthConfig, got "
                                f"{type(monitor).__name__}")
            try:
                monitor.validate(self.populations)
            except ValueError as e:
                raise SpecError(f"monitor: {e}") from None
        if init not in ("host", "device"):
            raise SpecError(f"init must be 'host' or 'device', got {init!r}")
        if not self.populations:
            raise SpecError(f"model {self.name!r} declares no populations")


@dataclasses.dataclass
class SweepResult:
    """One batched gscale sweep: per-candidate statistics."""

    values: torch.Tensor                   # [n_candidates]
    rates_hz: Dict[str, torch.Tensor]      # pop -> [n_candidates]
    finite: torch.Tensor                   # [n_candidates] bool
    spike_counts: Dict[str, torch.Tensor]  # pop -> [n_candidates, n]
    recordings: Optional[Recordings] = None  # [n_candidates, cap, ...]


def _member(x, i: int = 0):
    """Member i of every [B]-leading tensor of a dict / dataclass."""
    if isinstance(x, torch.Tensor):
        return x[i]
    if isinstance(x, dict):
        return {k: _member(v, i) for k, v in x.items()}
    return type(x)(**{f.name: _member(getattr(x, f.name), i)
                      for f in dataclasses.fields(x)})


def _squeeze(res: RunResult) -> RunResult:
    """A single-member run reported in the JAX package's shapes."""
    return RunResult(
        state=res.state,
        spike_counts={k: v[0] for k, v in res.spike_counts.items()},
        rates_hz={k: v[0] for k, v in res.rates_hz.items()},
        finite=res.finite[0],
        raster=(None if res.raster is None
                else {k: v[:, 0] for k, v in res.raster.items()}),
        recordings=(None if res.recordings is None
                    else _member(res.recordings)),
        health=None if res.health is None else _member(res.health))


def _expand_state(state: SimState, batch: int) -> SimState:
    """A single-member state copied to ``batch`` members (the sweep's
    shared starting point, its key, ``t`` and the rings' cursors
    included)."""
    def rep(x):
        if isinstance(x, torch.Tensor):
            if x.dim() == 0:
                return x.clone()
            return x.expand((batch,) + tuple(x.shape[1:])).clone()
        if isinstance(x, dict):
            return {k: rep(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(
                x, **{f.name: rep(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
        return x
    return SimState(neurons=rep(state.neurons), spikes=rep(state.spikes),
                    prev_above=rep(state.prev_above), syn=rep(state.syn),
                    t=rep(state.t), key=rep(state.key),
                    finite=rep(state.finite))


class CompiledModel:
    """A built network: validated spec + generated simulator, with `run`,
    `step` and the batched `sweep_gscale` the conductance-scaling study
    drives.  Built with a mesh, every call runs on the ``ShardedEngine``
    (``engine``; the same results, the neuron axis over the mesh's ranks,
    states sharded)."""

    def __init__(self, spec: ModelSpec, network: Network,
                 simulator: Simulator, engine=None):
        self.spec = spec
        self.network = network
        self.simulator = simulator
        self.engine = engine

    @property
    def backend(self) -> Simulator:
        """What runs the model: the engine when sharded, else the
        simulator."""
        return self.simulator if self.engine is None else self.engine

    @property
    def group_names(self) -> List[str]:
        return [g.name for g in self.network.synapses]

    @property
    def dt(self) -> float:
        return self.simulator.dt

    @property
    def device(self) -> torch.device:
        return self.simulator.device

    @property
    def monitor(self) -> Optional[HealthConfig]:
        """The HealthConfig the model was built with (None when
        unmonitored); monitored runs return ``RunResult.health``."""
        return self.simulator.monitor

    @property
    def probes(self) -> Tuple:
        """Resolved probes (declaration order)."""
        return self.simulator.probes

    @property
    def custom_update_names(self) -> List[str]:
        return sorted(self.simulator.custom_updates)

    def _expand_group(self, name: str) -> List[str]:
        """Resolve a synapse name to concrete group names: a multi-post
        population's declared name addresses all of its groups."""
        if name in set(self.group_names):
            return [name]
        for sp in self.spec.synapses:
            if sp.name == name:
                return sp.group_names()
        raise SpecError(
            f"unknown synapse group {name!r}; valid names: "
            f"{sorted(set(self.group_names) | {s.name for s in self.spec.synapses})}")

    def init_state(self, batch: int = 1,
                   key: Optional[torch.Tensor] = None) -> SimState:
        return self.backend.init_state(batch, key)

    def _norm_stim(self, stim) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
               for k, v in (stim or {}).items()}
        unknown = set(out) - set(self.network.populations)
        if unknown:
            raise SpecError(
                f"unknown stim population(s) {sorted(unknown)}; declared "
                f"populations: {sorted(self.network.populations)}")
        return out

    def _norm_gscales(self, gscales) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for k, v in (gscales or {}).items():
            for g in self._expand_group(k):
                if g in out:
                    raise SpecError(
                        f"gscales address synapse group {g!r} twice "
                        f"(overlapping keys in {sorted(gscales)})")
                out[g] = self.simulator._gscale(v)
        return out

    def step(self, state: SimState,
             gscales: Optional[Mapping[str, object]] = None,
             stim: Optional[Mapping[str, object]] = None):
        return self.backend.step(state, self._norm_gscales(gscales),
                                 stim=self._norm_stim(stim))

    def run(self, n_steps: int,
            gscales: Optional[Mapping[str, object]] = None,
            state: Optional[SimState] = None,
            record_raster: bool = False,
            stim: Optional[Mapping[str, object]] = None) -> RunResult:
        """Run n_steps from `state` (default: fresh init) through the
        compiled step loop (``Simulator.run_compiled``), whose runners are
        cached per (gscale keys, stim keys, record_raster, batch, device):
        gscale and stim *values* are copied into its buffers, so sweeping
        values reuses one capture.  stim: population -> [n_steps, n]
        currents injected one row per step.  A single-member state reports
        the JAX package's shapes (rates as scalars, counts [n], raster
        [n_steps, n]); a batched state keeps its leading axis."""
        if record_raster and any(p.name == "spikes"
                                 for p in self.simulator.probes):
            # two writers of one recordings key would be last-one-wins
            raise SpecError(
                "record_raster=True collides with the declared probe named "
                "'spikes': the raster and the probe would both be the "
                "'spikes' recording. Drop record_raster=True (the probe "
                "already records the raster) or rename the probe.")
        if state is None:
            state = self.init_state()
        with self._run_span(n_steps, state.batch):
            res = self.backend.run_compiled(state, n_steps,
                                              self._norm_gscales(gscales),
                                              record_raster=record_raster,
                                              stim=self._norm_stim(stim))
        return _squeeze(res) if state.batch == 1 else res

    @contextlib.contextmanager
    def _run_span(self, n_steps: int, batch: int):
        """The JAX package's ``run`` span (host time only), with the batch,
        and ``compile`` true when the call captured a graph."""
        counts = self.backend.graph_counts
        with trace.span("run", model=self.spec.name, n_steps=n_steps,
                        batch=batch, sharded=self.engine is not None) as args:
            before = counts["captures"]
            yield
            args["compile"] = counts["captures"] > before

    def sweep_gscale(self, group: Union[str, Sequence[str]],
                     values, n_steps: int,
                     state: Optional[SimState] = None) -> SweepResult:
        """Sweep a gscale multiplier over `values` for one synapse group (or
        several scaled together): the candidates ride the batch axis of one
        compiled run (cached per (names, batch, device): new values reuse its
        capture), and start from one key, so they share their random draws
        (as the JAX sweep shares its key)."""
        requested = [group] if isinstance(group, str) else list(group)
        names = [g for r in requested for g in self._expand_group(r)]
        values = torch.atleast_1d(torch.as_tensor(
            values, dtype=torch.float32)).to(self.device)
        if values.dim() != 1:
            raise ValueError(f"values must be 1-D, got {tuple(values.shape)}")
        batch = values.shape[0]
        if state is None:
            state = self.init_state(batch)
        elif state.batch == 1 and batch > 1:
            state = _expand_state(state, batch)
        elif state.batch != batch:
            raise ValueError(f"state has batch {state.batch}, values "
                             f"{batch}")
        with self._run_span(n_steps, batch):
            res = self.backend.run_compiled(state, n_steps,
                                            {n: values for n in names})
        return SweepResult(values=values, rates_hz=res.rates_hz,
                           finite=res.finite, spike_counts=res.spike_counts,
                           recordings=res.recordings)

    # -- streaming / serving ----------------------------------------------
    def init_stream_state(self, keys) -> SimState:
        """State of ``len(keys)`` stream slots on the model's device, one
        independent simulation each; keys [S, 2] threefry keys, slot s
        starting equal to ``init_state(1, keys[s])``."""
        return self.backend.init_stream_state(keys)

    def select_streams(self, state: SimState, idx, keys) -> SimState:
        """Re-pack the stream axis between chunks: new slot j continues
        old slot ``idx[j]`` bit for bit when ``idx[j] >= 0``, else starts
        fresh from ``keys[j]``; ``len(idx)`` sets the new slot count.  The
        gateway's slot reclamation and elastic resize, surviving streams
        untouched (``Simulator.select_streams``)."""
        return self.backend.select_streams(state, idx, keys)

    def serve_chunk(self, state: SimState, stim, steps_left, n_steps: int,
                    gscales: Optional[Mapping[str, object]] = None,
                    record_raster: bool = False):
        """Advance every stream slot by up to ``n_steps`` (one serving
        chunk), replaying the chunk's CUDA graph, captured once per
        (streams, n_steps, gscale keys, stim populations, record_raster).
        Returns (state, counts, raster, recordings), plus a per-slot
        HealthReport as a fifth element when built with ``monitor=``; see
        ``Simulator.serve_chunk`` for the masking contract.  SNNServer
        (``repro_torch.launch.snn_serve``) drives this."""
        if record_raster and any(p.name == "spikes"
                                 for p in self.simulator.probes):
            raise SpecError(
                "record_raster=True collides with the declared probe named "
                "'spikes'; drop record_raster=True or rename the probe")
        stim = {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v, np.float32)))
                for k, v in (stim or {}).items()}
        unknown = set(stim) - set(self.network.populations)
        if unknown:
            raise SpecError(
                f"unknown stim population(s) {sorted(unknown)}; declared "
                f"populations: {sorted(self.network.populations)}")
        counts = self.backend.graph_counts
        with trace.span("serve_chunk", model=self.spec.name,
                        n_steps=n_steps, streams=state.batch,
                        sharded=self.engine is not None) as args:
            before = counts["captures"]
            out = self.backend.serve_chunk(
                state, stim, steps_left, n_steps,
                self._norm_gscales(gscales), record_raster=record_raster)
            args["compile"] = counts["captures"] > before
        return out

    def serve(self, max_streams: int = 4, chunk: int = 50, **kwargs):
        """A streaming SNNServer over this model: ``max_streams`` slots on
        the stream (batch) axis, advanced ``chunk`` steps a ``serve_step``.
        See ``repro_torch.launch.snn_serve``."""
        from repro_torch.launch.snn_serve import SNNServer
        return SNNServer(self, max_streams=max_streams, chunk=chunk,
                         **kwargs)

    # -- custom updates and memory -----------------------------------------
    def custom_update(self, name: str,
                      state: Optional[SimState] = None) -> SimState:
        """Run one declared custom update on demand against ``state``
        (default: a fresh one); scheduled (``every=n``) updates also run
        inside ``run`` and ``sweep_gscale``.  The hook between runs, e.g.
        weight normalization between sweep rounds without rebuilding."""
        if name not in self.simulator.custom_updates:
            raise SpecError(
                f"unknown custom update {name!r}; declared updates: "
                f"{sorted(self.simulator.custom_updates)}")
        if state is None:
            state = self.init_state()
        return self.backend.custom_update(state, name)

    def memory_report(self, n_steps: Optional[int] = None,
                      max_streams: int = 1) -> List[dict]:
        """The JAX package's live-usage accounting: each synapse group's
        eq-(1)/(2) elements and dynamic state (delay ring included), each
        population's neuron state, each probe's ring (``n_steps`` sizes a
        strided one; spike rings at their packed int32 size), the custom
        updates, and the state of ``max_streams`` independent simulations
        (one per batch member or served stream)."""
        out = [dict(rep) for rep in self.network.memory_report()]
        stream_state = 0
        for rep in out:
            rep["kind"] = "synapse_group"
            stream_state += rep["state_elements"]
        for name, pop in self.network.populations.items():
            n_state = (len(pop.model.state) + 1
                       + (1 if pop.edge_spikes else 0)) * pop.n
            stream_state += n_state
            out.append({"name": name, "kind": "population",
                        "n": pop.n, "state_elements": n_state})
        for p in self.simulator.probes:
            packed = PR.is_packed(p)
            if packed:
                bps = BM.words_for(p.n) * 4
            elif p.reduce is not None:
                bps = 4
            else:
                bps = int(p.n) * 4
            entry = {"name": p.name, "kind": "probe", "target": p.target,
                     "var": p.var, "every": p.every,
                     "elements_per_sample": p.elements_per_sample(),
                     "is_packed": packed, "bytes_per_sample": bps}
            cap = None
            if n_steps is not None:
                cap = PR.capacity(p, n_steps)
            elif p.window is not None:
                cap = p.window
            if cap is not None:
                entry["buffer_elements"] = cap * p.elements_per_sample()
                entry["buffer_bytes"] = cap * bps
            out.append(entry)
        for name, cu in sorted(self.simulator.custom_updates.items()):
            out.append({"name": name, "kind": "custom_update",
                        "target": cu.target, "every": cu.every,
                        "n_reductions": len(cu.reduce)})
        out.append({"name": "streams", "kind": "serving",
                    "max_streams": max_streams,
                    "state_elements_per_stream": stream_state,
                    "stream_state_elements": stream_state * max_streams})
        return out

    def __repr__(self) -> str:
        pops = {p.name: p.n for p in self.spec.populations.values()}
        return (f"CompiledModel({self.spec.name!r}, populations={pops}, "
                f"synapse_groups={self.group_names}, dt={self.dt}, "
                f"device={str(self.device)!r})")
