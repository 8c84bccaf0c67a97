"""Network description: populations of neurons + synapse groups.

Counterpart of ``repro/core/snn/network.py``: the built IR the Simulator
runs.  The user-facing front-end is ModelSpec (``repro_torch.core.snn.spec``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional

import torch

from repro_torch.core.codegen import NeuronModel
from repro_torch.core.snn.synapses import SynapseGroup

__all__ = ["Population", "Network", "InputFn"]

# external input: (keys [B, 2], t, n) -> current [B, n] (or [n]) on the keys'
# device; keys are the step's threefry subkeys (repro_torch.random), one a
# batch member, t the time in ms (a float32 0-dim tensor on the device)
InputFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


@dataclasses.dataclass
class Population:
    name: str
    model: NeuronModel
    n: int
    params: Mapping[str, object]            # scalars or per-neuron tensors
    input_fn: Optional[InputFn] = None      # external current source
    # emit spikes only on upward threshold crossings (needed for models
    # without a reset, e.g. HH, where V stays > 0 for several steps)
    edge_spikes: bool = False


@dataclasses.dataclass
class Network:
    name: str = "net"
    populations: Dict[str, Population] = dataclasses.field(
        default_factory=dict)
    synapses: List[SynapseGroup] = dataclasses.field(default_factory=list)

    def add_population(
        self, name: str, model: NeuronModel, n: int,
        params: Optional[Mapping[str, object]] = None,
        input_fn: Optional[InputFn] = None,
        edge_spikes: Optional[bool] = None,
    ) -> Population:
        if name in self.populations:
            raise ValueError(f"duplicate population {name!r}")
        if edge_spikes is None:
            edge_spikes = bool(model.threshold_code) and not model.reset_code
        merged = dict(model.params)
        merged.update(params or {})
        pop = Population(name=name, model=model, n=n, params=merged,
                         input_fn=input_fn, edge_spikes=edge_spikes)
        self.populations[name] = pop
        return pop

    def add_synapse(self, group: SynapseGroup) -> SynapseGroup:
        # the Simulator keys per-group state by name; a collision would make
        # two groups silently share (and clobber) one state slot
        if any(g.name == group.name for g in self.synapses):
            raise ValueError(f"duplicate synapse group name {group.name!r}")
        if group.pre not in self.populations:
            raise ValueError(f"unknown pre population {group.pre!r}")
        if group.post not in self.populations:
            raise ValueError(f"unknown post population {group.post!r}")
        if group.ell.n_pre != self.populations[group.pre].n:
            raise ValueError(
                f"{group.name}: n_pre {group.ell.n_pre} != population "
                f"{self.populations[group.pre].n}")
        if group.ell.n_post != self.populations[group.post].n:
            raise ValueError(
                f"{group.name}: n_post {group.ell.n_post} != population "
                f"{self.populations[group.post].n}")
        self.synapses.append(group)
        return group

    def memory_report(self) -> List[dict]:
        """Each synapse group's ``memory_report``."""
        return [g.memory_report() for g in self.synapses]
