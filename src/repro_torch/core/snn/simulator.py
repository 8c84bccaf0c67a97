"""The simulator: generates and runs the per-step update for a Network.

Counterpart of ``repro/core/snn/simulator.py`` (its host path).  Each step:

  1. synaptic propagation: last step's spikes -> post-synaptic currents
     (the hand-written ELL kernel, or a dense matmul, per group)
  2. neuron updates: a population of the built-in Izhikevich or Traub-Miles
     model advances through its fused kernel (``neurons.fused_kernel``:
     ``izhikevich_step`` / ``hh_step``), every other through the codegen'd
     model equations
  3. spike extraction (threshold / reset, or rising-edge detection)

What differs from the JAX package:

  * State carries an explicit leading batch axis ``[B]`` where JAX vmaps.
    A gScale sweep runs its candidates as the batch.
  * ``lax.scan`` is a Python loop that never waits for the device: counts,
    the ``finite`` flag and rasters stay on the device until the run ends.
  * Random numbers come from a ``torch.Generator`` on the model's device,
    carried in the state.  Each population's ``input_fn`` and ``rand``
    draws are made once per step as ``[n]`` and shared by every batch
    member, as the JAX sweep shares its key across candidates.  The values
    differ from ``jax.random``'s; the distributions are the same.

External stimuli (``stim``): ``step``/``run`` accept per-population injected
currents, added to Isyn after the population's input_fn, consuming no
random draws.

NaN containment (paper §2): every step folds whether each member's new
state is finite into a carried per-batch-member ``finite`` flag.  A fused
kernel writes that for its population in its own epilogue (its plain
version on the CPU folds ``isfinite`` over the same outputs); codegen'd
populations fold ``isfinite`` over their state here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import codegen
from repro_torch.core.snn import neurons
from repro_torch.core.snn.network import Network, Population
from repro_torch.core.snn.synapses import SynapseState
from repro_torch.kernels import hh_step as _hh
from repro_torch.kernels import izhikevich_step as _iz

__all__ = ["Simulator", "SimState", "RunResult"]


@dataclasses.dataclass
class SimState:
    neurons: Dict[str, Dict[str, torch.Tensor]]   # pop -> var -> [B, n]
    spikes: Dict[str, torch.Tensor]       # last step's spikes, bool [B, n]
    prev_above: Dict[str, torch.Tensor]   # for edge-spike populations
    syn: Dict[str, SynapseState]          # per synapse group
    t: np.float32                         # ms, accumulated in float32
    generator: torch.Generator            # on the model's device
    finite: torch.Tensor                  # bool [B]: no NaN/Inf so far

    @property
    def batch(self) -> int:
        return self.finite.shape[0]


@dataclasses.dataclass
class RunResult:
    state: SimState
    spike_counts: Dict[str, torch.Tensor]   # per-neuron totals [B, n]
    rates_hz: Dict[str, torch.Tensor]       # population mean rate [B]
    finite: torch.Tensor                    # [B]
    raster: Optional[Dict[str, torch.Tensor]] = None   # [steps, B, n] bool


def fold_finite(finite: torch.Tensor, arrays) -> torch.Tensor:
    """The NaN guard of a codegen'd population: ``finite`` [B] and, for
    each array [B, n], whether all of its member's row is finite."""
    for arr in arrays:
        finite = finite & torch.isfinite(arr).all(dim=-1)
    return finite


def own_flag(finite: torch.Tensor) -> torch.Tensor:
    """A copy of the carried NaN-guard flag for the fused kernels to clear
    in place (they must not write into the previous step's state)."""
    return finite.clone()


def _scalar(v) -> Optional[float]:
    """A neuron parameter as a float, or None for a per-neuron array."""
    if isinstance(v, torch.Tensor):
        return float(v) if v.dim() == 0 else None
    arr = np.asarray(v)
    return float(arr) if arr.ndim == 0 else None


class Simulator:
    def __init__(self, net: Network, dt: float = 0.5, seed: int = 0,
                 device=None):
        self.net = net
        self.dt = float(dt)
        self.seed = seed
        self.device = resolve_device(device)
        # population -> "izhikevich_step" | "hh_step" | "codegen"
        self.routes: Dict[str, str] = {}
        self._updates = {}
        for name, pop in net.populations.items():
            fused = self._fused_update(pop)
            self.routes[name] = fused[0] if fused else "codegen"
            self._updates[name] = (fused[1] if fused
                                   else codegen.compile_sim(pop.model))
        self._group_names = {g.name for g in net.synapses}

    def _fused_update(self, pop: Population
                      ) -> Optional[Tuple[str, Callable]]:
        """(kernel name, update) when a fused kernel computes ``pop``'s
        update, else None.  The update has codegen's signature and calls the
        kernel's wrapper through its module, where a test can swap it.  It
        is marked ``clears_finite``: the kernel writes the NaN guard's flag
        (``ext["finite"]``, cleared in place), so no isfinite fold follows.

        Izhikevich parameters are made [n] float32 tensors here, once.  A
        Traub-Miles population with a per-neuron parameter is not the
        kernel's function (its parameters are scalars) and stays on
        codegen."""
        found = neurons.fused_kernel(pop.model)
        if found is None:
            return None
        kernel, static = found
        dt = self.dt
        if kernel == "izhikevich_step":
            a, b, c, d = (torch.as_tensor(pop.params[k], dtype=torch.float32,
                                          device=self.device)
                          .broadcast_to((pop.n,)).contiguous()
                          for k in "abcd")

            def izhikevich(state, params, ext):
                v, u, spiked = _iz.izhikevich_step(
                    state["V"], state["U"], ext["Isyn"], a, b, c, d, dt,
                    finite=ext["finite"])
                return {"V": v, "U": u}, spiked

            izhikevich.clears_finite = True
            return kernel, izhikevich
        scalars = {k: _scalar(v) for k, v in pop.params.items()}
        if any(v is None for v in scalars.values()):
            return None
        substeps = static["substeps"]

        def hh(state, params, ext):
            v, m, h, n, above = _hh.hh_step(
                state["V"], state["m"], state["h"], state["n"], ext["Isyn"],
                dt, substeps, **scalars, finite=ext["finite"])
            return {"V": v, "m": m, "h": h, "n": n}, above

        hh.clears_finite = True
        return kernel, hh

    def _validate_gscales(self, gscales: Optional[Mapping[str, object]]
                          ) -> None:
        """Reject gscale keys that match no synapse group (a misspelled key
        would otherwise be silently ignored)."""
        if not gscales:
            return
        unknown = set(gscales) - self._group_names
        if unknown:
            raise ValueError(
                f"unknown gscale key(s) {sorted(unknown)}; valid synapse "
                f"group names: {sorted(self._group_names)}")

    def _validate_stim(self, stim: Optional[Mapping[str, object]]) -> None:
        """Stim keys must name populations (same silent-typo hazard)."""
        if not stim:
            return
        unknown = set(stim) - set(self.net.populations)
        if unknown:
            raise ValueError(
                f"unknown stim population(s) {sorted(unknown)}; declared "
                f"populations: {sorted(self.net.populations)}")

    def _gscale(self, v) -> torch.Tensor:
        """A gscale as float32: a 0-dim CPU tensor for one scalar (a scalar
        operand costs no device copy), else a [B] tensor on the device."""
        t = torch.as_tensor(v, dtype=torch.float32)
        if t.dim() == 0:
            return t.cpu()
        if t.dim() != 1:
            raise ValueError(f"gscale must be a scalar or [B], got shape "
                             f"{tuple(t.shape)}")
        return t.to(self.device)

    # ------------------------------------------------------------------
    def init_state(self, batch: int = 1,
                   generator: Optional[torch.Generator] = None) -> SimState:
        """Fresh state for ``batch`` independent copies of the network.
        ``generator`` defaults to one on the model's device seeded with the
        model's seed."""
        if not isinstance(batch, int) or batch < 1:
            raise ValueError(f"batch must be a positive int, got {batch!r}")
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.seed)
        dev = self.device
        neurons, spikes, prev_above = {}, {}, {}
        for name, pop in self.net.populations.items():
            neurons[name] = {
                k: torch.full((batch, pop.n), v, dtype=torch.float32,
                              device=dev)
                for k, v in pop.model.state.items()
            }
            spikes[name] = torch.zeros((batch, pop.n), dtype=torch.bool,
                                       device=dev)
            if pop.edge_spikes:
                prev_above[name] = torch.zeros((batch, pop.n),
                                               dtype=torch.bool, device=dev)
        syn = {g.name: g.init_state(batch) for g in self.net.synapses}
        return SimState(neurons=neurons, spikes=spikes,
                        prev_above=prev_above, syn=syn, t=np.float32(0.0),
                        generator=generator,
                        finite=torch.ones(batch, dtype=torch.bool,
                                          device=dev))

    # ------------------------------------------------------------------
    def step(
        self, state: SimState,
        gscales: Optional[Mapping[str, object]] = None,
        stim: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
        """One dt step.  gscales: synapse-group name -> scalar or [B]
        multiplier; stim: population name -> [n] or [B, n] external current
        injected this step."""
        net, dt = self.net, self.dt
        self._validate_gscales(gscales)
        self._validate_stim(stim)
        gs = {k: self._gscale(v) for k, v in (gscales or {}).items()}
        stim = stim or {}
        batch = state.batch
        t = torch.tensor(state.t, dtype=torch.float32)

        # 1. synaptic propagation (last step's spikes) ------------------
        isyn = {name: torch.zeros((batch, pop.n), dtype=torch.float32,
                                  device=self.device)
                for name, pop in net.populations.items()}
        new_syn = dict(state.syn)
        for g in net.synapses:
            v_post = state.neurons[g.post].get("V")
            s_new, cur = g.step(state.syn[g.name], state.spikes[g.pre],
                                gs.get(g.name, 1.0), dt, v_post=v_post,
                                post_spikes=state.spikes[g.post], t=t)
            new_syn[g.name] = s_new
            isyn[g.post] = isyn[g.post] + cur

        # 2+3. neuron updates: fused kernel or generated code -----------
        new_neurons, new_spikes, new_prev = {}, {}, dict(state.prev_above)
        finite = state.finite
        gen = state.generator
        dt_t = torch.tensor(dt, dtype=torch.float32)
        for name, pop in net.populations.items():
            cur = isyn[name]
            if pop.input_fn is not None:
                cur = cur + pop.input_fn(gen, float(state.t), pop.n)
            if name in stim:
                cur = cur + stim[name]
            ext = {"Isyn": cur, "dt": dt_t, "t": t}
            if pop.model.needs_rand:
                ext["rand"] = torch.rand(pop.n, generator=gen,
                                         device=self.device)
            update = self._updates[name]
            flagged = getattr(update, "clears_finite", False)
            if flagged:
                if finite is state.finite:
                    finite = own_flag(finite)
                ext["finite"] = finite
            ns, above = update(state.neurons[name], pop.params, ext)
            if pop.edge_spikes:
                spk = above & ~state.prev_above[name]
                new_prev[name] = above
            else:
                spk = above
            new_neurons[name] = ns
            new_spikes[name] = spk
            if not flagged:
                finite = fold_finite(finite, ns.values())

        new_state = SimState(
            neurons=new_neurons, spikes=new_spikes, prev_above=new_prev,
            syn=new_syn, t=np.float32(state.t + np.float32(dt)),
            generator=gen, finite=finite)
        return new_state, new_spikes

    # ------------------------------------------------------------------
    def run(
        self, state: SimState, n_steps: int,
        gscales: Optional[Mapping[str, object]] = None,
        record_raster: bool = False,
        stim: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> RunResult:
        """Advance n_steps; returns spike statistics (and rasters
        [n_steps, B, n] when ``record_raster``).  stim: population name ->
        [n_steps, n] (or [n_steps, B, n]) currents, one row per step."""
        self._validate_gscales(gscales)
        self._validate_stim(stim)
        stim = {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                for k, v in (stim or {}).items()}
        for k, v in stim.items():
            if v.shape[0] != n_steps:
                raise ValueError(f"stim[{k!r}] has {v.shape[0]} rows for "
                                 f"{n_steps} steps")
        counts = {name: torch.zeros((state.batch, pop.n), dtype=torch.int32,
                                    device=self.device)
                  for name, pop in self.net.populations.items()}
        raster = {name: [] for name in counts} if record_raster else None
        for i in range(n_steps):
            state, spk = self.step(state, gscales,
                                   stim={k: v[i] for k, v in stim.items()})
            for k in counts:
                counts[k] += spk[k]
                if raster is not None:
                    raster[k].append(spk[k])
        t_sec = n_steps * self.dt * 1e-3
        rates = {k: v.to(torch.float32).mean(dim=-1) / t_sec
                 for k, v in counts.items()}
        if raster is not None:
            raster = {k: (torch.stack(v) if v else torch.zeros(
                (0,) + tuple(counts[k].shape), dtype=torch.bool,
                device=self.device)) for k, v in raster.items()}
        return RunResult(state=state, spike_counts=counts, rates_hz=rates,
                         finite=state.finite, raster=raster)

