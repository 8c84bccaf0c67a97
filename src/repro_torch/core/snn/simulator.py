"""The simulator: generates and runs the per-step update for a Network.

Counterpart of ``repro/core/snn/simulator.py`` (its host path).  Each step:

  1. synaptic propagation: last step's spikes -> post-synaptic currents
     (the hand-written ELL kernel, or a dense matmul, per group)
  2. neuron updates: a population of the built-in Izhikevich or Traub-Miles
     model advances through its fused kernel (``neurons.fused_kernel``:
     ``izhikevich_step`` / ``hh_step``), every other through the codegen'd
     model equations.  An Izhikevich population whose input is a
     ``neurons.NormalInput`` (or none) takes its groups' currents, its
     drive's key and its stim into the kernel, which sums them, hashes the
     drive's normals and updates the state in one launch (route
     ``"izhikevich_step+drive"``, or ``"izhikevich_step"`` with no drive):
     no zeros, adds or draw of its own
  3. spike extraction (threshold / reset, or rising-edge detection)

What differs from the JAX package:

  * State carries an explicit leading batch axis ``[B]`` where JAX vmaps.
    A gScale sweep runs its candidates as the batch.
  * ``lax.scan`` is a Python loop that never waits for the device: counts,
    the ``finite`` flag and rasters stay on the device until the run ends.
    ``run_compiled`` (and ``run_jit``, cached as JAX caches it) runs the
    same steps as CUDA graphs (``repro_torch.core.snn.graphs``).
  * Random numbers follow JAX's key schedule: each member's threefry key
    (``SimState.key`` [B, 2], ``repro_torch.random``) is split every step
    into the next key and an (input, rand) pair per population, in
    declaration order, and each member draws its own ``[n]`` from its
    subkeys, as ``vmap`` over keys does.  A sweep's members start from one
    key, as the JAX sweep shares its key across candidates, so the same
    seed gives the JAX package's draws.
  * ``t`` (ms, float32 [B]) and the delay rings' cursors ([B] int32) live
    on the device, one a member, as in the JAX state under ``vmap``: no
    step reads a value on the host.  ``run``, ``run_compiled`` and a sweep
    keep every member's equal; a served stream has its own.  An input
    function or model code that reads ``t`` gets it as [B, 1] (a synapse
    matrix's code as [B, 1, 1]), which broadcasts against its operands.

External stimuli (``stim``): ``step``/``run`` accept per-population injected
currents, added to Isyn after the population's input_fn, consuming no
random draws.

NaN containment (paper §2): every step folds whether each member's new
state is finite into a carried per-batch-member ``finite`` flag.  A fused
kernel writes that for its population in its own epilogue (its plain
version on the CPU folds ``isfinite`` over the same outputs); codegen'd
populations fold ``isfinite`` over their state here.

Observation and intervention (``repro_torch.core.snn.probes``,
``custom_updates``, ``repro_torch.obs.health``), as in the JAX package:
probes sample the state after each step into rings on the device;
scheduled custom updates run at the end of ``step`` when the advanced
global step count ``round(t/dt)`` is a multiple of their ``every`` (the
trigger is a device tensor, so a CUDA graph replays it), masked by it and
folding their writes into ``finite``; the health monitor accumulates
spike totals, rate EMAs and the first non-finite step.  A run reads ``t``
once, before its first step, when it has probes.  With no probe, update
or monitor, ``step`` and ``run`` launch only what they launched before.

Streaming / serving (``init_stream_state``, ``select_streams``,
``serve_chunk``), as in the JAX package: the batch axis is the stream
axis, each slot an independent simulation with its own state, key, ``t``
and ring cursors.  ``serve_chunk`` advances every slot up to ``n_steps``
with per-slot ``steps_left`` masking: a lane at or past its budget is
restored leaf by leaf (``torch.where``), so idle and finished slots are
exact no-ops.  It runs through ``graphs.ServedChunk`` (a CUDA graph on the
card, the same chunk eagerly on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch._device import resolve_device
from repro_torch.core import codegen
from repro_torch.core.snn import bitmask as BM
from repro_torch.core.snn import custom_updates as CU
from repro_torch.core.snn import graphs, neurons
from repro_torch.core.snn import probes as PR
from repro_torch.core.snn.network import Network, Population
from repro_torch.core.snn.probes import Recordings
from repro_torch.core.snn.synapses import SynapseState
from repro_torch.kernels import hh_step as _hh
from repro_torch.kernels import izhikevich_step as _iz
from repro_torch.kernels import ops as kops
from repro_torch.obs import health as HE

__all__ = ["Simulator", "SimState", "RunResult"]


@dataclasses.dataclass
class SimState:
    neurons: Dict[str, Dict[str, torch.Tensor]]   # pop -> var -> [B, n]
    spikes: Dict[str, torch.Tensor]       # last step's spikes, bool [B, n]
    prev_above: Dict[str, torch.Tensor]   # for edge-spike populations
    syn: Dict[str, SynapseState]          # per synapse group
    t: torch.Tensor                       # ms, float32 [B] on the device
    key: torch.Tensor                     # threefry keys, int32 [B, 2]
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
    recordings: Optional[Recordings] = None  # probe name -> [B, cap, ...]
    health: Optional[HE.HealthReport] = None  # when built with a monitor


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


def _fusable_input(fn) -> bool:
    """Whether a population's input function is one a fused kernel draws
    itself (a ``neurons.NormalInput``), or there is none."""
    return fn is None or isinstance(fn, neurons.NormalInput)


def _all_slots(x: torch.Tensor) -> torch.Tensor:
    """Whether a per-synapse bool tensor is all True over its slots:
    [B, n_pre, K] -> [B] ([n_pre, K], shared by every member, -> 0-dim)."""
    return x.flatten(-2).all(dim=-1)


class Simulator:
    # torch.cuda.graph's capture_error_mode for the compiled chunks
    capture_mode = "global"

    def __init__(self, net: Network, dt: float = 0.5, seed: int = 0,
                 device=None, probes=(), custom_updates=(), monitor=None):
        self.net = net
        self.dt = float(dt)
        self.seed = seed
        self.device = resolve_device(device)
        # the opt-in health monitor (None / enabled=False: the step loop
        # never mentions it)
        if monitor is not None and monitor.enabled:
            monitor.validate(net.populations)
            self.monitor = monitor
        else:
            self.monitor = None
        self._pop_sizes = {name: pop.n
                           for name, pop in net.populations.items()}
        # the neuron axis a step's tensors carry, by population (a sharded
        # engine's is its rank's shard)
        self._width = dict(self._pop_sizes)
        self._groups = {g.name: g for g in net.synapses}
        # probes and custom updates (ModelSpec passes them resolved)
        self.probes = tuple(probes)
        self.custom_updates = {cu.name: cu for cu in custom_updates}
        self._scheduled = [cu for cu in custom_updates
                           if cu.every is not None]
        # the invalid ELL slots of every group whose g or per-synapse vars
        # may be rewritten: the NaN folds of custom updates and the
        # monitor skip them (isfinite(x) | invalid, one pass fewer than
        # masking x first)
        cu_groups = {cu.target for cu in custom_updates
                     if cu.kind == "group"}
        self._invalid = {g.name: ~g.ell.valid for g in net.synapses
                         if g.plastic or g.name in cu_groups}
        # the "post" mean's denominators, once per group
        self._degree = {
            cu.target: CU.post_degree(self._groups[cu.target].ell)
            for cu in custom_updates if cu.kind == "group"
            and any(op == "mean" and axis == "post"
                    for op, _, axis in cu.reduce.values())}
        # population -> "izhikevich_step" | "izhikevich_step+drive" |
        # "hh_step" | "codegen"
        self.routes: Dict[str, str] = {}
        self._updates = {}
        for name, pop in net.populations.items():
            fused = self._fused_update(pop)
            self.routes[name] = fused[0] if fused else "codegen"
            self._updates[name] = (fused[1] if fused
                                   else codegen.compile_sim(pop.model))
        self._group_names = {g.name for g in net.synapses}
        # dt as codegen reads it (a CPU scalar) and as t advances by it
        self._dt_cpu = torch.tensor(self.dt, dtype=torch.float32)
        self._dt_dev = self._dt_cpu.to(self.device)
        # the compiled step loop: chunked runners by configuration, run_jit's
        # functions by (n_steps, record_raster), and what they have done
        self._compiled: Dict[tuple, object] = {}
        self._run_jit_cache: Dict[tuple, Callable] = {}
        self.graph_counts = {"captures": 0, "replays": 0}

    def _fused_update(self, pop: Population
                      ) -> Optional[Tuple[str, Callable]]:
        """(kernel name, update) when a fused kernel computes ``pop``'s
        update, else None.  The update has codegen's signature and calls the
        kernel's wrapper through its module, where a test can swap it.  It
        is marked ``clears_finite``: the kernel writes the NaN guard's flag
        (``ext["finite"]``, cleared in place), so no isfinite fold follows.

        Izhikevich parameters are made [n] float32 tensors here, once.  The
        Izhikevich update is marked ``takes_currents``: while its
        population's input function is a ``neurons.NormalInput`` or None
        (read every step), ``step`` hands it the groups' currents
        (``ext["currents"]``), the drive's scale and input key
        (``ext["drive_scale"]``, ``ext["k_in"]``) and its stim
        (``ext["stim"]``), and the kernel sums them and draws the drive on
        the lanes ``_drive_window`` gives; any other input function gets
        ``step``'s summed ``ext["Isyn"]``.  A Traub-Miles
        population with a per-neuron parameter is not the kernel's
        function (its parameters are scalars) and stays on codegen."""
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
            first, n_real = self._drive_window(pop.name)

            def izhikevich(state, params, ext):
                if "currents" not in ext:
                    v, u, spiked = _iz.izhikevich_step(
                        state["V"], state["U"], ext["Isyn"], a, b, c, d, dt,
                        finite=ext["finite"])
                    return {"V": v, "U": u}, spiked
                currents = ext["currents"]
                if len(currents) > _iz.MAX_CURRENTS:
                    # the first ones pre-summed, in order (from +0.0 in
                    # the kernel, the sum rounds as the zeros' chain does)
                    k = len(currents) - _iz.MAX_CURRENTS + 1
                    head = currents[0]
                    for cur in currents[1:k]:
                        head = head + cur
                    currents = [head, *currents[k:]]
                scale = ext["drive_scale"]
                drive = (None if scale is None
                         else (ext["k_in"], scale, first, n_real))
                v, u, spiked = _iz.izhikevich_step(
                    state["V"], state["U"], None, a, b, c, d, dt,
                    finite=ext["finite"], currents=currents, drive=drive,
                    stim=ext["stim"])
                return {"V": v, "U": u}, spiked

            izhikevich.clears_finite = True
            izhikevich.takes_currents = True
            return (kernel + "+drive"
                    if isinstance(pop.input_fn, neurons.NormalInput)
                    else kernel), izhikevich
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

    def _drive_window(self, name: str) -> Tuple[int, int]:
        """(first, n_real): the lanes of population ``name`` that a step's
        drive draws (all of them here; a sharded engine's rank, its
        own)."""
        return 0, self._pop_sizes[name]

    def _local_lanes(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """A full-size [..., n] draw as a step's tensors carry it (whole
        here; a sharded engine's rank takes its lanes)."""
        return full

    def _takes_currents(self) -> set:
        """The populations whose update sums its groups' currents and its
        drive and stim itself: a ``takes_currents`` update whose
        population's input is a ``NormalInput`` or none."""
        return {name for name, up in self._updates.items()
                if getattr(up, "takes_currents", False)
                and _fusable_input(self.net.populations[name].input_fn)}

    def _neuron_ext(self, name: str, pop: Population, isyn, currents,
                    k_in: torch.Tensor, t_col: torch.Tensor, stim) -> dict:
        """A population's ``ext`` for its update: its currents, input key
        and stim where it takes them, else ``Isyn``, the sum ``step``
        builds op by op (its groups' currents, plus its input function's
        draw, plus its stim)."""
        ext = {"dt": self._dt_cpu, "t": t_col}
        if name in currents:
            fn = pop.input_fn
            ext.update(currents=currents[name], k_in=k_in,
                       drive_scale=None if fn is None else fn.scale,
                       stim=stim.get(name))
            return ext
        cur = isyn[name]
        if pop.input_fn is not None:
            cur = cur + self._local_lanes(pop.input_fn(k_in, t_col, pop.n),
                                          name)
        if name in stim:
            cur = cur + stim[name]
        ext["Isyn"] = cur
        return ext

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
                   key: Optional[torch.Tensor] = None) -> SimState:
        """Fresh state for ``batch`` independent copies of the network.
        ``key``: a threefry key [2] for every member (default
        ``PRNGKey(seed)``, as a JAX sweep shares one key) or one per member
        [batch, 2]."""
        if not isinstance(batch, int) or batch < 1:
            raise ValueError(f"batch must be a positive int, got {batch!r}")
        dev = self.device
        if key is None:
            key = _random.PRNGKey(self.seed)
        key = torch.as_tensor(key).to(device=dev, dtype=torch.int32)
        if tuple(key.shape) not in ((2,), (batch, 2)):
            raise ValueError(f"key must be [2] or [batch={batch}, 2], got "
                             f"{tuple(key.shape)}")
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
                        prev_above=prev_above, syn=syn,
                        t=torch.zeros(batch, dtype=torch.float32,
                                      device=dev),
                        key=key.expand(batch, 2).clone(),
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
        t = state.t
        t_col = t[:, None]
        # JAX's schedule: key, *subkeys = split(key, 1 + 2P); then
        # (k_in, k_rand) per population in declaration order
        keys = _random.split(state.key, 1 + 2 * len(net.populations))

        # 1. synaptic propagation (last step's spikes) ------------------
        # (a population whose kernel sums its currents gets them as they
        # are; every other one's Isyn is summed here)
        currents = {name: [] for name in self._takes_currents()}
        isyn = {name: torch.zeros((batch, pop.n), dtype=torch.float32,
                                  device=self.device)
                for name, pop in net.populations.items()
                if name not in currents}
        new_syn = dict(state.syn)
        for g in net.synapses:
            v_post = state.neurons[g.post].get("V")
            s_new, cur = g.step(state.syn[g.name], state.spikes[g.pre],
                                gs.get(g.name, 1.0), dt, v_post=v_post,
                                post_spikes=state.spikes[g.post], t=t)
            new_syn[g.name] = s_new
            if g.post in currents:
                currents[g.post].append(cur)
            else:
                isyn[g.post] = isyn[g.post] + cur

        # 2+3. neuron updates: fused kernel or generated code -----------
        new_neurons, new_spikes, new_prev = {}, {}, dict(state.prev_above)
        finite = state.finite
        for i, (name, pop) in enumerate(net.populations.items()):
            k_in, k_rand = keys[:, 1 + 2 * i], keys[:, 2 + 2 * i]
            ext = self._neuron_ext(name, pop, isyn, currents, k_in, t_col,
                                   stim)
            if pop.model.needs_rand:
                ext["rand"] = _random.uniform(k_rand, pop.n)
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
            syn=new_syn, t=t + self._dt_dev, key=keys[:, 0], finite=finite)
        if self._scheduled:
            new_state = self._run_scheduled_updates(new_state)
        return new_state, new_spikes

    # -- custom updates (on demand and scheduled) -------------------------
    def _run_scheduled_updates(self, state: SimState) -> SimState:
        """Apply every ``every=n`` custom update whose step is due: the
        trigger is each member's global step count round(t/dt) of the
        advanced t, a [B] device tensor (no host read), as the JAX package
        keys it."""
        elapsed = self._stream_steps(state)
        for cu in self._scheduled:
            trig = torch.remainder(elapsed, cu.every) == 0
            state = self._apply_custom(state, cu, trig)
        return state

    def _apply_custom(self, state: SimState, cu,
                      trig: Optional[torch.Tensor]) -> SimState:
        """Apply one custom update, masked by ``trig`` (a bool [B] tensor,
        one a member; None applies it).  The written arrays (their valid
        slots, for a group) fold into the NaN guard's flag where it fires:
        an update that divides by a zero reduction trips ``finite`` as an
        over-scaled conductance does."""
        batch = state.batch
        # t and the trigger as the target's tensors broadcast them: [B, 1]
        # against [B, n], [B, 1, 1] against a group's [B, n_pre, K]
        lead = (batch, 1, 1) if cu.kind == "group" else (batch, 1)
        ext = {"dt": self._dt_cpu, "t": state.t.reshape(lead)}
        trig_b = None if trig is None else trig.reshape(lead)

        def fold(finite, ok):
            return finite & (ok if trig is None else ok | ~trig)

        def pick(new, old):
            return new if trig is None else torch.where(trig_b, new, old)

        if cu.kind == "group":
            grp = self._groups[cu.target]
            st = state.syn[cu.target]
            g_arr = st.g if st.g is not None else grp.ell.g
            cu_vars = {"g": g_arr, **st.syn}
            red = {rname: CU.group_reduce_host(
                       op, cu_vars[var], grp.ell, axis, cu.denom_all, batch,
                       self._degree.get(cu.target))
                   for rname, (op, var, axis) in cu.reduce.items()}
            new = cu.fn(cu_vars, cu.params, red, ext)
            valid = grp.ell.valid
            finite = state.finite
            for name in sorted(cu.writes):
                ok = torch.isfinite(new[name]) | self._invalid[cu.target]
                finite = fold(finite, _all_slots(ok))

            def sel(name, old):
                if name not in cu.writes:
                    return old
                return pick(torch.where(valid, new[name], old), old)

            new_syn = dict(state.syn)
            new_syn[cu.target] = SynapseState(
                psm=st.psm, wu_pre=st.wu_pre, wu_post=st.wu_post,
                g=(sel("g", g_arr) if st.g is not None else None),
                syn={k: sel(k, v) for k, v in st.syn.items()},
                dendritic=st.dendritic, cursor=st.cursor)
            return dataclasses.replace(state, syn=new_syn, finite=finite)
        # a population
        cu_vars = dict(state.neurons[cu.target])
        red = {rname: CU.pop_reduce(op, cu_vars[var], cu.denom_all)
               for rname, (op, var, _axis) in cu.reduce.items()}
        new = cu.fn(cu_vars, cu.params, red, ext)
        finite = state.finite
        written = {}
        for name in sorted(cu.writes):
            old = cu_vars[name]
            nv = torch.broadcast_to(new[name], old.shape)
            finite = fold(finite, torch.isfinite(nv).all(dim=-1))
            written[name] = pick(nv, old)
        new_neurons = dict(state.neurons)
        new_neurons[cu.target] = {k: written.get(k, v)
                                  for k, v in cu_vars.items()}
        return dataclasses.replace(state, neurons=new_neurons,
                                   finite=finite)

    def custom_update(self, state: SimState, name: str) -> SimState:
        """Run one declared custom update on demand (any ``every``)."""
        if name not in self.custom_updates:
            raise ValueError(
                f"unknown custom update {name!r}; declared updates: "
                f"{sorted(self.custom_updates)}")
        return self._apply_custom(state, self.custom_updates[name], None)

    # -- probes --------------------------------------------------------------
    def _step_count(self, state: SimState) -> int:
        """The global step count round(t/dt), read on the host (once a
        run): probes sample on it, as the device trigger of scheduled
        updates does.  A run samples one schedule, so every member must be
        at the same step (a served stream samples on its own:
        ``serve_chunk``)."""
        steps = self._stream_steps(state).cpu()
        if bool((steps != steps[0]).any()):
            raise ValueError(
                f"a run's probes sample one schedule, but its members are "
                f"at steps {steps.tolist()}; serve_chunk samples each "
                "stream on its own")
        return int(steps[0])

    def _stream_steps(self, state: SimState) -> torch.Tensor:
        """Each member's global step count round(t/dt), int32 [B] on the
        device (no host read)."""
        return torch.round(state.t / self._dt_dev).to(torch.int32)

    def _ring_row_shape(self, p, batch: int) -> Tuple[int, ...]:
        """One row of probe ``p``'s ring or staging buffer [B, ...]."""
        return PR.ring_row_shape(p, batch)

    def _probe_init(self, n_steps: int, batch: int):
        """(rings, capacities): a ring [cap, B, ...] per probe on the
        device, int32 bitmask words for unreduced spike probes."""
        rings, caps = {}, {}
        for p in self.probes:
            cap = PR.capacity(p, n_steps)
            caps[p.name] = cap
            rings[p.name] = torch.zeros(
                (cap,) + self._ring_row_shape(p, batch),
                dtype=PR.ring_dtype(p), device=self.device)
        return rings, caps

    def _sample_into(self, p, ring: torch.Tensor, slot: int,
                     state: SimState, spikes) -> None:
        """Write probe ``p``'s sample of a post-step state at row ``slot``
        of ``ring`` (packed spike rows by the bitmask kernel)."""
        if PR.is_packed(p):
            kops.pack_spikes_into(spikes[p.target].contiguous(), ring, slot)
        else:
            PR.write_sample(ring, slot,
                            PR.host_sample(p, self._groups, state, spikes))

    def _probe_write(self, rings, caps, start: int, i: int,
                     state: SimState, spikes) -> None:
        """Step i's samples (the probes whose schedule is due)."""
        for p in self.probes:
            active, slot = PR.sample_slot(p, start, PR.probe_base(p, start),
                                          i, caps[p.name])
            if active:
                self._sample_into(p, rings[p.name], slot, state, spikes)

    def _probe_finalize(self, rings, caps, start: int,
                        n_steps: int, batch: int) -> Recordings:
        """Recordings [B, cap, ...] in chronological order (packed rings
        unpacked to bool) and their valid-row counts [B]."""
        data, counts = {}, {}
        for p in self.probes:
            d, c = PR.finalize(rings[p.name], start, n_steps, p,
                               caps[p.name])
            data[p.name] = self._finish_samples(p, d.transpose(0, 1))
            counts[p.name] = torch.full((batch,), c, dtype=torch.int32,
                                        device=self.device)
        return Recordings(data=data, counts=counts)

    def _finish_samples(self, p, samples: torch.Tensor) -> torch.Tensor:
        """A probe's samples [B, cap, ...] as a fresh recording (packed
        rows unpacked to bool)."""
        if PR.is_packed(p):
            return BM.unpack_rows(samples, p.n)
        return samples.clone(memory_format=torch.contiguous_format)

    # -- the health monitor ----------------------------------------------------
    def _health_init(self, batch: int) -> HE.HealthState:
        return HE.init_state(self._pop_sizes, batch, self.device)

    def _health_step(self, hs: HE.HealthState, state: SimState,
                     spikes, gate: Optional[torch.Tensor] = None
                     ) -> HE.HealthState:
        """One step of the monitor: per-population spike counts [B] and
        its own guard (V of every population, state-resident g over valid
        slots), as the JAX monitor reads them; ``gate`` [B] (serving's
        lane mask) leaves a masked member's accumulator as it was."""
        counts = {p: spikes[p].sum(dim=-1, dtype=torch.int32)
                  for p in self._pop_sizes}
        ok = torch.ones(state.batch, dtype=torch.bool, device=self.device)
        for name in self.net.populations:
            v = state.neurons[name].get("V")
            if v is not None:
                ok = ok & torch.isfinite(v).all(dim=-1)
        for g in self.net.synapses:
            sg = state.syn[g.name].g
            if sg is not None:
                ok = ok & _all_slots(torch.isfinite(sg)
                                     | self._invalid[g.name])
        return HE.accumulate(self.monitor, hs, counts, ok, self.dt,
                             self._pop_sizes, gate=gate)

    def _health_report(self, hs: HE.HealthState) -> HE.HealthReport:
        return HE.finalize(self.monitor, hs, self.dt, self._pop_sizes)

    # ------------------------------------------------------------------
    def _stim_tensors(self, stim, n_steps: int) -> Dict[str, torch.Tensor]:
        self._validate_stim(stim)
        stim = {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                for k, v in (stim or {}).items()}
        for k, v in stim.items():
            if v.shape[0] != n_steps:
                raise ValueError(f"stim[{k!r}] has {v.shape[0]} rows for "
                                 f"{n_steps} steps")
        return stim

    def _result(self, state: SimState, counts: Dict[str, torch.Tensor],
                n_steps: int, raster, recordings=None,
                health=None) -> RunResult:
        t_sec = n_steps * self.dt * 1e-3
        rates = {k: v.to(torch.float32).mean(dim=-1) / t_sec
                 for k, v in counts.items()}
        return RunResult(state=state, spike_counts=counts, rates_hz=rates,
                         finite=state.finite, raster=raster,
                         recordings=recordings, health=health)

    def _local_step(self, state: SimState, gscales, stim):
        """The step the run loops and the compiled chunks take (a sharded
        engine's works on its rank's lanes)."""
        return self.step(state, gscales, stim=stim)

    def _run_result(self, state: SimState, counts, n_steps: int, raster,
                    rec, hs) -> RunResult:
        """A run's RunResult from what its loop or chunks left."""
        health = None if hs is None else self._health_report(hs)
        return self._result(state, counts, n_steps, raster, rec, health)

    def run(
        self, state: SimState, n_steps: int,
        gscales: Optional[Mapping[str, object]] = None,
        record_raster: bool = False,
        stim: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> RunResult:
        """Advance n_steps eagerly, one step at a time (as the JAX
        package's unjitted ``Simulator.run``); returns spike statistics
        (and rasters [n_steps, B, n] when ``record_raster``), the probes'
        recordings and, when monitored, the health report.  stim:
        population name -> [n_steps, n] (or [n_steps, B, n]) currents, one
        row per step."""
        self._validate_gscales(gscales)
        stim = self._stim_tensors(stim, n_steps)
        batch = state.batch
        counts = {name: torch.zeros((batch, w), dtype=torch.int32,
                                    device=self.device)
                  for name, w in self._width.items()}
        raster = {name: [] for name in counts} if record_raster else None
        start = self._step_count(state) if self.probes else 0
        rings, caps = self._probe_init(n_steps, batch)
        hs = self._health_init(batch) if self.monitor is not None else None
        for i in range(n_steps):
            state, spk = self._local_step(
                state, gscales, {k: v[i] for k, v in stim.items()})
            for k in counts:
                counts[k] += spk[k]
                if raster is not None:
                    raster[k].append(spk[k])
            if self.probes:
                self._probe_write(rings, caps, start, i, state, spk)
            if hs is not None:
                hs = self._health_step(hs, state, spk)
        if raster is not None:
            raster = {k: (torch.stack(v) if v else torch.zeros(
                (0,) + tuple(counts[k].shape), dtype=torch.bool,
                device=self.device)) for k, v in raster.items()}
        rec = self._probe_finalize(rings, caps, start, n_steps, batch)
        return self._run_result(state, counts, n_steps, raster, rec, hs)

    # -- the compiled step loop -------------------------------------------
    def run_compiled(
        self, state: SimState, n_steps: int,
        gscales: Optional[Mapping[str, object]] = None,
        record_raster: bool = False,
        stim: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> RunResult:
        """``run``'s result, computed by the chunked runner of this
        configuration: on a CUDA device each chunk is a CUDA graph captured
        once and replayed (a capture or replay that fails raises), on the
        CPU the same chunks run eagerly.  Runners are cached by (batch,
        gscale keys, stim keys, record_raster, device), as the JAX package
        caches its executables, so new gScale or stim values reuse them.
        The caller's state is copied in and the result is a fresh state."""
        self._validate_gscales(gscales)
        gscales = dict(gscales or {})
        stim = self._stim_tensors(stim, n_steps)
        key = (state.batch, tuple(sorted(gscales)), tuple(sorted(stim)),
               bool(record_raster), str(self.device))
        runner = self._compiled.get(key)
        if runner is None:
            runner = self._compiled[key] = graphs.ChunkedRun(
                self, state.batch, key[1], key[2], key[3])
        state, counts, raster, rec, hs = runner.run(state, n_steps, gscales,
                                                    stim)
        return self._run_result(state, counts, n_steps, raster, rec, hs)

    def run_jit(self, n_steps: int, record_raster: bool = False) -> Callable:
        """``fn(state, gscales=None) -> RunResult`` running n_steps through
        ``run_compiled``, cached per (n_steps, record_raster) as the JAX
        package caches ``run_jit``: gScale values are buffer contents, so
        sweeping values reuses one set of graphs."""
        cache_key = (int(n_steps), bool(record_raster))
        fn = self._run_jit_cache.get(cache_key)
        if fn is None:
            def fn(state: SimState,
                   gscales: Optional[Mapping[str, object]] = None
                   ) -> RunResult:
                return self.run_compiled(state, cache_key[0], gscales,
                                         record_raster=cache_key[1])
            self._run_jit_cache[cache_key] = fn
        return fn

    # -- streaming / serving ------------------------------------------------
    def init_stream_state(self, keys) -> SimState:
        """State of ``len(keys)`` stream slots, one independent simulation
        each: keys [S, 2] threefry keys (one a slot); slot s starts equal to
        ``init_state(1, keys[s])``."""
        keys = torch.as_tensor(keys)
        if keys.dim() != 2 or keys.shape[1] != 2:
            raise ValueError(f"keys must be [S, 2], got {tuple(keys.shape)}")
        return self.init_state(int(keys.shape[0]), keys)

    def select_streams(self, state: SimState, idx, keys) -> SimState:
        """Re-pack the stream axis between chunks (slot reclamation and
        elastic resize): new slot j continues old slot ``idx[j]`` bit for
        bit where ``idx[j] >= 0``, else starts fresh from ``keys[j]``;
        ``len(idx)`` sets the new slot count, so one call grows, shrinks,
        compacts or re-keys the table.  Survivors are gathers and selects,
        no arithmetic: eviction and resizing never touch the streams that
        stay."""
        idx = torch.as_tensor(np.asarray(idx, np.int64))
        if idx.dim() != 1 or idx.numel() == 0:
            raise ValueError(f"idx must be a non-empty 1-D index, got shape "
                             f"{tuple(idx.shape)}")
        if int(idx.max()) >= state.batch:
            raise ValueError(f"idx {idx.tolist()} names a slot past the "
                             f"state's {state.batch}")
        keys = torch.as_tensor(keys)
        if keys.shape[0] != idx.shape[0]:
            raise ValueError(f"keys has {keys.shape[0]} rows for "
                             f"{idx.shape[0]} slots")
        fresh = self.init_stream_state(keys)
        take = idx.clamp(min=0).to(self.device)
        keep = (idx >= 0).to(self.device)

        def mix(old, fr):
            return torch.where(graphs._lanes(keep, fr),
                               old.index_select(0, take), fr)
        return graphs._tree_map(mix, state, fresh)

    def serve_chunk(
        self, state: SimState, stim: Mapping[str, object],
        steps_left, n_steps: int,
        gscales: Optional[Mapping[str, object]] = None,
        record_raster: bool = False,
    ):
        """Advance every stream slot by up to ``n_steps`` (one serving
        chunk).

        state: SimState with the stream axis as its batch
        (``init_stream_state``); stim: population -> [S, n_steps, n]
        currents (a host tensor in pinned memory is copied without waiting
        for the host); steps_left: [S] int -- slot s advances
        min(steps_left[s], n_steps) steps, a lane at or past its budget is
        restored leaf by leaf, so idle and finished slots are exact no-ops
        (key, t, cursors, rings, traces, g, monitor).

        Returns (state, counts, raster, recordings), and the per-slot
        HealthReport as a fifth element when monitored: counts population
        -> [S, n] spikes of the chunk (masked steps add nothing); raster
        population -> [S, n_steps, n] (masked steps all False) when
        ``record_raster``, else None; recordings with a leading stream axis
        and per-slot sample counts (each slot samples on its own global
        step count, so stitched chunks equal the offline run's).  The
        chunk runs through a ``graphs.ServedChunk`` cached per (S,
        n_steps, gscale keys, stim keys, record_raster, device): a CUDA
        graph on the card, captured once."""
        self._validate_gscales(gscales)
        self._validate_stim(stim)
        gscales = dict(gscales or {})
        if not isinstance(n_steps, int) or n_steps < 1:
            raise ValueError(f"n_steps must be a positive int, got "
                             f"{n_steps!r}")
        S = state.batch
        stim = {k: torch.as_tensor(v, dtype=torch.float32)
                for k, v in (stim or {}).items()}
        for k, v in stim.items():
            want = (S, n_steps, self._pop_sizes[k])
            if tuple(v.shape) != want:
                raise ValueError(f"stim[{k!r}] has shape {tuple(v.shape)}, "
                                 f"expected {want}")
        left = torch.as_tensor(np.asarray(steps_left), dtype=torch.int32)
        if tuple(left.shape) != (S,):
            raise ValueError(f"steps_left must be [{S}], got "
                             f"{tuple(left.shape)}")
        stim = self._serve_stim(stim)
        key = ("serve", S, n_steps, tuple(sorted(gscales)),
               tuple(sorted(stim)), bool(record_raster), str(self.device))
        runner = self._compiled.get(key)
        if runner is None:
            runner = self._compiled[key] = graphs.ServedChunk(
                self, S, n_steps, key[3], key[4], key[5])
        state, counts, raster, rec, hs = self._served_result(
            *runner.run(state, stim, left, gscales))
        self._last_served = runner
        if hs is None:
            return state, counts, raster, rec
        return state, counts, raster, rec, self._health_report(hs)

    def _serve_stim(self, stim: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """A chunk's stim [S, n_steps, n] as the chunk's buffers take it."""
        return stim

    def _served_result(self, state, counts, raster, rec, hs):
        """A served chunk's outputs as ``serve_chunk`` returns them."""
        return state, counts, raster, rec, hs

    def last_serve_device_ms(self) -> Optional[Tuple[float, float]]:
        """(stim copy ms, chunk ms) of the last ``serve_chunk`` on the card
        by CUDA events, once the caller has waited for it (None on the CPU
        or before the first chunk)."""
        runner = getattr(self, "_last_served", None)
        return None if runner is None else runner.device_ms()
