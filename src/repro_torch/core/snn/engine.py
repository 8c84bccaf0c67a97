"""ShardedEngine: the SNN step partitioned over ranks along the neuron axis.

Counterpart of ``repro/core/snn/engine.py``, SPMD in PyTorch's idiom: each
rank is one process holding one device (``repro_torch.launch.mesh``), and
every rank calls the same entry points and gets the same global results.
Rank d owns neuron block d of *every* population (populations padded to a
multiple of the world size D, ``launch.sharding.neuron_pad``) and, for
every synapse group, the slots whose POST neuron lives in that block
(``sparse.device_init.partition_ell_by_post``, or ``device_init_local``,
which draws only the rank's rows).  A step mirrors the JAX package's
``_local_step`` line for line:

  1. spike exchange: each pre population's [B, S] spikes are packed into
     GeNN's 32x bitmask words by the hand-written kernel
     (``kernels.spike_bitmask``), the words all-gathered ([D, B, W]) and
     unpacked to the full [B, n] vector (``bitmask.unpack_segments``):
     the only per-step communication;
  2. synaptic propagation into the rank's post shard through the group's
     compiled snippets on its block (``SynapseGroup.step(conn=...)``: the
     ELL kernel, or the delay scatter and ring fold into the rank's
     [B, slots, S] ring); STDP pre traces stay sharded on the PRE axis and
     are all-gathered only when a learn rule reads them;
  3. neuron updates on the shard, by the same fused kernels as the
     ``Simulator`` (``izhikevich_step``, ``hh_step``) or codegen.

The key schedule is replicated (every rank splits the same keys),
``input_fn`` / ``rand`` draws are full size, then sliced to the shard, and
a ``NormalInput`` drive is hashed by the fused Izhikevich kernel on the
rank's own lanes alone (the same counters), so the key consumes the same
stream at any D: the engine equals the
single-device ``Simulator`` bit for bit (counts, rasters, every state
tensor, ``finite``).  Padded lanes carry edge-replicated parameters, get
no input and never spike (masked); they are left out of every output and
of codegen's NaN fold (a fused kernel folds its padded lanes, which must
stay finite).  ``t``, keys and ring cursors are the same on every rank;
the NaN guard's flag is each rank's until a run ends, then min-reduced.

The engine is a ``Simulator`` over its rank's lanes: ``run`` (eager),
``run_compiled`` (``graphs.ChunkedRun``: CUDA graphs of 32 steps on the
card with the NCCL all-gather inside the capture, eager chunks under
gloo), ``init_stream_state`` / ``select_streams`` / ``serve_chunk``
(``graphs.ServedChunk``) and ``custom_update`` are the Simulator's, with
the step, the probes' samples, the custom updates' reductions and the
monitor's counts taken on the shard; what a run returns is gathered (and
cropped to the real neurons) at its end, the state stays sharded
(``gather_state`` / ``shard_state`` convert it).

Reductions: per-post ones need no communication (a rank owns every slot
into its post shard); per-row and whole-matrix ones combine the ranks'
partial sums (``psum``, so float sums may differ from one device's in the
last bits) or extrema (``pmax``/``pmin``, exact); population reductions
and reduced vector probes all-gather the vector and reduce it as the
Simulator does (bit for bit).  The monitor's counts are all-reduced each
step (exact integers); its guard is each rank's, merged at the end
(``health.combine_across_devices``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as TF

from repro_torch import random as _random
from repro_torch.core.snn import bitmask as BM
from repro_torch.core.snn import custom_updates as CU
from repro_torch.core.snn import probes as PR
from repro_torch.core.snn.network import Network
from repro_torch.core.snn.simulator import (RunResult, SimState, Simulator,
                                            fold_finite, own_flag)
from repro_torch.core.snn.synapses import LocalConnectivity, SynapseState
from repro_torch.kernels import ops as kops
from repro_torch.launch.sharding import neuron_pad, pad_neuron_axis
from repro_torch.obs import health as HE
from repro_torch.obs import trace
from repro_torch.sparse import device_init as DI
from repro_torch.sparse import formats as F

__all__ = ["ShardedEngine"]


def _concat_shards(x: torch.Tensor) -> torch.Tensor:
    """[D, ..., S] (every rank's shard, rank-major as an all-gather stacks
    them) -> [..., D * S]."""
    return x.movedim(0, -2).reshape(tuple(x.shape[1:-1]) + (-1,))


class ShardedEngine(Simulator):
    """A built Network partitioned over a 1-D mesh of ranks (module
    docstring).  ``local_init``: {group name -> ``DI.LocalInitPlan``} for
    the groups whose blocks ``device_init_local`` draws (each rank its own
    rows); the others are partitioned from the group's ELL."""

    # the chunks' captures hold NCCL collectives: the process group's
    # watchdog thread may query events while this thread captures
    capture_mode = "thread_local"

    def __init__(self, net: Network, mesh, dt: float = 0.5, seed: int = 0,
                 probes=(), custom_updates=(), monitor=None,
                 local_init=None):
        self.mesh = mesh
        D = self.n_shards = int(mesh.world_size)
        d = self.rank = int(mesh.rank)
        dev = mesh.device
        self._npad = {name: neuron_pad(pop.n, D)
                      for name, pop in net.populations.items()}
        self._shard = {name: npad // D for name, npad in self._npad.items()}
        # rank d's lanes of each population: real lanes [lo, hi) and the
        # padded lanes past them
        self._lanes: Dict[str, Tuple[int, int, int]] = {}
        self._lane_valid: Dict[str, Optional[torch.Tensor]] = {}
        for name, pop in net.populations.items():
            S = self._shard[name]
            lo = min(d * S, pop.n)
            hi = min((d + 1) * S, pop.n)
            self._lanes[name] = (lo, hi, S - (hi - lo))
            self._lane_valid[name] = (
                None if hi - lo == S else
                torch.arange(S, device=dev) < (hi - lo))
        # per-neuron parameters, edge-padded and sliced to the shard
        # (scalars stay as they are)
        self._lpops = {}
        for name, pop in net.populations.items():
            params = {}
            for k, v in pop.params.items():
                arr = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
                if arr.dim() and arr.shape[0] == pop.n:
                    full = pad_neuron_axis(arr.to(dev), self._npad[name],
                                           axis=0)
                    S = self._shard[name]
                    params[k] = full[d * S:(d + 1) * S].contiguous()
                else:
                    params[k] = v
            self._lpops[name] = dataclasses.replace(
                pop, n=self._shard[name], params=params)
        super().__init__(net, dt=dt, seed=seed, device=dev, probes=probes,
                         custom_updates=custom_updates, monitor=monitor)
        self._width = dict(self._shard)
        self._pre_pops = sorted({g.pre for g in net.synapses})

        # --- each group's block: this rank's post shard -----------------
        self._conn: Dict[str, LocalConnectivity] = {}
        self._k_local: Dict[str, int] = {}
        for g in net.synapses:
            S_post = self._shard[g.post]
            if g.representation == "dense" and not g.plastic:
                w = TF.pad(g.dense, (0, self._npad[g.post] - g.ell.n_post))
                blk = w[:, d * S_post:(d + 1) * S_post].contiguous()
                # an ELL stand-in keeps the post-side shapes the block's
                stand_in = F.ELLSynapses(
                    g=torch.zeros((g.ell.n_pre, 1), device=dev),
                    post_ind=torch.zeros((g.ell.n_pre, 1), dtype=torch.int32,
                                         device=dev),
                    valid=torch.zeros((g.ell.n_pre, 1), dtype=torch.bool,
                                      device=dev),
                    n_post=S_post)
                self._conn[g.name] = LocalConnectivity(stand_in, dense=blk)
                continue
            plan = (local_init or {}).get(g.name)
            if plan is not None:
                with trace.span("device_init_local", group=g.name,
                                rows=g.ell.n_pre, devices=D):
                    gg, post, valid, delay, shard_size, k_loc = \
                        DI.device_init_local(
                            plan.connect, plan.key, plan.n_pre,
                            plan.n_post_total, mesh, weight=plan.weight,
                            delay=plan.delay, post_window=plan.post_window)
            else:
                with trace.span("partition_ell_by_post", group=g.name,
                                rows=g.ell.n_pre, k=g.ell.max_conn,
                                devices=D):
                    gg, post, valid, delay, shard_size, k_loc = \
                        DI.partition_ell_by_post(g.ell, D)
                    gg, post, valid = gg[d], post[d], valid[d]
                    delay = None if delay is None else delay[d]
            if shard_size != S_post:
                raise RuntimeError(f"{g.name}: post shard {shard_size} != "
                                   f"the population's {S_post}")
            self._k_local[g.name] = k_loc
            self._conn[g.name] = LocalConnectivity(F.ELLSynapses(
                g=gg.to(dev).contiguous(), post_ind=post.to(dev).contiguous(),
                valid=valid.to(dev).contiguous(), n_post=S_post,
                delay=None if delay is None else delay.to(dev).contiguous()))
        # the Simulator's per-group tables, on the blocks
        self._invalid = {name: ~self._conn[name].ell.valid
                         for name in self._invalid}
        self._degree = {name: CU.post_degree(self._conn[name].ell)
                        for name in self._degree}
        self._delay_scalar = {
            g.name: torch.tensor(float(g.delay_steps), dtype=torch.float32,
                                 device=dev) for g in net.synapses}

    # -- the fused updates on the shard ------------------------------------
    def _fused_update(self, pop):
        return super()._fused_update(self._lpops[pop.name])

    def _drive_window(self, name: str) -> Tuple[int, int]:
        """This rank's real lanes of population ``name``: a fused drive
        hashes the normals of [lo, hi) only, and adds 0.0 past them."""
        lo, hi, _ = self._lanes[name]
        return lo, hi - lo

    # -- lanes and collectives ----------------------------------------------
    def _local_lanes(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """A full-size [..., n] tensor's lanes of this rank's shard
        [..., S] (zeros past the real lanes)."""
        lo, hi, pad = self._lanes[name]
        x = full[..., lo:hi]
        if pad:
            x = TF.pad(x, (0, pad))
        return x

    def _gather_lanes(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """Every rank's shard [..., S] of population ``name``, gathered
        and cropped to the real neurons [..., n] (the same on every
        rank)."""
        full = _concat_shards(self.mesh.all_gather(x, tiled=False))
        n = self.net.populations[name].n
        return full if full.shape[-1] == n else full[..., :n]

    def _exchange(self, spikes: torch.Tensor, name: str) -> torch.Tensor:
        """This step's spike exchange: the shard's [B, S] spikes packed,
        the words all-gathered [D, B, W] and unpacked to [B, n]."""
        words = BM.pack_spikes(spikes)
        gathered = self.mesh.all_gather(words, tiled=False)
        full = BM.unpack_segments(gathered, self._shard[name])
        n = self.net.populations[name].n
        if full.shape[-1] != n:
            full = full[..., :n].contiguous()
        return full

    # -- state -----------------------------------------------------------
    def init_state(self, batch: int = 1,
                   key: Optional[torch.Tensor] = None) -> SimState:
        """This rank's shard of ``Simulator.init_state(batch, key)``
        (padded lanes carry the init constants)."""
        if not isinstance(batch, int) or batch < 1:
            raise ValueError(f"batch must be a positive int, got {batch!r}")
        dev = self.device
        if key is None:
            key = _random.PRNGKey(self.seed)
        key = torch.as_tensor(key).to(device=dev, dtype=torch.int32)
        if tuple(key.shape) not in ((2,), (batch, 2)):
            raise ValueError(f"key must be [2] or [batch={batch}, 2], got "
                             f"{tuple(key.shape)}")

        def full(shape, v):
            return torch.full(shape, v, dtype=torch.float32, device=dev)

        neurons, spikes, prev = {}, {}, {}
        for name, pop in self.net.populations.items():
            S = self._shard[name]
            neurons[name] = {k: full((batch, S), v)
                             for k, v in pop.model.state.items()}
            spikes[name] = torch.zeros((batch, S), dtype=torch.bool,
                                       device=dev)
            if pop.edge_spikes:
                prev[name] = torch.zeros((batch, S), dtype=torch.bool,
                                         device=dev)
        syn = {}
        for g in self.net.synapses:
            Sp, Sq = self._shard[g.pre], self._shard[g.post]
            ell = self._conn[g.name].ell
            k = ell.max_conn
            n_pre = g.ell.n_pre
            ring = g.needs_ring
            syn[g.name] = SynapseState(
                psm={n: full((batch, Sq), v) for n, v in g.psm.state.items()},
                wu_pre={n: full((batch, Sp), v)
                        for n, v in g.wum.pre_state.items()},
                wu_post={n: full((batch, Sq), v)
                         for n, v in g.wum.post_state.items()},
                g=(ell.g.expand(batch, n_pre, k).clone() if g.plastic
                   else None),
                syn={n: full((batch, n_pre, k), v)
                     for n, v in g.wum.syn_state.items()},
                dendritic=(full((batch, g.ring_slots, Sq), 0.0) if ring
                           else None),
                cursor=(torch.zeros(batch, dtype=torch.int32, device=dev)
                        if ring else None))
        return SimState(neurons=neurons, spikes=spikes, prev_above=prev,
                        syn=syn,
                        t=torch.zeros(batch, dtype=torch.float32, device=dev),
                        key=key.expand(batch, 2).clone(),
                        finite=torch.ones(batch, dtype=torch.bool,
                                          device=dev))

    # -- the step ------------------------------------------------------------
    def _local_step(self, state: SimState, gscales, stim):
        """One dt step on this rank's lanes (stim: population -> [B, S]
        or [S] shard currents); returns (state, shard spikes [B, S])."""
        net, dt = self.net, self.dt
        self._validate_gscales(gscales)
        gs = {k: self._gscale(v) for k, v in (gscales or {}).items()}
        stim = stim or {}
        batch = state.batch
        t = state.t
        t_col = t[:, None]
        keys = _random.split(state.key, 1 + 2 * len(net.populations))

        # 0. spike exchange (the only per-step communication)
        full_spikes = {name: self._exchange(state.spikes[name], name)
                       for name in self._pre_pops}

        # 1. synaptic propagation into the local post shard
        currents = {name: [] for name in self._takes_currents()}
        isyn = {name: torch.zeros((batch, S), dtype=torch.float32,
                                  device=self.device)
                for name, S in self._shard.items() if name not in currents}
        new_syn = dict(state.syn)
        for g in net.synapses:
            st = state.syn[g.name]
            new_pre_local, pre_arg = None, None
            if g.wum.pre_state and g.wum.has_learning:
                # pre traces shard on the PRE axis: the elementwise pre step
                # runs on the shard, and the full traces are gathered only
                # when a learn rule reads them
                new_pre_local = st.wu_pre
                if g._wu.pre_step is not None:
                    new_pre_local = g._wu.pre_step(
                        st.wu_pre, g.wum.params,
                        {"dt": dt, "t": t_col,
                         "delay": self._delay_scalar[g.name],
                         "pre_spike": state.spikes[g.pre].to(torch.float32)})
                pre_arg = {}
                if g._wu.learn is not None:
                    pre_arg = {k: self._gather_lanes(v, g.pre)
                               for k, v in new_pre_local.items()}
            s_new, cur = g.step(
                st, full_spikes[g.pre], gs.get(g.name, 1.0), dt,
                v_post=state.neurons[g.post].get("V"),
                post_spikes=state.spikes[g.post], t=t,
                conn=self._conn[g.name], pre_traces=pre_arg)
            if new_pre_local is not None:
                s_new = dataclasses.replace(s_new, wu_pre=new_pre_local)
            new_syn[g.name] = s_new
            if g.post in currents:
                currents[g.post].append(cur)
            else:
                isyn[g.post] = isyn[g.post] + cur

        # 2+3. neuron updates on the shard: an input function's draw is
        # full size, then this rank's lanes, and a fused drive hashes the
        # rank's lanes alone (``_drive_window``): the key consumes the
        # same stream at any world size
        new_neurons, new_spikes, new_prev = {}, {}, dict(state.prev_above)
        finite = state.finite
        for i, (name, pop) in enumerate(net.populations.items()):
            k_in, k_rand = keys[:, 1 + 2 * i], keys[:, 2 + 2 * i]
            ext = self._neuron_ext(name, pop, isyn, currents, k_in, t_col,
                                   stim)
            if pop.model.needs_rand:
                ext["rand"] = self._local_lanes(
                    _random.uniform(k_rand, pop.n), name)
            update = self._updates[name]
            flagged = getattr(update, "clears_finite", False)
            if flagged:
                if finite is state.finite:
                    finite = own_flag(finite)
                ext["finite"] = finite
            ns, above = update(state.neurons[name], self._lpops[name].params,
                               ext)
            if pop.edge_spikes:
                spk = above & ~state.prev_above[name]
                new_prev[name] = above
            else:
                spk = above
            valid = self._lane_valid[name]
            if valid is not None:
                spk = spk & valid
            new_neurons[name] = ns
            new_spikes[name] = spk
            if not flagged:
                finite = fold_finite(finite, (
                    v if valid is None else torch.where(valid, v, 0.0)
                    for v in ns.values()))

        new_state = SimState(
            neurons=new_neurons, spikes=new_spikes, prev_above=new_prev,
            syn=new_syn, t=t + self._dt_dev, key=keys[:, 0], finite=finite)
        if self._scheduled:
            new_state = self._run_scheduled_updates(new_state)
        return new_state, new_spikes

    def step(self, state: SimState,
             gscales: Optional[Mapping[str, object]] = None,
             stim: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
        """One dt step of the sharded state; returns (the new sharded
        state, its finite flag merged over the ranks; the step's spikes
        [B, n], gathered).  stim: population -> [n] or [B, n] currents,
        full size."""
        self._validate_stim(stim)
        local = {k: self._local_lanes(
                    torch.as_tensor(v, dtype=torch.float32).to(self.device), k)
                 for k, v in (stim or {}).items()}
        st, spk = self._local_step(state, gscales, local)
        st = dataclasses.replace(st, finite=self.mesh.pmin(st.finite))
        return st, {k: self._gather_lanes(v, k) for k, v in spk.items()}

    # -- custom updates -------------------------------------------------------
    def _group_reduce(self, op: str, val: torch.Tensor,
                      ell: F.ELLSynapses, axis: str, denom_all: float,
                      batch: int, degree: Optional[torch.Tensor]
                      ) -> torch.Tensor:
        """One declared reduction of a group on this rank's block: "post"
        needs no communication (the rank owns every slot into its post
        shard); "pre" and "all" combine the ranks' partials."""
        if axis == "post":
            return CU.group_reduce_host(op, val, ell, "post", denom_all,
                                        batch, degree)
        vb = CU._as_batched(val, batch)
        if op in ("sum", "mean"):
            masked = torch.where(ell.valid, vb, 0.0)
            if axis == "pre":
                tot = self.mesh.psum(masked.sum(dim=-1))
                if op == "sum":
                    return tot[..., None]
                cnt = self.mesh.psum(
                    ell.valid.to(torch.float32).sum(dim=-1))
                return torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0),
                                   0.0)[..., None]
            tot = self.mesh.psum(masked.sum(dim=(-2, -1)))
            if op == "mean":
                tot = tot / denom_all
            return tot[:, None, None]
        masked = torch.where(ell.valid, vb, PR.reduce_neutral(op))
        comb = self.mesh.pmax if op == "max" else self.mesh.pmin
        if axis == "pre":
            part = (masked.amax(dim=-1) if op == "max"
                    else masked.amin(dim=-1))
            return comb(part)[..., None]
        part = (masked.amax(dim=(-2, -1)) if op == "max"
                else masked.amin(dim=(-2, -1)))
        return comb(part)[:, None, None]

    def _apply_custom(self, state: SimState, cu,
                      trig: Optional[torch.Tensor]) -> SimState:
        """``Simulator._apply_custom`` on this rank's shard (its NaN fold
        is the rank's, merged at a run's end)."""
        batch = state.batch
        lead = (batch, 1, 1) if cu.kind == "group" else (batch, 1)
        ext = {"dt": self._dt_cpu, "t": state.t.reshape(lead)}
        trig_b = None if trig is None else trig.reshape(lead)

        def fold(finite, ok):
            return finite & (ok if trig is None else ok | ~trig)

        def pick(new, old):
            return new if trig is None else torch.where(trig_b, new, old)

        if cu.kind == "group":
            ell = self._conn[cu.target].ell
            st = state.syn[cu.target]
            g_arr = st.g if st.g is not None else ell.g
            cu_vars = {"g": g_arr, **st.syn}
            red = {rname: self._group_reduce(
                       op, cu_vars[var], ell, axis, cu.denom_all, batch,
                       self._degree.get(cu.target))
                   for rname, (op, var, axis) in cu.reduce.items()}
            new = cu.fn(cu_vars, cu.params, red, ext)
            finite = state.finite
            for name in sorted(cu.writes):
                ok = torch.isfinite(new[name]) | self._invalid[cu.target]
                finite = fold(finite, ok.flatten(-2).all(dim=-1))

            def sel(name, old):
                if name not in cu.writes:
                    return old
                return pick(torch.where(ell.valid, new[name], old), old)

            new_syn = dict(state.syn)
            new_syn[cu.target] = SynapseState(
                psm=st.psm, wu_pre=st.wu_pre, wu_post=st.wu_post,
                g=(sel("g", g_arr) if st.g is not None else None),
                syn={k: sel(k, v) for k, v in st.syn.items()},
                dendritic=st.dendritic, cursor=st.cursor)
            return dataclasses.replace(state, syn=new_syn, finite=finite)
        # a population: reductions over the gathered vector (bit for bit
        # the Simulator's), the update on the shard with its parameters
        cu_vars = dict(state.neurons[cu.target])
        red = {rname: CU.pop_reduce(
                   op, self._gather_lanes(cu_vars[var], cu.target),
                   cu.denom_all)
               for rname, (op, var, _axis) in cu.reduce.items()}
        params = dict(cu.params)
        params.update(self._lpops[cu.target].params)
        new = cu.fn(cu_vars, params, red, ext)
        valid = self._lane_valid[cu.target]
        finite = state.finite
        written = {}
        for name in sorted(cu.writes):
            old = cu_vars[name]
            nv = torch.broadcast_to(new[name], old.shape)
            okv = torch.isfinite(nv)
            if valid is not None:
                okv = okv | ~valid
            finite = fold(finite, okv.all(dim=-1))
            written[name] = pick(nv, old)
        new_neurons = dict(state.neurons)
        new_neurons[cu.target] = {k: written.get(k, v)
                                  for k, v in cu_vars.items()}
        return dataclasses.replace(state, neurons=new_neurons,
                                   finite=finite)

    def custom_update(self, state: SimState, name: str) -> SimState:
        """Run one declared custom update on demand against a sharded
        state (the NaN guard's flag merged over the ranks)."""
        st = super().custom_update(state, name)
        return dataclasses.replace(st, finite=self.mesh.pmin(st.finite))

    # -- probes ---------------------------------------------------------------
    def _probe_pop(self, p) -> str:
        """The population whose lanes an unreduced probe's samples are."""
        if p.varkind == "wu_pre":
            return self._groups[p.target].pre
        if p.kind == "population":
            return p.target
        return self._groups[p.target].post

    def _ring_row_shape(self, p, batch: int) -> Tuple[int, ...]:
        if p.reduce is not None:
            return (batch,)
        w = self._shard[self._probe_pop(p)]
        return (batch, BM.words_for(w)) if PR.is_packed(p) else (batch, w)

    def _probe_value(self, p, state: SimState, spikes) -> torch.Tensor:
        """A probe's sample: the shard's rows, or the reduced value (over
        the gathered vector; a matrix's partials combined)."""
        if p.varkind in ("g", "syn"):
            st = state.syn[p.target]
            val = st.g if p.varkind == "g" else st.syn[p.var]
            valid = self._conn[p.target].ell.valid
            op = p.reduce
            if op in ("sum", "mean"):
                tot = self.mesh.psum(torch.where(
                    valid, val.to(torch.float32), 0.0).sum(dim=(-2, -1)))
                return tot / p.denom if op == "mean" else tot
            part = PR.masked_reduce(val, valid, op, p.denom)
            return (self.mesh.pmax if op == "max" else self.mesh.pmin)(part)
        val = PR.host_sample(dataclasses.replace(p, reduce=None),
                             self._groups, state, spikes)
        if p.reduce is None:
            return val
        full = self._gather_lanes(val, self._probe_pop(p))
        return PR.vector_reduce(full, p.reduce, p.denom)

    def _sample_into(self, p, ring: torch.Tensor, slot: int,
                     state: SimState, spikes) -> None:
        if PR.is_packed(p):
            kops.pack_spikes_into(spikes[p.target].contiguous(), ring, slot)
        else:
            PR.write_sample(ring, slot, self._probe_value(p, state, spikes))

    def _finish_samples(self, p, samples: torch.Tensor) -> torch.Tensor:
        """A probe's shard samples [B, cap, ...] gathered over the ranks
        and cropped (packed rows unpacked to the shard's lanes first)."""
        if p.reduce is not None:
            return samples.clone(memory_format=torch.contiguous_format)
        if PR.is_packed(p):
            samples = BM.unpack_rows(samples,
                                     self._shard[self._probe_pop(p)])
        return self._gather_lanes(samples, self._probe_pop(p)).contiguous()

    # -- the monitor ----------------------------------------------------------
    def _health_step(self, hs: HE.HealthState, state: SimState, spikes,
                     gate: Optional[torch.Tensor] = None) -> HE.HealthState:
        """The monitor's step: the populations' spike counts all-reduced
        in one collective (exact integers), the guard on this rank's real
        lanes and valid slots."""
        names = list(self._pop_sizes)
        local = torch.stack([spikes[p].sum(dim=-1, dtype=torch.int32)
                             for p in names])
        counts = dict(zip(names, self.mesh.psum(local).unbind(0)))
        ok = torch.ones(state.batch, dtype=torch.bool, device=self.device)
        for name in self.net.populations:
            v = state.neurons[name].get("V")
            if v is not None:
                fin = torch.isfinite(v)
                valid = self._lane_valid[name]
                if valid is not None:
                    fin = fin | ~valid
                ok = ok & fin.all(dim=-1)
        for g in self.net.synapses:
            sg = state.syn[g.name].g
            if sg is not None:
                ok = ok & (torch.isfinite(sg)
                           | self._invalid[g.name]).flatten(-2).all(dim=-1)
        return HE.accumulate(self.monitor, hs, counts, ok, self.dt,
                             self._pop_sizes, gate=gate)

    # -- results: gathered and merged at the end ------------------------------
    def _stim_tensors(self, stim, n_steps: int) -> Dict[str, torch.Tensor]:
        """A run's stim rows [n_steps, (B,) n] as this rank's lanes."""
        return {k: self._local_lanes(v, k)
                for k, v in super()._stim_tensors(stim, n_steps).items()}

    def _merge(self, state: SimState, counts, raster, hs):
        state = dataclasses.replace(state,
                                    finite=self.mesh.pmin(state.finite))
        counts = {k: self._gather_lanes(v, k) for k, v in counts.items()}
        if raster is not None:
            raster = {k: self._gather_lanes(v, k) for k, v in raster.items()}
        if hs is not None:
            hs = HE.combine_across_devices(hs, self.mesh)
        return state, counts, raster, hs

    def _run_result(self, state: SimState, counts, n_steps: int, raster,
                    rec, hs) -> RunResult:
        state, counts, raster, hs = self._merge(state, counts, raster, hs)
        return super()._run_result(state, counts, n_steps, raster, rec, hs)

    def _serve_stim(self, stim):
        return {k: self._local_lanes(v, k) for k, v in stim.items()}

    def _served_result(self, state, counts, raster, rec, hs):
        state, counts, raster, hs = self._merge(state, counts, raster, hs)
        return state, counts, raster, rec, hs

    # -- state conversion -----------------------------------------------------
    def _slot_source(self, g) -> torch.Tensor:
        """[n_pre, k_local] int64: the column of the group's full ELL each
        slot of this rank's block holds (0 where the slot is invalid)."""
        cache = self.__dict__.setdefault("_slot_src", {})
        src = cache.get(g.name)
        if src is None:
            ell = g.ell
            cols = torch.arange(ell.max_conn, dtype=torch.int32,
                                device=ell.device).expand(ell.n_pre, -1)
            shard_size = self._shard[g.post]
            parts = DI._partition_rows(ell.g, ell.post_ind, ell.valid, cols,
                                       self.n_shards, shard_size,
                                       self._k_local[g.name])
            src = cache[g.name] = parts[3][self.rank].to(self.device).long()
        return src

    def gather_state(self, state: SimState) -> SimState:
        """The full state (the single-device ``Simulator``'s layout) of a
        sharded one, on every rank.  Per-synapse tensors (plastic g, the
        weight-update model's synapse variables) are rebuilt on the
        group's valid slots (invalid slots: 0 for g, the variable's
        initial value otherwise)."""
        neurons = {n: {k: self._gather_lanes(v, n) for k, v in vs.items()}
                   for n, vs in state.neurons.items()}
        spikes = {n: self._gather_lanes(v, n)
                  for n, v in state.spikes.items()}
        prev = {n: self._gather_lanes(v, n)
                for n, v in state.prev_above.items()}
        syn = {}
        for g in self.net.synapses:
            st = state.syn[g.name]

            def matrix(x, fill):
                if x is None:
                    return None
                blocks = self.mesh.all_gather(x, tiled=False)
                srcs = self.mesh.all_gather(self._slot_source(g),
                                            tiled=False)
                valids = self.mesh.all_gather(self._conn[g.name].ell.valid,
                                              tiled=False)
                out = torch.full((x.shape[0], g.ell.n_pre, g.ell.max_conn),
                                 fill, dtype=x.dtype, device=x.device)
                for blk, src, valid in zip(blocks, srcs, valids):
                    rows, cols = torch.nonzero(valid, as_tuple=True)
                    out[:, rows, src[rows, cols]] = blk[:, rows, cols]
                return out

            syn[g.name] = SynapseState(
                psm={k: self._gather_lanes(v, g.post)
                     for k, v in st.psm.items()},
                wu_pre={k: self._gather_lanes(v, g.pre)
                        for k, v in st.wu_pre.items()},
                wu_post={k: self._gather_lanes(v, g.post)
                         for k, v in st.wu_post.items()},
                g=matrix(st.g, 0.0),
                syn={k: matrix(v, g.wum.syn_state[k])
                     for k, v in st.syn.items()},
                dendritic=(None if st.dendritic is None
                           else self._gather_lanes(st.dendritic, g.post)),
                cursor=st.cursor)
        return SimState(neurons=neurons, spikes=spikes, prev_above=prev,
                        syn=syn, t=state.t, key=state.key,
                        finite=self.mesh.pmin(state.finite))

    def shard_state(self, state: SimState) -> SimState:
        """This rank's shard of a full state (the ``Simulator``'s layout,
        e.g. one carried over from the JAX package by ``convert``): neuron
        variables edge-padded as the parameters are, every other padded
        lane zero; per-synapse tensors taken from the block's source
        slots."""
        dev = self.device

        def lanes(x, name, edge=False):
            x = torch.as_tensor(x).to(dev)
            if edge:
                x = pad_neuron_axis(x, self._npad[name], axis=-1)
                S = self._shard[name]
                return x[..., self.rank * S:(self.rank + 1) * S].contiguous()
            return self._local_lanes(x, name).contiguous()

        neurons = {n: {k: lanes(v, n, edge=True) for k, v in vs.items()}
                   for n, vs in state.neurons.items()}
        spikes = {n: lanes(v, n) for n, v in state.spikes.items()}
        prev = {n: lanes(v, n) for n, v in state.prev_above.items()}
        syn = {}
        for g in self.net.synapses:
            st = state.syn[g.name]
            valid = self._conn[g.name].ell.valid

            def matrix(x):
                if x is None:
                    return None
                x = torch.as_tensor(x).to(dev)
                src = self._slot_source(g).expand(x.shape[0], -1, -1)
                return torch.where(valid, torch.gather(x, -1, src),
                                   torch.zeros((), dtype=x.dtype,
                                               device=dev)).contiguous()

            syn[g.name] = SynapseState(
                psm={k: lanes(v, g.post) for k, v in st.psm.items()},
                wu_pre={k: lanes(v, g.pre) for k, v in st.wu_pre.items()},
                wu_post={k: lanes(v, g.post) for k, v in st.wu_post.items()},
                g=matrix(st.g),
                syn={k: matrix(v) for k, v in st.syn.items()},
                dendritic=(None if st.dendritic is None
                           else lanes(st.dendritic, g.post)),
                cursor=(None if st.cursor is None
                        else torch.as_tensor(st.cursor).to(dev)))
        return SimState(neurons=neurons, spikes=spikes, prev_above=prev,
                        syn=syn, t=torch.as_tensor(state.t).to(dev),
                        key=torch.as_tensor(state.key).to(dev),
                        finite=torch.as_tensor(state.finite).to(dev))

    # -- memory ---------------------------------------------------------------
    def memory_report(self) -> List[dict]:
        """Each group's report with what one rank holds: its connectivity
        block, its ring's shard, the world size.  The full graph and the
        full ``Simulator`` every rank also holds (``ModelSpec.build``) are
        not in it."""
        out = []
        for g in self.net.synapses:
            rep = g.memory_report()
            conn = self._conn[g.name]
            if conn.dense is not None:
                local = int(conn.dense.shape[0] * conn.dense.shape[1])
            else:
                local = int(conn.ell.n_pre * conn.ell.max_conn)
            rep["local_elements_per_device"] = local
            rep["ring_elements_per_device"] = (
                g.ring_slots * self._shard[g.post] if g.needs_ring else 0)
            rep["n_shards"] = self.n_shards
            out.append(rep)
        return out
