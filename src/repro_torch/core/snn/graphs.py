"""The compiled step loop: a Simulator's steps captured as CUDA graphs.

Counterpart of the JAX package's jitted runs (``Simulator.run_jit``,
``CompiledModel.run`` and ``sweep_gscale``, each one ``lax.scan`` in one XLA
program).  The port's step is a few dozen device ops launched from Python,
so the host's dispatch, not the card, sets its pace; a CUDA graph replays
them without the host.

A ``ChunkedRun`` serves one configuration (batch, gScale keys, stim keys,
raster or not) of one Simulator.  It keeps the run in static device
buffers: the state (neurons, spikes, prev_above, synapse state with rings,
cursors and traces, t, key, finite), a [B] gScale per key, a stim chunk
[K, B, n] per stimulated population, the spike counts and a raster chunk
[K, B, n].  A chunk of L <= K steps (``CHUNK_STEPS``) runs ``Simulator.step``
L times from the static state and copies the new state back into it.  On a
CUDA device each chunk length is captured once as a graph and replayed;
only K and one remainder length are kept, so a configuration holds at most
two graphs.  On the CPU the same chunks run eagerly.

Probes, scheduled custom updates and the health monitor ride the same
chunks.  A probe's ring is sized by the run's step count, which a captured
graph cannot follow, so the graph writes each step's sample into row i of a
staging buffer [K, B, ...] per probe (GeNN's bitmask words for spike
probes, by the hand-written kernel), and after each replay the host copies
the chunk's due rows (every ``every``-th, on the global schedule from the
run's starting step, read once before the first replay) into the run's
rings: consecutive slots modulo the ring's size, so at most two slice
copies a probe a chunk.  Scheduled updates trigger on the device's ``t``
inside ``Simulator.step``; the monitor's accumulator joins the static
buffers.  None of them adds to a runner's cache key.

Everything that changes between replays is a buffer's contents: new gScale
or stim values are copies into the buffers, never a new capture (a value
captured as a kernel argument would be stale on the next replay).  So the
step reads nothing on the host: t and the rings' cursors are device
tensors, the random numbers come from device keys (``repro_torch.random``)
and a captured gScale is always a [B] buffer.

``ServedChunk`` does the same for ``Simulator.serve_chunk`` (serving): one
graph a (streams, chunk, gScale keys, stim keys, raster) over the state of
S stream slots, each lane masked by its ``steps_left`` on the device (its
docstring).

Before its first capture a chunk length runs one eager step on the static
buffers (without storing its result), which builds the kernels and
allocates the delay scatter's scratch outside the capture.  The run owns
that scratch (``SynapseGroup.swap_scratch``): the graphs write it at every
replay, so no eager step of the group may hold it.  The kernel wrappers count
their launches once while a chunk is captured; those counts are taken back
and added again at every replay.  A capture or replay that fails raises:
nothing runs eagerly in its place.  A sharded engine's chunks capture its
NCCL all-gathers with them (``capture_mode`` "thread_local": the process
group's watchdog thread may query its events while this thread captures).
"""

from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.snn import probes as PR

__all__ = ["ChunkedRun", "ServedChunk", "CHUNK_STEPS", "launch_counters"]

# steps a graph replays: long enough that a replay's host work (a launch and
# a few copies) is small beside the chunk's device time, short enough that a
# capture stays quick and a remainder graph small
CHUNK_STEPS = 32


def launch_counters() -> Tuple[Dict[str, int], ...]:
    """Every kernel wrapper's launch counter (``launches`` of each module)."""
    from repro_torch.kernels import (delay_ring, ell_spmv, flash_attention,
                                     hh_step, izhikevich_step, spike_bitmask,
                                     ssd_scan, threefry)
    return tuple(m.launches for m in (ell_spmv, delay_ring, izhikevich_step,
                                      hh_step, threefry, flash_attention,
                                      ssd_scan, spike_bitmask))


def _tree_map(fn, x, *ys):
    """``fn`` over the tensors of a state (dicts, dataclasses, None left
    as it is), zipped with states of the same structure."""
    if x is None:
        return x
    if isinstance(x, torch.Tensor):
        return fn(x, *ys)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v, *(y[k] for y in ys))
                for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _tree_map(fn, getattr(x, f.name),
                                            *(getattr(y, f.name) for y in ys))
                          for f in dataclasses.fields(x)})
    raise TypeError(f"unexpected state leaf {type(x).__name__}")


def _capture(runner, warm, body) -> Tuple[torch.cuda.CUDAGraph, list]:
    """(graph, launches) of ``body`` captured on ``runner``'s delay
    scratch and graph pool, after ``warm`` (one eager step on the static
    buffers, its result dropped: it builds the kernels, makes their plans
    and allocates the scratch outside the capture).  The launches the
    wrappers counted while capturing are taken back and returned, to be
    added at every replay."""
    dev = runner.device
    delayed = [grp for grp in runner.sim.net.synapses
               if grp.ell.delay is not None]
    eager = {grp.name: grp.swap_scratch(runner.scratch.get(grp.name))
             for grp in delayed}
    counters = launch_counters()
    # a graph destroyed while another is captured invalidates the capture:
    # collect dropped runners' graphs now, and let no garbage collection
    # run until the capture has ended
    gc.collect()
    gc_on = gc.isenabled()
    gc.disable()
    try:
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm()
        main.wait_stream(side)
        before = [dict(c) for c in counters]
        if runner._pool is None:
            runner._pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g, pool=runner._pool,
                                  capture_error_mode=runner.sim.capture_mode):
                body()
        finally:
            # the capture launched nothing: its counts come back at every
            # replay
            launches = [{k: c[k] - b[k] for k in c}
                        for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.update(b)
    finally:
        if gc_on:
            gc.enable()
        for grp in delayed:
            acc = grp.swap_scratch(eager[grp.name])
            if acc is not None:
                runner.scratch[grp.name] = acc
    return g, launches


def _replay(g: torch.cuda.CUDAGraph, launches: list) -> None:
    """Replay a captured graph and add its launches to the counters."""
    g.replay()
    for c, d in zip(launch_counters(), launches):
        for k, v in d.items():
            c[k] += v


def _load(static: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    if value.shape != static.shape or value.dtype != static.dtype:
        raise ValueError(f"state tensor {value.dtype} {tuple(value.shape)} "
                         f"does not match the run's {static.dtype} "
                         f"{tuple(static.shape)}")
    return static.copy_(value)


def _store(static, new) -> None:
    """Copy a chunk's last state into the static buffers (a leaf the steps
    passed through unchanged is the buffer itself)."""
    static_ptrs = set()
    _tree_map(lambda s: static_ptrs.add(s.untyped_storage().data_ptr()),
              static)

    def put(s, v):
        if v is s or (v.data_ptr() == s.data_ptr()
                      and v.shape == s.shape and v.stride() == s.stride()):
            return s
        if v.untyped_storage().data_ptr() in static_ptrs:
            raise RuntimeError("a step returned a view of another state "
                               "buffer; the chunk cannot store it")
        return s.copy_(v)
    _tree_map(put, static, new)


class ChunkedRun:
    """Run a Simulator's steps over static buffers, a chunk at a time: CUDA
    graphs on the card, eager chunks on the CPU (module docstring)."""

    def __init__(self, sim, batch: int, gscale_keys: Sequence[str],
                 stim_keys: Sequence[str], record_raster: bool):
        # the Simulator holds its runners: no cycle back, so a dropped model
        # frees its graphs and buffers at once
        self.sim = weakref.proxy(sim)
        self.batch = batch
        self.chunk = CHUNK_STEPS
        dev = sim.device
        self.device = dev
        width = sim._width
        self.state = sim.init_state(batch)
        self.gscales = {k: torch.ones(batch, dtype=torch.float32, device=dev)
                        for k in gscale_keys}
        self.stim = {k: torch.zeros((self.chunk, batch, width[k]),
                                    dtype=torch.float32, device=dev)
                     for k in stim_keys}
        self.counts = {k: torch.zeros((batch, w), dtype=torch.int32,
                                      device=dev) for k, w in width.items()}
        self.raster = ({k: torch.zeros((self.chunk, batch, w),
                                       dtype=torch.bool, device=dev)
                        for k, w in width.items()} if record_raster else None)
        # a probe's samples of the chunk's steps, row i for step i
        self.staging = {
            p.name: torch.zeros((self.chunk,) + sim._ring_row_shape(p, batch),
                                dtype=PR.ring_dtype(p), device=dev)
            for p in sim.probes}
        self.health = (sim._health_init(batch) if sim.monitor is not None
                       else None)
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self.graph_launches: Dict[int, list] = {}
        # the delay groups' scratch that the graphs write (group name ->
        # [S, n_post, B] float64, kept zero between steps by the fold)
        self.scratch: Dict[str, torch.Tensor] = {}
        self._pool = None

    # -- the chunk ----------------------------------------------------------
    def _observe(self, i: int, st, spk, hs):
        """Step i's probe samples into the staging rows; the monitor's
        accumulator after the step (None when unmonitored)."""
        sim = self.sim
        for p in sim.probes:
            sim._sample_into(p, self.staging[p.name], i, st, spk)
        return None if hs is None else sim._health_step(hs, st, spk)

    def _steps(self, n: int) -> None:
        """n steps from the static state into it, counting spikes, filling
        the raster chunk, the probes' staging rows and the monitor."""
        sim, st, hs = self.sim, self.state, self.health
        for i in range(n):
            st, spk = sim._local_step(st, self.gscales,
                                      {k: v[i] for k, v in self.stim.items()})
            for k, c in self.counts.items():
                c += spk[k]
                if self.raster is not None:
                    self.raster[k][i].copy_(spk[k])
            hs = self._observe(i, st, spk, hs)
        _store(self.state, st)
        if hs is not None:
            _tree_map(lambda s, v: s.copy_(v), self.health, hs)

    # -- graphs ---------------------------------------------------------------
    def _graph(self, n: int) -> Optional[torch.cuda.CUDAGraph]:
        """The graph of an n-step chunk, set up at first use: captured on
        the card, None on the CPU (where the chunk runs eagerly).  Only K
        and the latest remainder length are kept."""
        if n in self.graphs:
            return self.graphs[n]
        if n != self.chunk:
            for m in [m for m in self.graphs if m != self.chunk]:
                del self.graphs[m]
                self.graph_launches.pop(m, None)
        g = self._capture(n) if self.device.type == "cuda" else None
        self.graphs[n] = g
        self.sim.graph_counts["captures"] += 1
        return g

    def _capture(self, n: int) -> torch.cuda.CUDAGraph:
        """One eager warm-up step (its result dropped), then the n-step
        chunk captured on the run's own delay scratch."""
        def warm():
            st, spk = self.sim._local_step(
                self.state, self.gscales,
                {k: v[0] for k, v in self.stim.items()})
            # staging row 0 is rewritten before any copy reads it
            self._observe(0, st, spk, self.health)

        g, self.graph_launches[n] = _capture(self, warm,
                                             lambda: self._steps(n))
        return g

    def _chunk(self, n: int) -> None:
        g = self._graph(n)
        if g is None:
            self._steps(n)
        else:
            _replay(g, self.graph_launches[n])
        self.sim.graph_counts["replays"] += 1

    # -- a run ----------------------------------------------------------------
    def _copy_samples(self, rings, caps, start: int, i0: int,
                      n: int) -> None:
        """The due staging rows of the chunk of steps i0 .. i0+n-1 into
        the run's rings: sample j (global step (j + 1) * every) lands at
        slot (j - base) % cap, so a chunk's samples fill consecutive slots
        modulo cap (two slice copies at most; a window smaller than the
        chunk's samples keeps its last cap)."""
        s0 = start + i0
        for p in self.sim.probes:
            e, cap = p.every, caps[p.name]
            m = (s0 + n) // e - s0 // e
            if m == 0:
                continue
            first = (s0 // e + 1) * e
            src = self.staging[p.name][first - s0 - 1::e][:m]
            j0 = first // e - 1 - PR.probe_base(p, start)
            if m > cap:
                src, j0, m = src[m - cap:], j0 + m - cap, cap
            a = j0 % cap
            k = min(m, cap - a)
            ring = rings[p.name]
            ring[a:a + k].copy_(src[:k])
            if k < m:
                ring[:m - k].copy_(src[k:])

    def run(self, state, n_steps: int, gscales: Mapping[str, object],
            stim: Mapping[str, torch.Tensor]):
        """(final state, spike counts [B, n], raster [n_steps, B, n] or
        None, Recordings, the monitor's HealthState or None) of n_steps
        from ``state``; ``stim`` rows [n_steps, n] or [n_steps, B, n] on
        the device."""
        if state.batch != self.batch:
            raise ValueError(f"state has batch {state.batch}, the run "
                             f"{self.batch}")
        K, B = self.chunk, self.batch
        # set up (capture) first: a warm-up step reads the static buffers
        if n_steps >= K:
            self._graph(K)
        if n_steps % K:
            self._graph(n_steps % K)
        _tree_map(_load, self.state, state)
        sim = self.sim
        # the run's first global step, read once (before the first replay)
        start = sim._step_count(self.state) if sim.probes else 0
        rings, caps = sim._probe_init(n_steps, B)
        if self.health is not None:
            _tree_map(lambda s, v: s.copy_(v), self.health,
                      sim._health_init(B))
        for k, buf in self.gscales.items():
            buf.copy_(torch.as_tensor(gscales[k], dtype=torch.float32)
                      .expand(B))
        for c in self.counts.values():
            c.zero_()
        raster = ({k: torch.empty((n_steps,) + tuple(c.shape),
                                  dtype=torch.bool, device=self.device)
                   for k, c in self.counts.items()}
                  if self.raster is not None else None)
        for i0 in range(0, n_steps, K):
            n = min(K, n_steps - i0)
            for k, buf in self.stim.items():
                rows = stim[k][i0:i0 + n]
                buf[:n].copy_(rows[:, None] if rows.dim() == 2 else rows)
            self._chunk(n)
            if raster is not None:
                for k, r in raster.items():
                    r[i0:i0 + n].copy_(self.raster[k][:n])
            if rings:
                self._copy_samples(rings, caps, start, i0, n)
        out = _tree_map(torch.clone, self.state)
        counts = {k: c.clone() for k, c in self.counts.items()}
        rec = sim._probe_finalize(rings, caps, start, n_steps, B)
        hs = (None if self.health is None
              else _tree_map(torch.clone, self.health))
        return out, counts, raster, rec, hs


def _lanes(act: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The [S] lane mask as a view that broadcasts against ``like``
    [S, ...]."""
    return act.view((act.shape[0],) + (1,) * (like.dim() - 1))


class ServedChunk:
    """``serve_chunk`` for one configuration (streams S, chunk length,
    gScale keys, stim keys, raster or not) of one Simulator: every stream
    slot advances up to ``n_steps`` steps, a lane at or past its
    ``steps_left`` restored leaf by leaf, so idle and finished slots are
    exact no-ops (the JAX package's ``vmap``'d scan with ``jnp.where``).

    Static buffers: the state [S], a [S] gScale per key, the stim chunk
    [S, n_steps, n] per stimulated population, ``steps_left`` [S] int32,
    spike counts [S, n], a raster chunk [n_steps, S, n], each probe's
    staging rows [n_steps, S, ...] and its samples [S, cap, ...] with
    their counts [S], and the monitor's accumulator.  The chunk computes
    each step's lane mask on the device (``steps_left > i``) and reads
    nothing on the host, so on a CUDA device it is one graph, captured at
    first use and replayed for every chunk of this configuration; on the
    CPU it runs eagerly.

    Probes: each step's sample goes to staging row i (GeNN's bitmask
    words for spike probes, by the hand-written kernel), and after the
    last step each slot's due rows are gathered on the device from its
    own step count at the chunk's start (round(t/dt) [S]): sample k of
    slot b is step i = first_b + k * every, first_b = -(start_b + 1) mod
    every, for i below the slot's min(steps_left, n_steps); the rows past
    its count are zeros.  That is the JAX package's masked strided write
    (``capacity(serving=True)`` rows, ``window`` not applied)."""

    def __init__(self, sim, streams: int, n_steps: int,
                 gscale_keys: Sequence[str], stim_keys: Sequence[str],
                 record_raster: bool):
        self.sim = weakref.proxy(sim)
        self.streams = S = streams
        self.n_steps = n = n_steps
        dev = sim.device
        self.device = dev
        width = sim._width
        self.state = sim.init_state(S)
        self.gscales = {k: torch.ones(S, dtype=torch.float32, device=dev)
                        for k in gscale_keys}
        self.stim = {k: torch.zeros((S, n, width[k]), dtype=torch.float32,
                                    device=dev) for k in stim_keys}
        self.steps_left = torch.zeros(S, dtype=torch.int32, device=dev)
        self.counts = {k: torch.zeros((S, w), dtype=torch.int32,
                                      device=dev) for k, w in width.items()}
        self.raster = ({k: torch.zeros((n, S, w), dtype=torch.bool,
                                       device=dev)
                        for k, w in width.items()} if record_raster else None)
        self.staging, self.samples, self.sample_counts = {}, {}, {}
        self._k = {}
        for p in sim.probes:
            row = sim._ring_row_shape(p, S)
            cap = PR.capacity(p, n, serving=True)
            self.staging[p.name] = torch.zeros(
                (n,) + row, dtype=PR.ring_dtype(p), device=dev)
            self.samples[p.name] = torch.zeros(
                (S, cap) + row[1:], dtype=PR.ring_dtype(p), device=dev)
            self.sample_counts[p.name] = torch.zeros(S, dtype=torch.int32,
                                                     device=dev)
            self._k[p.name] = torch.arange(cap, dtype=torch.int32,
                                           device=dev)
        self._health0 = (sim._health_init(S) if sim.monitor is not None
                         else None)
        self.health = (None if self._health0 is None
                       else _tree_map(torch.clone, self._health0))
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_launches: list = []
        self.scratch: Dict[str, torch.Tensor] = {}
        self._pool = None
        # device time of the last chunk: (before the stim copy, after it,
        # after the chunk), on the card
        self.events = (tuple(torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
                       if dev.type == "cuda" else None)

    # -- the chunk ----------------------------------------------------------
    def _body(self) -> None:
        """The chunk: n_steps masked steps from the static state into it,
        the lanes' spike counts, raster rows, probe samples and monitor."""
        sim, st = self.sim, self.state
        for c in self.counts.values():
            c.zero_()
        hs = self.health
        if hs is not None:
            _tree_map(lambda s, v: s.copy_(v), hs, self._health0)
        start = sim._stream_steps(st) if sim.probes else None
        for i in range(self.n_steps):
            act = self.steps_left > i
            st2, spk = sim._local_step(
                st, self.gscales, {k: v[:, i] for k, v in self.stim.items()})
            st2 = _tree_map(lambda a, b: a if a is b else torch.where(
                _lanes(act, a), a, b), st2, st)
            spk = {k: v & act[:, None] for k, v in spk.items()}
            for k, c in self.counts.items():
                c += spk[k]
                if self.raster is not None:
                    self.raster[k][i].copy_(spk[k])
            for p in sim.probes:
                sim._sample_into(p, self.staging[p.name], i, st2, spk)
            if hs is not None:
                hs = sim._health_step(hs, st2, spk, gate=act)
            st = st2
        _store(self.state, st)
        if hs is not None:
            _tree_map(lambda s, v: s.copy_(v), self.health, hs)
        if sim.probes:
            self._select_samples(start)

    def _select_samples(self, start: torch.Tensor) -> None:
        """Each slot's due staging rows into its samples (module docstring
        of the class), and their counts."""
        n = self.n_steps
        left = torch.clamp(self.steps_left, 0, n)
        for p in self.sim.probes:
            e = p.every
            k = self._k[p.name]
            cap = k.shape[0]
            first = torch.remainder(-(start + 1), e)
            rows = torch.clamp(first[:, None] + k * e, max=n - 1)
            count = torch.clamp((start + left) // e - start // e, max=cap)
            src = self.staging[p.name].transpose(0, 1)      # [S, n, ...]
            out = self.samples[p.name]
            trail = (1,) * (out.dim() - 2)
            idx = rows.view(rows.shape + trail).expand(out.shape).long()
            valid = (k < count[:, None]).view(rows.shape + trail)
            out.copy_(torch.where(valid, torch.gather(src, 1, idx), 0))
            self.sample_counts[p.name].copy_(count)

    def _warm(self) -> None:
        """One eager step on the static buffers with its observation (the
        result dropped), before the capture."""
        sim = self.sim
        st, spk = sim._local_step(self.state, self.gscales,
                                  {k: v[:, 0] for k, v in self.stim.items()})
        for p in sim.probes:
            sim._sample_into(p, self.staging[p.name], 0, st, spk)
        if self.health is not None:
            sim._health_step(self.health, st, spk, gate=self.steps_left > 0)

    # -- a chunk's call -----------------------------------------------------
    def run(self, state, stim: Mapping[str, torch.Tensor],
            steps_left: torch.Tensor, gscales: Mapping[str, object]):
        """(state, counts [S, n], raster [S, n_steps, n] or None,
        Recordings [S, cap, ...] with counts [S], the monitor's HealthState
        [S] or None) of one chunk from ``state``.  ``stim``: [S, n_steps,
        n] per key, on the device or on the host (from pinned memory the
        copy does not wait for the host); ``steps_left``: [S] int32."""
        if state.batch != self.streams:
            raise ValueError(f"state has {state.batch} streams, the chunk "
                             f"{self.streams}")
        sim = self.sim
        if self.device.type == "cuda" and self.graph is None:
            self.graph, self.graph_launches = _capture(self, self._warm,
                                                       self._body)
            sim.graph_counts["captures"] += 1
        _tree_map(_load, self.state, state)
        for k, buf in self.gscales.items():
            buf.copy_(torch.as_tensor(gscales[k], dtype=torch.float32)
                      .expand(self.streams))
        self.steps_left.copy_(steps_left)
        ev = self.events
        if ev is not None:
            ev[0].record()
        for k, buf in self.stim.items():
            buf.copy_(stim[k], non_blocking=True)
        if ev is not None:
            ev[1].record()
        if self.graph is None:
            self._body()
        else:
            _replay(self.graph, self.graph_launches)
        if ev is not None:
            ev[2].record()
        sim.graph_counts["replays"] += 1
        out = _tree_map(torch.clone, self.state)
        counts = {k: c.clone() for k, c in self.counts.items()}
        raster = (None if self.raster is None else
                  {k: r.transpose(0, 1).contiguous()
                   for k, r in self.raster.items()})
        # fresh tensors: packed rows unpacked to bool
        rec = PR.Recordings(
            data={p.name: sim._finish_samples(p, self.samples[p.name])
                  for p in sim.probes},
            counts={k: c.clone() for k, c in self.sample_counts.items()})
        hs = (None if self.health is None
              else _tree_map(torch.clone, self.health))
        return out, counts, raster, rec, hs

    def device_ms(self) -> Optional[Tuple[float, float]]:
        """(stim copy ms, chunk ms) of the last call, by CUDA events (the
        caller has waited for the chunk); None on the CPU."""
        if self.events is None:
            return None
        e0, e1, e2 = self.events
        return e0.elapsed_time(e1), e1.elapsed_time(e2)
