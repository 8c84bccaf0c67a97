"""Streaming SNN serving: a continuous-batching server over CompiledModel.

Counterpart of ``repro/launch/snn_serve.py``.  Where the token server keeps
KV caches, this one keeps *simulation state*: an SNNServer owns one compiled
spiking network whose state carries a leading stream axis (the port's batch
axis) of ``max_streams`` slots, each an independent simulation with its own
neuron, synapse and STDP state, dendritic-delay rings and cursors, ``t`` and
threefry key, all on the card between requests.

Clients submit stimulus streams (per-population injected currents, one row
per dt step).  The slot scheduler (``launch/scheduling.py``, shared with the
token server) admits queued streams into free slots; one ``serve_step`` --
``model.serve_chunk(states, stim_chunk, steps_left)``, a CUDA graph captured
once and replayed -- then advances every active stream together, ``chunk``
dt steps a call.  Per-slot ``steps_left`` masking makes idle slots exact
no-ops, so a stream's spike output equals an offline ``model.run(T,
stim=..., state=init_state(key=PRNGKey(seed)))`` with the same seed and
stimulus bit for bit.  Finished streams free their slot for queued requests.

The stimulus chunk goes through a pinned host buffer [S, chunk, n] a
stimulated population, which the server fills in place and the chunk copies
to the card without waiting for the host; ``last_chunk_phases`` holds the
last chunk's assemble, stim copy, replay and readback times.

Demo CLI (the card unless ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.snn_serve \\
      --model mushroom_body --streams 8 --chunk 50
  PYTHONPATH=src python -m repro_torch.launch.snn_serve \\
      --model izhikevich --full --check
  # the sharded engine: one rank a device (gloo ranks on the CPU here)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m \\
      repro_torch.launch.snn_serve --model izhikevich --device cpu \\
      --devices 2 --check
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch.launch.scheduling import SlotScheduler
from repro_torch.obs import profile as obs_profile

__all__ = ["SNNServer", "StreamRequest", "ChunkOutput"]


@dataclasses.dataclass
class ChunkOutput:
    """One chunk of spike output streamed back to a request."""

    start_step: int
    n_steps: int
    spike_counts: Dict[str, np.ndarray]          # pop -> [n] ints
    raster: Optional[Dict[str, np.ndarray]]      # pop -> [n_steps, n] bool
    # probe name -> [samples_this_chunk, ...] (already cropped per slot)
    recordings: Optional[Dict[str, np.ndarray]] = None
    # HealthReport.summary() of this slot over this chunk (monitored builds
    # only); step indices are chunk-local
    health: Optional[Dict[str, object]] = None


@dataclasses.dataclass
class StreamRequest:
    """One client stimulus stream.

    stim: population -> [T, n] injected currents (one row per dt step);
    populations outside the server's ``stim_pops`` are rejected, missing
    ones are driven with zeros.  ``seed`` keys the slot's own random
    numbers: the served spike train equals an offline run from
    ``init_state(key=PRNGKey(seed))`` with the same stimulus bit for bit.
    """

    rid: int
    n_steps: int
    stim: Dict[str, np.ndarray]
    seed: int = 0
    chunks: List[ChunkOutput] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def spike_counts(self) -> Dict[str, np.ndarray]:
        """Total per-neuron spike counts streamed so far."""
        out: Dict[str, np.ndarray] = {}
        for c in self.chunks:
            for k, v in c.spike_counts.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def raster(self) -> Dict[str, np.ndarray]:
        """[T, n] spike raster per population (record_raster servers)."""
        out: Dict[str, List[np.ndarray]] = {}
        for c in self.chunks:
            if c.raster is None:
                raise ValueError("server built with record_raster=False")
            for k, v in c.raster.items():
                out.setdefault(k, []).append(v)
        return {k: np.concatenate(v) for k, v in out.items()}

    @property
    def health(self) -> Optional[Dict[str, object]]:
        """Health over all streamed chunks (monitored servers): spike
        totals summed, NaN-guard verdicts OR'd (``first_bad_step`` rebased
        to the stream's step index), rate EMAs and silent / saturated flags
        from the latest chunk.  None on unmonitored servers."""
        reports = [(c.start_step, c.health) for c in self.chunks
                   if c.health is not None]
        if not reports:
            return None
        last = reports[-1][1]
        pops: Dict[str, Dict[str, object]] = {}
        for p, cur in last["populations"].items():
            pops[p] = dict(cur)
            pops[p]["spikes"] = sum(int(h["populations"][p]["spikes"])
                                    for _, h in reports)
        first_bad = -1
        for start, h in reports:
            if int(h["first_bad_step"]) >= 0:
                first_bad = start + int(h["first_bad_step"])
                break
        return {
            "steps": sum(int(h["steps"]) for _, h in reports),
            "nonfinite": any(bool(h["nonfinite"]) for _, h in reports),
            "first_bad_step": first_bad,
            "populations": pops,
        }

    @property
    def recordings(self) -> Dict[str, np.ndarray]:
        """Stitched probe samples streamed so far: probe name ->
        [n_samples, ...] in chronological order, the offline run's
        ``Recordings`` rows for the same seed and stimulus (``window``
        probes stream every sample; window client-side)."""
        out: Dict[str, List[np.ndarray]] = {}
        for c in self.chunks:
            for k, v in (c.recordings or {}).items():
                out.setdefault(k, []).append(v)
        return {k: np.concatenate(v) for k, v in out.items()}


def _keys(seeds: Sequence[int]) -> torch.Tensor:
    """Threefry keys [len(seeds), 2], ``PRNGKey(seed)`` each."""
    return torch.stack([_random.PRNGKey(int(s)) for s in seeds])


class SNNServer:
    """Continuous-batching streaming server for one compiled SNN."""

    def __init__(self, model, max_streams: int = 4, chunk: int = 50,
                 stim_pops: Optional[Sequence[str]] = None,
                 gscales: Optional[Mapping[str, object]] = None,
                 record_raster: bool = False):
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.model = model
        self.chunk = int(chunk)
        self.max_streams = int(max_streams)
        pops = model.network.populations
        self.stim_pops = (tuple(stim_pops) if stim_pops is not None
                          else tuple(pops))
        unknown = set(self.stim_pops) - set(pops)
        if unknown:
            raise ValueError(
                f"unknown stim population(s) {sorted(unknown)}; declared "
                f"populations: {sorted(pops)}")
        self._pop_n = {p: pops[p].n for p in self.stim_pops}
        self.gscales = dict(gscales or {})
        self.record_raster = bool(record_raster)
        self.sched = SlotScheduler(max_streams)
        self.requests: Dict[int, StreamRequest] = {}   # rid -> request
        # the slots' state on the device: placeholder keys, re-keyed at
        # admission (a slot's key = its request's PRNGKey(seed))
        self.states = model.init_stream_state(_keys([0] * self.max_streams))
        self._cursor = np.zeros(self.max_streams, np.int64)  # steps served
        # pinned host stim buffers [S, chunk, n] by S (a gateway's buckets)
        self._stim_host: Dict[int, Dict[str, torch.Tensor]] = {}
        # the starting slot count's, now: pinning a large buffer takes a
        # tenth of a second or more, which would otherwise land on the
        # first chunk (a gateway's other buckets pin theirs at first use)
        self._host_buffers()
        # accounting
        self.total_chunks = 0
        self.total_slot_steps = 0      # steps actually served (masked out
        self.total_lane_steps = 0      # vs. lane capacity incl. idle slots)
        self.last_chunk_wall_s = 0.0   # wall time of the latest chunk
        # the latest chunk's phases in seconds: assemble (host), h2d and
        # replay (device, by CUDA events; None on the CPU), d2h (host wait
        # for the chunk and the readback)
        self.last_chunk_phases: Dict[str, Optional[float]] = {}

    # -- queue ------------------------------------------------------------
    def submit(self, req: StreamRequest) -> StreamRequest:
        unknown = set(req.stim) - set(self.stim_pops)
        if unknown:
            raise ValueError(
                f"request {req.rid}: stim population(s) {sorted(unknown)} "
                f"not served; server stim_pops={sorted(self.stim_pops)}")
        for p, arr in req.stim.items():
            want = (req.n_steps, self._pop_n[p])
            if tuple(np.shape(arr)) != want:
                raise ValueError(
                    f"request {req.rid}: stim[{p!r}] has shape "
                    f"{tuple(np.shape(arr))}, expected {want}")
        if req.rid in self.requests:
            raise ValueError(
                f"duplicate request rid {req.rid}; collect it with "
                "pop_finished() before recycling the id")
        # priority/deadline are optional request attributes: the gateway's
        # GatewayRequest sets both, and the scheduler orders/evicts by them
        self.sched.submit(req,          # also rejects rids still in timings
                          priority=getattr(req, "priority", 0),
                          deadline_at=getattr(req, "deadline_at", None))
        self.requests[req.rid] = req
        return req

    # -- internals --------------------------------------------------------
    def _admit(self) -> List:
        """Admit queued requests into free slots, each slot starting fresh
        from its request's seed (one ``select_streams`` keeps the other
        slots as they are); returns the new (slot, request) assignments."""
        assigned = self.sched.admit()
        if assigned:
            idx = np.arange(self.max_streams)
            seeds = [0] * self.max_streams
            for slot, req in assigned:
                idx[slot] = -1
                seeds[slot] = req.seed
                self._cursor[slot] = 0
            self.states = self.model.select_streams(self.states, idx,
                                                    _keys(seeds))
        return assigned

    def _host_buffers(self) -> Dict[str, torch.Tensor]:
        """The stim chunk's host buffers [S, chunk, n] for this slot count
        (pinned when the model is on the card)."""
        S = self.max_streams
        bufs = self._stim_host.get(S)
        if bufs is None:
            pin = self.model.device.type == "cuda"
            bufs = self._stim_host[S] = {
                p: torch.zeros((S, self.chunk, n), dtype=torch.float32,
                               pin_memory=pin)
                for p, n in self._pop_n.items()}
        return bufs

    def _assemble(self):
        """Stim chunk [S, chunk, n] per population + per-slot steps_left.
        A lane's rows past its steps_left (and an idle lane's) are masked
        on the card, so only an active lane's rows are written: its next
        rows, zeros after a stream's last one.  The rows go in by torch's
        copy, which splits a large copy over the host's cores."""
        C = self.chunk
        steps_left = np.zeros(self.max_streams, np.int32)
        bufs = self._host_buffers()
        for slot, req in self.sched.active.items():
            cur = int(self._cursor[slot])
            take = min(C, req.n_steps - cur)
            steps_left[slot] = take
            for p, b in bufs.items():
                arr = req.stim.get(p)
                if arr is None:
                    b[slot].zero_()
                else:
                    b[slot, :take].copy_(torch.from_numpy(
                        np.ascontiguousarray(arr[cur:cur + take],
                                             np.float32)))
                    b[slot, take:].zero_()
        return bufs, steps_left

    # -- main loop --------------------------------------------------------
    def serve_step(self) -> bool:
        """Admit, advance all active streams one chunk, stream outputs and
        evict finished streams; returns True while work remains."""
        self._admit()
        if not self.sched.active:
            return self.sched.has_work()
        self._advance_chunk()
        return self.sched.has_work()

    def _advance_chunk(self) -> List[StreamRequest]:
        """One chunk over every active slot: assemble the stimulus, run
        serve_chunk, stream outputs back to the requests, release finished
        slots.  Returns the requests that finished this chunk;
        ``last_chunk_wall_s`` holds the wall time of the whole advance
        (assembly, chunk, readback), the gateway's per-step latency
        sample, and ``last_chunk_phases`` its parts."""
        t0 = time.perf_counter()
        stim, steps_left = self._assemble()
        t1 = time.perf_counter()
        out = self.model.serve_chunk(
            self.states, stim, steps_left, self.chunk,
            gscales=self.gscales, record_raster=self.record_raster)
        # monitored builds append a per-slot HealthReport (5-tuple)
        if len(out) == 5:
            self.states, counts, raster, rec, health = out
        else:
            (self.states, counts, raster, rec), health = out, None
        counts = {k: v.cpu().numpy() for k, v in counts.items()}
        if raster is not None:
            raster = {k: v.cpu().numpy() for k, v in raster.items()}
        rec_data = {k: v.cpu().numpy() for k, v in rec.data.items()}
        rec_counts = {k: v.cpu().numpy() for k, v in rec.counts.items()}
        t2 = time.perf_counter()
        self.total_chunks += 1
        self.total_slot_steps += int(steps_left.sum())
        self.total_lane_steps += self.max_streams * self.chunk
        finished: List[StreamRequest] = []
        for slot, req in list(self.sched.active.items()):
            took = int(steps_left[slot])
            start = int(self._cursor[slot])
            # copies, not views: a [slot] view would pin the whole [S, ...]
            # chunk array for the request's lifetime
            req.chunks.append(ChunkOutput(
                start_step=start, n_steps=took,
                spike_counts={k: v[slot].copy() for k, v in counts.items()},
                raster=(None if raster is None
                        else {k: v[slot, :took].copy()
                              for k, v in raster.items()}),
                recordings={k: v[slot, : int(rec_counts[k][slot])].copy()
                            for k, v in rec_data.items()},
                health=(health.summary(slot) if health is not None
                        else None)))
            self._cursor[slot] = start + took
            if self._cursor[slot] >= req.n_steps:
                req.done = True
                self.sched.release(slot)
                finished.append(req)
        self.last_chunk_wall_s = time.perf_counter() - t0
        dev = self.model.backend.last_serve_device_ms()
        self.last_chunk_phases = {
            "assemble_s": t1 - t0,
            "h2d_s": None if dev is None else dev[0] * 1e-3,
            "replay_s": None if dev is None else dev[1] * 1e-3,
            "call_and_d2h_s": t2 - t1,
        }
        return finished

    def run(self) -> List[StreamRequest]:
        """Drain the queue; returns finished requests (rid order).  The
        server keeps finished requests registered until pop_finished()
        collects them: a long-lived server must collect, or per-request
        memory grows without bound."""
        while self.serve_step():
            pass
        return sorted((r for r in self.requests.values() if r.done),
                      key=lambda r: r.rid)

    def pop_finished(self) -> List[StreamRequest]:
        """Collect finished requests (rid order), dropping them and their
        timing records from the server so memory stays bounded."""
        done = sorted((r for r in self.requests.values() if r.done),
                      key=lambda r: r.rid)
        for r in done:
            del self.requests[r.rid]
            self.sched.forget(r.rid)
        return done

    # -- reporting --------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        util = (self.total_slot_steps / self.total_lane_steps
                if self.total_lane_steps else 0.0)
        return {
            "max_streams": self.max_streams,
            "chunk": self.chunk,
            "chunks": self.total_chunks,
            "slot_steps": self.total_slot_steps,
            "slot_utilization": util,
            "latency": self.sched.latency_summary(),
        }


# ---------------------------------------------------------------------------
# demo CLI
# ---------------------------------------------------------------------------

def _build_model(name: str, devices: int, full: bool, device=None,
                 monitor=None):
    """(model, stim populations, stimulus current scale) for the demo;
    ``devices`` > 0 builds over a mesh of that many ranks (every rank runs
    this; more than one needs a launcher: ``torchrun --nproc-per-node``)."""
    mesh = None
    if devices:
        from repro_torch.launch.mesh import make_snn_mesh
        mesh = make_snn_mesh(devices, device=device)
        device = None
    if name == "mushroom_body":
        from repro_torch.core.models.mushroom_body import (
            MushroomBodyConfig, compile_model)
        # the KC membrane-voltage probe streams back per chunk alongside
        # spike counts: the serving demo of the probe API
        cfg = (MushroomBodyConfig(kc_probe_every=5) if full else
               MushroomBodyConfig(n_pn=20, n_lhi=5, n_kc=100, n_dn=20,
                                  kc_probe_every=5))
        return (compile_model(cfg, device=device, monitor=monitor,
                              mesh=mesh), ("KC",), 1.5)
    if name == "izhikevich":
        from repro_torch.core.models.izhikevich_net import (
            IzhikevichNetConfig, compile_model)
        cfg = (IzhikevichNetConfig() if full else
               IzhikevichNetConfig(n_total=200, n_conn=30))
        return (compile_model(cfg, device=device, monitor=monitor,
                              mesh=mesh), ("exc",), 3.0)
    raise SystemExit(f"unknown --model {name!r} "
                     "(expected mushroom_body or izhikevich)")


def _check_exact(model, req, gscales=None) -> List[str]:
    """Exactness of one served request against an offline ``model.run``
    (with the server's ``gscales``); returns a list of failure
    descriptions (empty = exact).  Spike counts bit for bit; probe
    recordings within rtol=1e-5, atol=1e-4 (continuous state such as HH
    membrane V, as the JAX package allows)."""
    failures = []
    res = model.run(req.n_steps, stim=req.stim, gscales=gscales,
                    state=model.init_state(
                        key=_random.PRNGKey(req.seed)))
    for k, v in res.spike_counts.items():
        if not np.array_equal(v.cpu().numpy(), req.spike_counts[k]):
            failures.append(f"stream {req.rid}: population {k!r} spike "
                            "counts diverged from offline run")
    for k, v in req.recordings.items():
        off = res.recordings[k].cpu().numpy()
        off = off[: int(res.recordings.counts[k])]
        if off.shape != v.shape or not np.allclose(
                off, v, rtol=1e-5, atol=1e-4):
            failures.append(f"stream {req.rid}: probe {k!r} diverged "
                            "from offline run")
    return failures


def _run_gateway_demo(model, stim_pops, scale, args) -> int:
    """--deadline-ms: drive the demo through the serving gateway, the
    deadline on every other request, so deadline eviction and slot
    reclamation run end to end (under --check the unlimited half must stay
    exact against offline runs though neighbouring slots were evicted)."""
    from repro_torch.launch.gateway import Gateway

    gw = Gateway(chunk=args.chunk, buckets=(args.streams,),
                 max_queue=max(2 * args.requests, 4))
    gw.register(args.model, model, stim_pops=stim_pops)
    pops = {p: model.network.populations[p].n for p in stim_pops}
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        T = int(rng.integers(args.steps // 2, args.steps + 1))
        stim = {p: (scale * rng.normal(size=(T, n))).astype(np.float32)
                for p, n in pops.items()}
        dl = args.deadline_ms if i % 2 == 1 else None
        gw.submit(args.model, stim, T, seed=1000 + i, deadline_ms=dl)

    t0 = time.time()
    gw.run_until_drained()
    wall = time.time() - t0
    done = gw.collect_finished()
    completed = [r for r in done if r.status == "done"]
    evicted = [r for r in done if r.evicted]
    m = gw.metrics()["models"][args.model]
    print(f"[snn_serve] gateway: {len(completed)} completed, "
          f"{len(evicted)} evicted (deadline {args.deadline_ms}ms on "
          f"every other request) in {wall:.2f}s")
    print(f"[snn_serve] gateway: occupancy {m['occupancy']:.2f} "
          f"p99 step {m['step_latency_us']['p99']:.0f}us "
          f"p99 queue wait {m['queue_wait_s']['p99'] * 1e3:.1f}ms")

    if len(completed) + len(evicted) != args.requests:
        print(f"[snn_serve] FAILED: lost streams "
              f"({len(completed)}+{len(evicted)} != {args.requests})",
              file=sys.stderr)
        return 1
    if args.check:
        failures = []
        for r in completed:
            failures += _check_exact(model, r)
        if failures:
            for f in failures:
                print(f"[snn_serve] exactness check FAILED: {f}",
                      file=sys.stderr)
            return 1
        print(f"[snn_serve] exactness check: all {len(completed)} "
              "non-evicted streams exact vs offline runs")
    return 0


def main(argv=None) -> int:
    """The demo; a process group that ``--devices`` started is ended on
    the way out, whatever the outcome."""
    from repro_torch.launch.mesh import shutdown_distributed
    try:
        return _main(argv)
    finally:
        shutdown_distributed()


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="streaming SNN serving demo (continuous batching)")
    ap.add_argument("--model", default="mushroom_body",
                    choices=["mushroom_body", "izhikevich"])
    ap.add_argument("--streams", type=int, default=8,
                    help="stream slots on the device (the batch axis)")
    ap.add_argument("--chunk", type=int, default=50,
                    help="dt steps advanced per serve_step")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a check "
                         "without a card)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard over N ranks, one device each (0: the "
                         "single-device build; N > 1 under torchrun "
                         "--nproc-per-node N)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--steps", type=int, default=200,
                    help="stimulus length per request (dt steps)")
    ap.add_argument("--full", action="store_true",
                    help="full-size model (default: reduced demo sizes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="verify served streams exact vs offline runs; "
                         "exits non-zero on divergence")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="route the demo through the serving gateway with "
                         "this per-request deadline on every other request "
                         "(exercises deadline eviction end-to-end)")
    ap.add_argument("--health", action="store_true",
                    help="add the activity monitor (repro_torch.obs.health) "
                         "to the served chunk and print a per-stream health "
                         "line: spike totals, rate EMAs, silent/saturated "
                         "flags, NaN guard")
    ap.add_argument("--trace", default="", metavar="FILE",
                    help="write a Chrome trace_event JSON of build/serve "
                         "spans to FILE on exit")
    args = ap.parse_args(argv)

    monitor = None
    if args.health:
        from repro_torch.obs.health import HealthConfig
        monitor = HealthConfig()
    model, stim_pops, scale = _build_model(args.model, args.devices,
                                           args.full, device=args.device,
                                           monitor=monitor)
    if args.deadline_ms is not None:
        code = _run_gateway_demo(model, stim_pops, scale, args)
        return code or obs_profile.export_trace_cli(args.trace, "snn_serve")
    pops = {p: model.network.populations[p].n for p in stim_pops}
    print(f"[snn_serve] {model!r}")
    print(f"[snn_serve] streams={args.streams} chunk={args.chunk} "
          f"device={model.device} stim_pops={list(pops)}")

    srv = SNNServer(model, max_streams=args.streams, chunk=args.chunk,
                    stim_pops=stim_pops)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        # varied-length noisy current streams: each client gets its own
        # stimulus and its own seed (the slot is re-keyed at admission)
        T = int(rng.integers(args.steps // 2, args.steps + 1))
        stim = {p: (scale * rng.normal(size=(T, n))).astype(np.float32)
                for p, n in pops.items()}
        srv.submit(StreamRequest(rid=i, n_steps=T, stim=stim, seed=1000 + i))

    t0 = time.time()
    finished = srv.run()
    wall = time.time() - t0
    stats = srv.stats()
    total_steps = stats["slot_steps"]
    print(f"[snn_serve] {len(finished)}/{args.requests} streams, "
          f"{total_steps} stream-steps in {wall:.2f}s "
          f"({total_steps / max(wall, 1e-9):.0f} steps/s, "
          f"utilization {stats['slot_utilization']:.2f})")
    lat = stats["latency"]
    print(f"[snn_serve] latency: mean {lat.get('mean_total_s', 0):.3f}s "
          f"max {lat.get('max_total_s', 0):.3f}s "
          f"(queue wait {lat.get('mean_queue_wait_s', 0):.3f}s)")
    for r in finished[:4]:
        rates = {k: float(np.sum(v)) for k, v in r.spike_counts.items()}
        probes = {k: v.shape for k, v in r.recordings.items()}
        print(f"  stream{r.rid}: T={r.n_steps} spikes={rates}"
              + (f" probes={probes}" if probes else ""))
    if args.health:
        for r in finished:
            h = r.health
            flags = [p for p, d in h["populations"].items() if d["silent"]]
            sat = [p for p, d in h["populations"].items() if d["saturated"]]
            ema = {p: round(d["rate_ema_hz"], 2)
                   for p, d in h["populations"].items()}
            print(f"  health stream{r.rid}: rate_ema_hz={ema} "
                  f"silent={flags or 'none'} saturated={sat or 'none'} "
                  f"nonfinite={h['nonfinite']}"
                  + (f" first_bad_step={h['first_bad_step']}"
                     if h["nonfinite"] else ""))

    if len(finished) != args.requests:
        print("[snn_serve] FAILED: not all streams finished",
              file=sys.stderr)
        return 1
    if args.check:
        failures = _check_exact(model, finished[0])
        if failures:
            for f in failures:
                print(f"[snn_serve] exactness check FAILED: {f}",
                      file=sys.stderr)
            return 1
        print("[snn_serve] exactness check: served stream 0 exact "
              "vs offline run (spike counts + probe recordings)")
    return obs_profile.export_trace_cli(args.trace, "snn_serve")


if __name__ == "__main__":
    sys.exit(main())
