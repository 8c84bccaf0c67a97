"""SNN serving gateway: the front door in front of CompiledModel.serve.

Counterpart of ``repro/launch/gateway.py``.  The streaming server
(``launch/snn_serve.py``) is a tight loop over one model with a fixed slot
table; the gateway owns what sustained traffic needs:

  1. **Admission control / backpressure.**  Each model has a bounded
     admission queue; a submit against a full queue raises
     :class:`GatewayOverloaded` carrying a ``retry_after_s`` estimate
     (HTTP front door: 429 + Retry-After).
  2. **Deadlines.**  Requests carry ``deadline_ms``; at every chunk
     boundary the gateway evicts queued *and* in-flight requests past
     their deadline.  A mid-flight eviction reclaims the slot at once (the
     lane is masked until re-admission) and the client keeps the chunks
     already streamed.  Surviving streams stay exact against their offline
     run: eviction and slot re-packing only gather state along the stream
     axis (``CompiledModel.select_streams``), never touch it.
  3. **Elastic capacity.**  Slot tables come in a small set of
     ``max_streams`` buckets (e.g. 4/8/16), each with its own chunk graph,
     captured in ``warm_buckets`` at registration, before any traffic (and
     before an HTTP pump thread starts replaying them).  The gateway grows
     to the smallest bucket covering demand at once and shrinks after
     ``shrink_patience`` underloaded chunks; a resize is a gather on the
     device between chunks, with no capture and no copy through the host.
  4. **Multi-model slots.**  One gateway serves any number of registered
     models, each with its own worker and slot table, advanced round-robin
     by ``tick()``.

Observability: per-model p50/p99 queue wait, per-step serve latency and
end-to-end latency, slot occupancy, rejection/eviction/completion counters,
as a dict (:meth:`Gateway.metrics`) and as Prometheus text
(:meth:`Gateway.render_metrics`, the HTTP ``/metrics`` endpoint),
byte-identical to the JAX package's.

Demo CLI (two models, mixed priorities, deadlines tight enough to evict;
the card unless ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.gateway --requests 48 \
      --deadline-ms 2000 --buckets 4,8

HTTP front door: ``launch/gateway_http.py`` (stdlib asyncio only).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.launch.scheduling import SlotScheduler
from repro_torch.launch.snn_serve import SNNServer, StreamRequest, _keys
from repro_torch.obs import profile as obs_profile
# re-exported: the soak script and dashboards see telemetry's class
from repro_torch.obs.telemetry import LatencyWindow, PromText

__all__ = ["Gateway", "GatewayRequest", "GatewayOverloaded",
           "GatewayWorker", "LatencyWindow"]


class GatewayOverloaded(RuntimeError):
    """Raised by submit when a model's admission queue is full.

    ``retry_after_s`` estimates when capacity frees up: pending work in
    chunks times the recent chunk wall time (EMA).  Clients (and the HTTP
    layer's Retry-After header) should back off at least that long.
    """

    def __init__(self, model: str, queued: int, retry_after_s: float):
        super().__init__(
            f"admission queue full for model {model!r} ({queued} queued); "
            f"retry in {retry_after_s:.2f}s")
        self.model = model
        self.queued = queued
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class GatewayRequest(StreamRequest):
    """A StreamRequest with gateway semantics: priority class, deadline,
    and a lifecycle the client can wait on.

    status: queued -> active -> done | evicted.  An evicted request keeps
    every chunk streamed before its deadline (partial results); ``done``
    stays False.  ``wait`` blocks until the request leaves the gateway
    either way.
    """

    model: str = ""
    priority: int = 0                       # lower runs first
    deadline_ms: Optional[float] = None     # relative to submit
    deadline_at: Optional[float] = None     # absolute clock() time
    status: str = "queued"
    _done_evt: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    @property
    def evicted(self) -> bool:
        return self.status == "evicted"

    @property
    def steps_served(self) -> int:
        return sum(c.n_steps for c in self.chunks)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request completes or is evicted; True when it
        left the gateway within the timeout."""
        return self._done_evt.wait(timeout)

    def _finish(self, status: str) -> None:
        self.status = status
        self._done_evt.set()


class GatewayWorker(SNNServer):
    """One model's elastic slot table inside the gateway.

    Extends the streaming server with the gateway lifecycle: bounded
    admission, deadline sweeps at chunk boundaries, elastic bucket
    resizing (via CompiledModel.select_streams), and SLO accounting.
    Everything the plain server guarantees still holds — admitted lanes
    advance through the identical serve_chunk program, so a stream that is
    never evicted is bit-exact vs. its offline run regardless of how many
    neighbours got evicted or how often the table resized around it.
    """

    def __init__(self, name: str, model, buckets: Sequence[int] = (4, 8),
                 chunk: int = 50, stim_pops: Optional[Sequence[str]] = None,
                 gscales: Optional[Mapping[str, object]] = None,
                 record_raster: bool = False, max_queue: int = 64,
                 shrink_patience: int = 3, clock=time.monotonic,
                 warm: bool = True):
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] <= 0:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        if max_queue <= 0:
            raise ValueError(f"max_queue must be positive, got {max_queue}")
        super().__init__(model, max_streams=buckets[0], chunk=chunk,
                         stim_pops=stim_pops, gscales=gscales,
                         record_raster=record_raster)
        self.name = name
        self.buckets = buckets
        self.max_queue = int(max_queue)
        self.shrink_patience = int(shrink_patience)
        self.clock = clock
        self.sched = SlotScheduler(buckets[0], clock=clock)
        self._shrink_ticks = 0
        # -- SLO accounting ------------------------------------------------
        self.counters = collections.Counter(
            submitted=0, rejected=0, completed=0,
            evicted_queued=0, evicted_active=0, grows=0, shrinks=0)
        self.queue_wait_s = LatencyWindow()
        self.step_latency_us = LatencyWindow()
        self.total_latency_s = LatencyWindow()
        self._ema_chunk_s: Optional[float] = None
        if warm:
            self.warm_buckets()

    # -- pre-capture --------------------------------------------------------
    def warm_buckets(self) -> None:
        """Capture every bucket's chunk graph (and run the inter-bucket
        resize gathers) up front, so elastic grow/shrink at traffic time
        replays a graph, with no capture stall, and no capture overlaps
        another thread's launches (a pump thread starts after this)."""
        states = {}
        for b in self.buckets:
            st = self.model.init_stream_state(_keys([0] * b))
            stim = {p: np.zeros((b, self.chunk, n), np.float32)
                    for p, n in self._pop_n.items()}
            st, *_ = self.model.serve_chunk(
                st, stim, np.zeros(b, np.int32), self.chunk,
                gscales=self.gscales, record_raster=self.record_raster)
            states[b] = st
        for b_from in self.buckets:            # resize gathers, both ways
            for b_to in self.buckets:
                if b_from == b_to:
                    continue
                idx = np.full(b_to, -1, np.int32)
                idx[: min(b_from, b_to)] = np.arange(min(b_from, b_to))
                self.model.select_streams(states[b_from], idx,
                                          _keys([0] * b_to))

    # -- admission control -------------------------------------------------
    def retry_after_s(self) -> float:
        """Backoff hint for rejected submits: pending chunks of work times
        the recent chunk wall time (coarse but monotone in backlog)."""
        ema = self._ema_chunk_s if self._ema_chunk_s else 0.05
        pending = len(self.sched.queue) + len(self.sched.active)
        chunks_ahead = 1 + pending / max(1, self.max_streams)
        return ema * chunks_ahead

    def submit(self, req: GatewayRequest) -> GatewayRequest:
        if len(self.sched.queue) >= self.max_queue:
            self.counters["rejected"] += 1
            raise GatewayOverloaded(self.name, len(self.sched.queue),
                                    self.retry_after_s())
        if req.deadline_ms is not None and req.deadline_at is None:
            req.deadline_at = self.clock() + req.deadline_ms / 1e3
        super().submit(req)             # validation + priority-FIFO enqueue
        self.counters["submitted"] += 1
        return req

    # -- chunk-boundary lifecycle -------------------------------------------
    def _sweep_deadlines(self, now: Optional[float] = None) -> List:
        """Evict every queued/in-flight request past its deadline; their
        slots are immediately reclaimable (lanes without an active request
        are masked to exact no-ops, so survivors never notice)."""
        if now is None:
            now = self.clock()
        evicted = []
        for req in self.sched.expired(now):
            was_active = any(r.rid == req.rid
                             for r in self.sched.active.values())
            if self.sched.evict(req.rid) is None:
                continue                 # raced with completion: no-op
            self.counters["evicted_active" if was_active
                          else "evicted_queued"] += 1
            req._finish("evicted")
            evicted.append(req)
        return evicted

    def _target_bucket(self) -> int:
        demand = len(self.sched.active) + len(self.sched.queue)
        for b in self.buckets:
            if b >= demand:
                return b
        return self.buckets[-1]

    def _autoscale(self) -> None:
        """Grow immediately under pressure; shrink only after
        ``shrink_patience`` consecutive underloaded chunk boundaries
        (hysteresis — admission bursts should not thrash the table)."""
        target = self._target_bucket()
        if target > self.max_streams:
            self._resize(target)
            self.counters["grows"] += 1
            self._shrink_ticks = 0
        elif target < self.max_streams:
            self._shrink_ticks += 1
            if self._shrink_ticks >= self.shrink_patience:
                self._resize(target)
                self.counters["shrinks"] += 1
                self._shrink_ticks = 0
        else:
            self._shrink_ticks = 0

    def _resize(self, new_size: int) -> None:
        """Move to another bucket between chunks: compact the active slots
        to the low end (scheduler ``move`` + one select_streams gather
        carrying their device state bit for bit), then resize the slot
        table.  Never call mid-chunk."""
        actives = sorted(self.sched.active)
        idx = np.full(new_size, -1, np.int32)
        cursor = np.zeros(new_size, np.int64)
        for j, s in enumerate(actives):      # j <= s: destinations are free
            idx[j] = s
            cursor[j] = self._cursor[s]
            if j != s:
                self.sched.move(s, j)
        self.states = self.model.select_streams(self.states, idx,
                                                _keys([0] * new_size))
        self.sched.resize(new_size)
        self.max_streams = new_size
        self._cursor = cursor

    def serve_step(self) -> bool:
        """One gateway chunk: sweep deadlines, autoscale, admit, advance,
        account.  Returns True while work remains."""
        self._sweep_deadlines()
        self._autoscale()
        now = self.clock()
        for _, req in self._admit():
            req.status = "active"
            wait = self.sched.timings[req.rid].queue_wait_s
            if wait is not None:
                self.queue_wait_s.add(wait)
        if not self.sched.active:
            return self.sched.has_work()
        for req in self._advance_chunk():
            self.counters["completed"] += 1
            req._finish("done")
            total = self.sched.timings[req.rid].total_s
            if total is not None:
                self.total_latency_s.add(total)
        wall = self.last_chunk_wall_s
        self.step_latency_us.add(wall / self.chunk * 1e6)
        self._ema_chunk_s = (wall if self._ema_chunk_s is None
                             else 0.8 * self._ema_chunk_s + 0.2 * wall)
        return self.sched.has_work()

    # -- reporting ----------------------------------------------------------
    def metrics(self) -> Dict[str, object]:
        occupancy = (self.total_slot_steps / self.total_lane_steps
                     if self.total_lane_steps else 0.0)
        return {
            "model": self.name,
            "bucket": self.max_streams,
            "buckets": list(self.buckets),
            "active": len(self.sched.active),
            "queued": len(self.sched.queue),
            "max_queue": self.max_queue,
            "occupancy": occupancy,
            "chunks": self.total_chunks,
            "slot_steps": self.total_slot_steps,
            "counters": dict(self.counters),
            "queue_wait_s": self.queue_wait_s.summary(),
            "step_latency_us": self.step_latency_us.summary(),
            "total_latency_s": self.total_latency_s.summary(),
        }


class Gateway:
    """Multi-model serving gateway: one worker (elastic slot table) per
    registered model, advanced round-robin; a single front door for
    submits, deadline enforcement, backpressure, and SLO metrics.

    Thread-safe: ``submit``/``tick``/``metrics`` take the gateway lock, so
    an async front end (launch/gateway_http.py) can submit from its event
    loop while a pump thread ticks.  ``GatewayRequest.wait`` blocks
    without the lock.
    """

    def __init__(self, chunk: int = 50, buckets: Sequence[int] = (4, 8),
                 max_queue: int = 64, shrink_patience: int = 3,
                 clock=time.monotonic, warm: bool = True):
        self.chunk = chunk
        self.buckets = tuple(buckets)
        self.max_queue = max_queue
        self.shrink_patience = shrink_patience
        self.clock = clock
        self.warm = warm
        self.workers: Dict[str, GatewayWorker] = {}
        self._rid = itertools.count()
        self._lock = threading.RLock()
        self.started_at = clock()

    # -- registration -------------------------------------------------------
    def register(self, name: str, model, stim_pops=None, buckets=None,
                 chunk=None, max_queue=None, gscales=None,
                 record_raster: bool = False,
                 warm: Optional[bool] = None) -> GatewayWorker:
        """Attach a CompiledModel under ``name`` (per-model overrides fall
        back to the gateway defaults).  Warming captures every bucket's
        chunk graph up front: pay it at registration, not mid-traffic."""
        with self._lock:
            if name in self.workers:
                raise ValueError(f"model {name!r} already registered")
            w = GatewayWorker(
                name, model,
                buckets=self.buckets if buckets is None else buckets,
                chunk=self.chunk if chunk is None else chunk,
                stim_pops=stim_pops, gscales=gscales,
                record_raster=record_raster,
                max_queue=self.max_queue if max_queue is None else max_queue,
                shrink_patience=self.shrink_patience, clock=self.clock,
                warm=self.warm if warm is None else warm)
            self.workers[name] = w
            return w

    # -- front door ---------------------------------------------------------
    def submit(self, model: str, stim: Dict[str, np.ndarray], n_steps: int,
               seed: int = 0, priority: int = 0,
               deadline_ms: Optional[float] = None) -> GatewayRequest:
        """Submit one stimulus stream; returns the live GatewayRequest
        (wait() on it, or poll .status).  Raises GatewayOverloaded when the
        model's admission queue is full and KeyError/ValueError for an
        unknown model or malformed stimulus."""
        with self._lock:
            if model not in self.workers:
                raise KeyError(
                    f"unknown model {model!r}; registered: "
                    f"{sorted(self.workers)}")
            req = GatewayRequest(rid=next(self._rid), n_steps=int(n_steps),
                                 stim=stim, seed=int(seed), model=model,
                                 priority=int(priority),
                                 deadline_ms=deadline_ms)
            return self.workers[model].submit(req)

    # -- serving loop --------------------------------------------------------
    def tick(self) -> bool:
        """Advance every model with work by one chunk (round-robin);
        returns True while any worker still has work."""
        with self._lock:
            busy = False
            for w in self.workers.values():
                if w.sched.has_work():
                    busy |= w.serve_step()
            return busy

    def has_work(self) -> bool:
        with self._lock:
            return any(w.sched.has_work() for w in self.workers.values())

    def run_until_drained(self) -> None:
        while self.tick():
            pass

    def collect_finished(self) -> List[GatewayRequest]:
        """Pop every done/evicted request across models (rid order),
        pruning per-request accounting (the bounded-memory contract of
        SNNServer.pop_finished, gateway-wide)."""
        with self._lock:
            out: List[GatewayRequest] = []
            for w in self.workers.values():
                done = [r for r in w.requests.values()
                        if r.done or getattr(r, "evicted", False)]
                for r in done:
                    del w.requests[r.rid]
                    w.sched.forget(r.rid)
                out.extend(done)
            return sorted(out, key=lambda r: r.rid)

    # -- observability -------------------------------------------------------
    def metrics(self) -> Dict[str, object]:
        """Structured metrics snapshot: per-model worker metrics plus
        gateway-wide totals (the JSON twin of /metrics)."""
        with self._lock:
            per_model = {n: w.metrics() for n, w in self.workers.items()}
            totals = collections.Counter()
            for m in per_model.values():
                totals.update(m["counters"])
            return {"uptime_s": self.clock() - self.started_at,
                    "models": per_model, "counters": dict(totals)}

    def render_metrics(self) -> str:
        """Prometheus-style text exposition (the /metrics endpoint):
        counters as ``gateway_<name>_total``, gauges plain, latency
        windows as quantile-labelled gauges in base units (seconds)."""
        m = self.metrics()
        out = PromText()
        out.sample("gateway_uptime_seconds", {}, m["uptime_s"], "{:.3f}")
        for name, wm in sorted(m["models"].items()):
            lab = {"model": name}
            for c, v in sorted(wm["counters"].items()):
                out.sample(f"gateway_{c}_total", lab, v)
            out.sample("gateway_slots", lab, wm["bucket"])
            out.sample("gateway_active_streams", lab, wm["active"])
            out.sample("gateway_queued_streams", lab, wm["queued"])
            out.sample("gateway_slot_occupancy", lab, wm["occupancy"],
                       "{:.4f}")
            out.sample("gateway_chunks_total", lab, wm["chunks"])
            for metric, unit in (("queue_wait_s", 1.0),
                                 ("total_latency_s", 1.0),
                                 ("step_latency_us", 1e-6)):
                base = metric.rsplit("_", 1)[0]
                out.quantiles(f"gateway_{base}_seconds", lab, wm[metric],
                              unit=unit)
        return out.render()


# ---------------------------------------------------------------------------
# demo CLI
# ---------------------------------------------------------------------------

def _demo_models(devices: int, device=None):
    mesh = None
    if devices:
        # every rank serves the same traffic (torchrun for more than one)
        from repro_torch.launch.mesh import make_snn_mesh
        mesh = make_snn_mesh(devices, device=device)
        device = None
    from repro_torch.core.models.izhikevich_net import (IzhikevichNetConfig,
                                                        compile_model)
    izh = compile_model(IzhikevichNetConfig(n_total=200, n_conn=30),
                        device=device, mesh=mesh)
    from repro_torch.core.models.mushroom_body import (
        MushroomBodyConfig, compile_model as compile_mb)
    mb = compile_mb(MushroomBodyConfig(n_pn=20, n_lhi=5, n_kc=100, n_dn=20),
                    device=device, mesh=mesh)
    return {"izhikevich": (izh, ("exc",), 3.0),
            "mushroom_body": (mb, ("KC",), 1.5)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-model SNN serving gateway demo")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--steps", type=int, default=120,
                    help="stimulus length per request (dt steps)")
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--buckets", default="4,8",
                    help="comma-separated max_streams buckets")
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline (0 = none); tight values "
                         "exercise mid-flight eviction")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a check "
                         "without a card)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard over N ranks, one device each (0: the "
                         "single-device build; N > 1 under torchrun "
                         "--nproc-per-node N)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--http", default="",
                    help="host:port — serve the async HTTP front door "
                         "instead of the batch demo")
    ap.add_argument("--trace", default="", metavar="FILE",
                    help="write a Chrome trace_event JSON of build/serve "
                         "spans to FILE on exit")
    args = ap.parse_args(argv)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    gw = Gateway(chunk=args.chunk, buckets=buckets,
                 max_queue=args.max_queue)
    models = _demo_models(args.devices, args.device)
    for name, (model, stim_pops, _) in models.items():
        gw.register(name, model, stim_pops=stim_pops)
        print(f"[gateway] registered {name}: buckets={buckets} "
              f"chunk={args.chunk} max_queue={args.max_queue}")

    if args.http:
        from repro_torch.launch.gateway_http import serve_http
        host, _, port = args.http.rpartition(":")
        serve_http(gw, host or "127.0.0.1", int(port))
        return obs_profile.export_trace_cli(args.trace, "gateway")

    rng = np.random.default_rng(args.seed)
    names = sorted(models)
    reqs, rejected = [], 0
    for i in range(args.requests):
        name = names[i % len(names)]
        model, stim_pops, scale = models[name]
        pops = {p: model.network.populations[p].n for p in stim_pops}
        T = int(rng.integers(args.steps // 2, args.steps + 1))
        stim = {p: (scale * rng.normal(size=(T, n))).astype(np.float32)
                for p, n in pops.items()}
        try:
            reqs.append(gw.submit(name, stim, T, seed=1000 + i,
                                  priority=i % 3,
                                  deadline_ms=args.deadline_ms or None))
        except GatewayOverloaded as e:
            rejected += 1
            print(f"[gateway] request {i} rejected "
                  f"(retry in {e.retry_after_s:.2f}s)")
        if i % 8 == 7:          # burst pattern: let the queue drain a bit
            gw.tick()
    t0 = time.time()
    gw.run_until_drained()
    wall = time.time() - t0
    done = gw.collect_finished()
    completed = sum(1 for r in done if r.status == "done")
    evicted = sum(1 for r in done if r.evicted)
    print(f"[gateway] {completed} completed, {evicted} evicted, "
          f"{rejected} rejected in {wall:.2f}s")
    print(gw.render_metrics())
    return obs_profile.export_trace_cli(args.trace, "gateway")


if __name__ == "__main__":
    raise SystemExit(main())
