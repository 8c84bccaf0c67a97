"""The port's serving gateway (``repro_torch.launch.gateway`` and its HTTP
front door) on the CPU: tests/test_gateway.py's host cases (select_streams,
deadlines, backpressure, priorities, elastic grow and shrink, several
models and their metrics, the HTTP front door, the soak smoke, the ring
cursor surviving a shrink and a grow), against the JAX package where the
two can serve the same traffic.

Contract: a stream that is not evicted equals the port's offline
``CompiledModel.run`` with its seed and stimulus bit for bit, however many
neighbours were evicted mid-flight and however often the slot table
resized around it; on a net driven by numpy stimulus alone (the
Izhikevich net with ``input_scale=0``) the port gateway's streams, their
statuses and its counters equal the JAX gateway's on the same traffic and
fake clock.  Deadline logic runs on an injected fake clock.
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.models import izhikevich_net as JIZ  # noqa: E402
from repro.launch import gateway as JGW  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.snn.spec import ModelSpec  # noqa: E402
from repro_torch.core.snn.synapses import ExpDecay  # noqa: E402
from repro_torch.launch import gateway as TGW  # noqa: E402
from repro_torch.launch.gateway import (  # noqa: E402
    Gateway, GatewayOverloaded, GatewayWorker, LatencyWindow)
from repro_torch.launch.gateway_http import GatewayHTTP  # noqa: E402
from repro_torch.sparse.formats import (FixedFanout, OneToOne,  # noqa: E402
                                        UniformIntDelay, UniformWeight)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def host_model():
    """tests/test_gateway.py's net (thalamic drive) on the CPU."""
    return TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=40, n_conn=6),
                             device="cpu")


@pytest.fixture(scope="module")
def stim_pair():
    """The same net without its random drive, in both packages."""
    cfg = dict(n_total=40, n_conn=6, input_scale=0.0)
    return (TIZ.compile_model(TIZ.IzhikevichNetConfig(**cfg), device="cpu"),
            JIZ.compile_model(JIZ.IzhikevichNetConfig(**cfg)))


def _stim(model, T: int, seed: int, scale: float = 3.0):
    n = model.network.populations["exc"].n
    rng = np.random.default_rng(seed)
    return {"exc": (scale * rng.normal(size=(T, n))).astype(np.float32)}


def _offline_counts(model, req):
    res = model.run(req.n_steps, stim=req.stim,
                    state=model.init_state(key=R.PRNGKey(req.seed)))
    return res.spike_counts


def _assert_bit_exact(model, reqs):
    for r in reqs:
        off = _offline_counts(model, r)
        for k, v in off.items():
            assert np.array_equal(v.numpy(), r.spike_counts[k]), (
                f"stream {r.rid} population {k!r} diverged from offline run")


def _assert_same_as_jax(port_reqs, jax_reqs):
    """Statuses, chunks served and spike counts equal, stream by stream."""
    assert [r.rid for r in port_reqs] == [r.rid for r in jax_reqs]
    for t, j in zip(port_reqs, jax_reqs):
        assert t.status == j.status and t.steps_served == j.steps_served, (
            t.rid, t.status, j.status)
        for k, v in j.spike_counts.items():
            assert np.array_equal(np.asarray(v), t.spike_counts[k]), (
                t.rid, k)


# ---------------------------------------------------------------------------
# select_streams: the gather under eviction and elastic resize
# ---------------------------------------------------------------------------

def _leaves(x, prefix=""):
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{prefix}.{k}")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{prefix}.{f.name}")


def _keys(*seeds):
    return torch.stack([R.PRNGKey(s) for s in seeds])


def test_select_streams_reorders_and_fresh_inits(host_model):
    st = host_model.init_stream_state(_keys(0, 1, 2, 3))
    st = host_model.serve_chunk(st, {}, np.array([3, 5, 2, 4], np.int32),
                                5)[0]                   # distinct states
    # shrink 4 -> 2 keeping slots [3, 1]
    small = host_model.select_streams(st, np.array([3, 1]), _keys(9, 9))
    for (name, a), (_, b) in zip(_leaves(small), _leaves(st)):
        assert a.shape[0] == 2, name
        assert torch.equal(a[0], b[3]) and torch.equal(a[1], b[1]), name
    # grow 2 -> 3: slot 2 fresh from its key, the others carried over
    big = host_model.select_streams(small, np.array([0, 1, -1]),
                                    _keys(0, 0, 42))
    fresh = host_model.init_state(key=R.PRNGKey(42))
    for (name, g), (_, s), (_, f) in zip(_leaves(big), _leaves(small),
                                         _leaves(fresh)):
        assert g.shape[0] == 3, name
        assert torch.equal(g[0], s[0]) and torch.equal(g[1], s[1]), name
        assert torch.equal(g[2], f[0]), name
    with pytest.raises(ValueError, match="past the state"):
        host_model.select_streams(small, np.array([0, 2]), _keys(0, 0))
    with pytest.raises(ValueError, match="rows for"):
        host_model.select_streams(small, np.array([0, 1]), _keys(0))


# ---------------------------------------------------------------------------
# lifecycle: completion, deadlines (queued + mid-flight), backpressure
# ---------------------------------------------------------------------------

def test_gateway_completes_streams_bit_exact(host_model):
    gw = Gateway(chunk=8, buckets=(2, 4), warm=False)
    gw.register("izh", host_model, stim_pops=("exc",))
    reqs = [gw.submit("izh", _stim(host_model, 20, i), 20, seed=100 + i)
            for i in range(6)]
    gw.run_until_drained()
    done = gw.collect_finished()
    assert len(done) == 6 and all(r.status == "done" for r in done)
    assert all(r.wait(0) for r in reqs)         # completion event fired
    assert all(r.steps_served == 20 for r in done)
    _assert_bit_exact(host_model, done)
    w = gw.workers["izh"]
    assert w.requests == {} and w.sched.timings == {}


def test_deadline_evicts_queued_request(host_model):
    """One slot, two requests: the queued one's deadline lapses before a
    slot frees, so it is evicted without ever running."""
    clk = FakeClock()
    gw = Gateway(chunk=4, buckets=(1,), clock=clk, warm=False)
    gw.register("izh", host_model, stim_pops=("exc",))
    a = gw.submit("izh", _stim(host_model, 16, 0), 16, seed=1)
    b = gw.submit("izh", _stim(host_model, 16, 1), 16, seed=2,
                  deadline_ms=50.0)
    gw.tick()                       # admits a; b queued (deadline t=0.05)
    clk.advance(1.0)
    gw.tick()                       # sweep evicts b before admission
    gw.run_until_drained()
    assert a.status == "done" and b.status == "evicted"
    assert b.steps_served == 0      # never admitted
    w = gw.workers["izh"]
    assert w.counters["evicted_queued"] == 1
    assert w.counters["evicted_active"] == 0
    _assert_bit_exact(host_model, [a])


def _mid_flight(gw_mod, model, clk):
    """tests/test_gateway.py's mid-flight scenario on either package."""
    gw = gw_mod.Gateway(chunk=5, buckets=(2,), clock=clk, warm=False)
    gw.register("izh", model, stim_pops=("exc",))
    doomed = gw.submit("izh", _stim(model, 20, 0, 6.0), 20, seed=11,
                       deadline_ms=100.0)
    survivor = gw.submit("izh", _stim(model, 20, 1, 6.0), 20, seed=12)
    gw.tick()                       # both admitted, one chunk served
    assert doomed.status == "active" and doomed.steps_served == 5
    clk.advance(1.0)                # past doomed's 0.1s deadline
    gw.tick()                       # boundary sweep: mid-flight eviction
    assert doomed.status == "evicted" and doomed.steps_served == 5
    assert gw.workers["izh"].counters["evicted_active"] == 1
    third = gw.submit("izh", _stim(model, 10, 2, 6.0), 10, seed=13)
    gw.run_until_drained()
    return gw, [doomed, survivor, third]


def test_deadline_evicts_mid_flight_and_survivors_stay_exact(stim_pair):
    """A mid-flight eviction reclaims the slot at the chunk boundary and
    keeps the chunks already streamed; the surviving neighbour and the
    stream admitted into the reclaimed slot stay exact, and every stream
    equals the JAX gateway's on the same traffic."""
    tm, jm = stim_pair
    gw, (doomed, survivor, third) = _mid_flight(TGW, tm, FakeClock())
    assert survivor.status == "done" and third.status == "done"
    assert sum(int(r.spike_counts["exc"].sum())
               for r in (survivor, third)) > 0
    _assert_bit_exact(tm, [survivor, third])
    # the evicted stream's streamed chunk equals the offline prefix
    res = tm.run(5, stim={"exc": doomed.stim["exc"][:5]},
                 state=tm.init_state(key=R.PRNGKey(doomed.seed)))
    for k, v in res.spike_counts.items():
        assert np.array_equal(v.numpy(), doomed.spike_counts[k])
    _, jreqs = _mid_flight(JGW, jm, FakeClock())
    _assert_same_as_jax([doomed, survivor, third], jreqs)


def test_backpressure_rejects_with_retry_after(host_model):
    gw = Gateway(chunk=4, buckets=(1,), max_queue=2, warm=False)
    gw.register("izh", host_model, stim_pops=("exc",))
    for i in range(2):              # fill the admission queue (never tick)
        gw.submit("izh", _stim(host_model, 8, i), 8, seed=i)
    with pytest.raises(GatewayOverloaded) as ei:
        gw.submit("izh", _stim(host_model, 8, 9), 8, seed=9)
    assert ei.value.model == "izh" and ei.value.queued == 2
    assert ei.value.retry_after_s > 0.0
    w = gw.workers["izh"]
    assert w.counters["rejected"] == 1
    gw.run_until_drained()          # the backlog still drains
    assert w.counters["completed"] == 2
    with pytest.raises(KeyError, match="unknown model"):
        gw.submit("nope", {}, 4)


def test_priority_classes_order_admission(host_model):
    gw = Gateway(chunk=4, buckets=(1,), warm=False)
    gw.register("izh", host_model, stim_pops=("exc",))
    rids = [gw.submit("izh", _stim(host_model, 4, i), 4, seed=i,
                      priority=p).rid
            for i, p in enumerate([1, 0, 1, 0])]
    w = gw.workers["izh"]
    assert [r.rid for r in w.sched.queue] == [rids[1], rids[3],
                                              rids[0], rids[2]]
    gw.run_until_drained()
    t = {r: w.sched.timings[r].admitted_at for r in rids}
    assert t[rids[1]] <= t[rids[3]] <= t[rids[0]] <= t[rids[2]]


# ---------------------------------------------------------------------------
# elastic capacity
# ---------------------------------------------------------------------------

def _grow_shrink(gw_mod, model):
    gw = gw_mod.Gateway(chunk=5, buckets=(2, 4), shrink_patience=1,
                        warm=False)
    gw.register("izh", model, stim_pops=("exc",))
    w = gw.workers["izh"]
    assert w.max_streams == 2
    short = [gw.submit("izh", _stim(model, 5, i, 6.0), 5, seed=40 + i)
             for i in range(3)]
    long = gw.submit("izh", _stim(model, 40, 9, 6.0), 40, seed=49)
    gw.tick()
    assert w.max_streams == 4 and w.counters["grows"] == 1
    gw.run_until_drained()          # shorts finish fast; long stream
    assert w.counters["shrinks"] >= 1       # table shrank under it
    assert w.max_streams == 2
    return w, short + [long]


def test_elastic_grow_and_shrink_keep_streams_exact(stim_pair):
    """Burst demand grows the slot table to a bigger bucket; when the
    backlog drains it shrinks back (after the patience), and streams alive
    across both stay exact, and equal to the JAX gateway's."""
    tm, jm = stim_pair
    w, reqs = _grow_shrink(TGW, tm)
    assert all(r.status == "done" for r in reqs)
    assert int(reqs[-1].spike_counts["exc"].sum()) > 0
    _assert_bit_exact(tm, reqs)
    jw, jreqs = _grow_shrink(JGW, jm)
    _assert_same_as_jax(reqs, jreqs)
    assert dict(w.counters) == dict(jw.counters)


# ---------------------------------------------------------------------------
# several models + observability
# ---------------------------------------------------------------------------

def test_multi_model_roundrobin_and_metrics(host_model):
    other = TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=24, n_conn=4,
                                                      seed=5), device="cpu")
    gw = Gateway(chunk=6, buckets=(2,), warm=False)
    gw.register("big", host_model, stim_pops=("exc",))
    gw.register("small", other, stim_pops=("exc",))
    with pytest.raises(ValueError, match="already registered"):
        gw.register("big", host_model, stim_pops=("exc",))
    for i in range(3):
        gw.submit("big", _stim(host_model, 12, i), 12, seed=i)
        gw.submit("small", _stim(other, 12, 50 + i), 12, seed=50 + i)
    gw.run_until_drained()
    done = gw.collect_finished()
    assert sorted(r.model for r in done) == ["big"] * 3 + ["small"] * 3
    for name, model in (("big", host_model), ("small", other)):
        _assert_bit_exact(model, [r for r in done if r.model == name])

    m = gw.metrics()
    assert set(m["models"]) == {"big", "small"}
    for wm in m["models"].values():
        assert wm["counters"]["completed"] == 3
        assert wm["counters"]["submitted"] == 3
        assert 0.0 < wm["occupancy"] <= 1.0
        assert wm["step_latency_us"]["p99"] >= wm["step_latency_us"]["p50"]
        assert wm["queue_wait_s"]["count"] == 3
    assert m["counters"]["completed"] == 6      # gateway-wide rollup

    text = gw.render_metrics()
    assert 'gateway_completed_total{model="big"} 3' in text
    assert 'gateway_slot_occupancy{model="small"}' in text
    assert 'quantile="99"' in text and "gateway_uptime_seconds" in text


def test_latency_window_is_bounded_and_percentiled():
    w = LatencyWindow(cap=100)
    assert w.summary() == {"count": 0, "p50": 0.0, "p99": 0.0,
                           "mean": 0.0, "max": 0.0}
    for i in range(1000):
        w.add(float(i))
    assert w.count == 1000                  # lifetime count survives
    assert len(w.samples()) == 100          # window stays bounded
    assert w.percentile(0.0) == 900.0       # oldest retained sample
    assert w.percentile(1.0) == 999.0
    assert w.summary()["max"] == 999.0


def test_worker_rejects_bad_config(host_model):
    with pytest.raises(ValueError, match="buckets"):
        GatewayWorker("x", host_model, buckets=(), stim_pops=("exc",),
                      warm=False)
    with pytest.raises(ValueError, match="max_queue"):
        GatewayWorker("x", host_model, buckets=(2,), max_queue=0,
                      stim_pops=("exc",), warm=False)


def test_warm_buckets_sets_up_every_bucket(host_model):
    """Warming runs every bucket's chunk once (the capture on a card) and
    the resize gathers, before any traffic."""
    sim = host_model.simulator
    gw = Gateway(chunk=3, buckets=(2, 3), warm=True)
    gw.register("izh", host_model, stim_pops=("exc",))
    keys = {k for k in sim._compiled if k[0] == "serve" and k[2] == 3}
    assert {k[1] for k in keys} >= {2, 3}
    r = gw.submit("izh", _stim(host_model, 7, 0), 7, seed=5)
    gw.run_until_drained()
    _assert_bit_exact(host_model, [r])


# ---------------------------------------------------------------------------
# HTTP front door (stdlib asyncio)
# ---------------------------------------------------------------------------

def test_http_front_door_end_to_end(host_model):
    n = host_model.network.populations["exc"].n

    async def scenario():
        gw = Gateway(chunk=6, buckets=(2,), warm=False)
        gw.register("izh", host_model, stim_pops=("exc",))
        srv = GatewayHTTP(gw, "127.0.0.1", 0, idle_sleep_s=0.001)
        host, port = await srv.start()

        async def http(method, path, body=None):
            reader, writer = await asyncio.open_connection(host, port)
            payload = b"" if body is None else json.dumps(body).encode()
            writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                          f"Content-Length: {len(payload)}\r\n\r\n")
                         .encode() + payload)
            await writer.drain()
            raw = await reader.read()
            writer.close()
            head, _, body_ = raw.partition(b"\r\n\r\n")
            return int(head.split()[1]), head, body_

        try:
            status, _, body = await http("GET", "/healthz")
            assert status == 200 and body.strip() == b"ok"

            stim = (0.5 * np.ones((12, n))).tolist()
            status, _, body = await http(
                "POST", "/v1/simulate",
                {"model": "izh", "n_steps": 12, "seed": 3,
                 "stim": {"exc": stim}})
            assert status == 200
            out = json.loads(body)
            assert out["status"] == "done" and out["steps_served"] == 12
            res = host_model.run(
                12, stim={"exc": np.asarray(stim, np.float32)},
                state=host_model.init_state(key=R.PRNGKey(3)))
            for k, v in res.spike_counts.items():
                assert v.tolist() == out["spike_counts"][k]
            assert out["total_s"] is not None

            status, _, body = await http(
                "POST", "/v1/simulate", {"model": "nope", "n_steps": 4})
            assert status == 400 and b"unknown model" in body
            status, _, _ = await http("GET", "/v1/simulate")
            assert status == 405
            status, _, _ = await http("GET", "/nope")
            assert status == 404
            status, _, body = await http("GET", "/metrics")
            assert status == 200
            assert b'gateway_completed_total{model="izh"} 1' in body
        finally:
            await srv.stop()

    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# soak smoke (benchmarks/gateway_soak_torch.py at pytest scale)
# ---------------------------------------------------------------------------

def test_soak_smoke_modest_scale():
    from benchmarks.gateway_soak_torch import run_soak

    row = run_soak(streams=36, n_total=24, n_conn=6, n_steps=12, chunk=6,
                   buckets=(4, 8), max_queue=8, burst=12, evict_every=6,
                   verify=True, warm=False, device="cpu")
    assert row["completed"] + row["evicted"] == 36
    assert row["evicted"] >= 36 // 6
    assert row["verified_streams"] == row["completed"]
    assert row["occupancy"] > 0.0
    assert row["p99_step_us"] > 0.0


# ---------------------------------------------------------------------------
# select_streams with per-synapse and homogeneous delays: each slot's ring
# and cursor survive shrink and grow re-packing
# ---------------------------------------------------------------------------

def _delay_model():
    s = ModelSpec("gw_delay")
    s.add_neuron_population(
        "a", 48, "izhikevich",
        input_fn=lambda k, t, n: R.normal(k, (n,), scale=6.0))
    s.add_neuron_population("b", 24, "izhikevich")
    s.add_synapse_population("ab", "a", "b", connect=FixedFanout(6),
                             weight=UniformWeight(0, 0.8),
                             psm=ExpDecay(4.0), delay=UniformIntDelay(0, 3))
    s.add_synapse_population("bb", "b", "b", connect=OneToOne(),
                             weight=0.2, delay_steps=2)
    return s.build(dt=1.0, seed=5, device="cpu")


def _serve1(model, st, chunk=6):
    left = np.full(st.batch, 100, np.int32)
    return model.serve_chunk(st, {}, left, chunk)[0]


def _slot_eq(a, slot_a, b, slot_b, what=""):
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x[slot_a], y[slot_b]), (what, name)


def test_ring_cursor_and_delay_state_survive_shrink_grow():
    """A stream with spikes parked in its dendritic ring is shrunk out of a
    4-slot table, served, and grown back beside a fresh slot: every state
    tensor, the ring and its cursor included, tracks an untouched 4-stream
    control bit for bit, and the fresh slot a lone stream of its own."""
    model = _delay_model()
    keys4 = _keys(0, 1, 2, 3)
    ctrl = _serve1(model, model.init_stream_state(keys4))
    st = _serve1(model, model.init_stream_state(keys4))
    assert bool(ctrl.syn["ab"].dendritic.any())

    st = model.select_streams(st, np.array([3, 1]), _keys(9, 9))
    for gname in ("ab", "bb"):
        for keep, src in ((0, 3), (1, 1)):
            assert torch.equal(st.syn[gname].dendritic[keep],
                               ctrl.syn[gname].dendritic[src]), gname
            assert torch.equal(st.syn[gname].cursor[keep],
                               ctrl.syn[gname].cursor[src])

    ctrl = _serve1(model, ctrl)
    st = _serve1(model, st)
    st = model.select_streams(st, np.array([0, 1, -1]), _keys(0, 0, 42))
    _slot_eq(st, 0, ctrl, 3, "slot 3 after shrink+serve")
    _slot_eq(st, 1, ctrl, 1, "slot 1 after shrink+serve")
    # the fresh slot starts at t = 0 with cursor 0 beside slots at 12:
    # unequal cursors in the fold from here on
    assert st.syn["ab"].cursor.tolist() == [12 % 4, 12 % 4, 0]

    ctrl = _serve1(model, ctrl)
    st = _serve1(model, st)
    _slot_eq(st, 0, ctrl, 3, "slot 3 after grow+serve")
    _slot_eq(st, 1, ctrl, 1, "slot 1 after grow+serve")
    fresh = _serve1(model, model.init_stream_state(_keys(42)))
    _slot_eq(st, 2, fresh, 0, "fresh slot vs solo serve")
