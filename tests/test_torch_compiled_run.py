"""The compiled step loop on the CPU: ``Simulator.run_compiled`` (the
chunked runner behind ``CompiledModel.run``, ``sweep_gscale`` and
``run_jit``) against the eager ``Simulator.run``.

On the CPU the runner runs its chunks eagerly over the same static buffers
that a card's CUDA graphs replay, so everything but ``torch.cuda.graph``
itself runs here; tests/test_torch_cuda.py holds a captured run to the
eager one on a card.  Contract: bit for bit (rasters, spike counts, every
state tensor: neurons, spikes, synapse state with the dendritic rings and
their cursors, t, key, finite), whatever the chunk length, with delays,
STDP, scalar and [B] gScales and stim; a runner serves new gScale and stim
values without a new set-up ("capture").
"""

import dataclasses
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.models import izhikevich_net as JIZ  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import conductance as TCOND  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.snn import graphs  # noqa: E402
from repro_torch.core.snn import neurons as TN  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.core.snn import synapses as TSYN  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

N_EXC, N_INH, N_CONN, SEED = 80, 20, 10, 3


def _exc(v):
    """A gScale for both excitatory groups (the Simulator's group names)."""
    return {"exc_exc": v, "exc_inh": v}


def _net(variant: str, device="cpu"):
    """A small Izhikevich net with the thalamic drive of izhikevich_net,
    and per-synapse delays 0..5 (6 ring slots), a homogeneous delay of 3
    steps or STDP on the excitatory synapses."""
    base = TIZ.spec(TIZ.IzhikevichNetConfig(n_total=N_EXC + N_INH,
                                            n_conn=N_CONN, seed=SEED))
    ms = TSPEC.ModelSpec(f"net_{variant}")
    for pop in base.populations.values():
        ms.add_neuron_population(pop.name, pop.n, pop.model, pop.params,
                                 pop.input_fn)
    kw = {"delay": {"delay": TF.UniformIntDelay(0, 5)},
          "homogeneous": {"delay_steps": 3},
          "stdp": {"wum": TSYN.STDP(lr=0.01, g_max=0.5)},
          "plain": {}}[variant]
    ms.add_synapse_population("exc", "exc", ["exc", "inh"],
                              connect=TF.FixedFanout(N_CONN),
                              weight=TF.UniformWeight(0.0, 0.5), **kw)
    ms.add_synapse_population("inh", "inh", ["exc", "inh"],
                              connect=TF.FixedFanout(N_CONN),
                              weight=TF.UniformWeight(0.0, -1.0))
    return ms.build(dt=1.0, seed=SEED, device=device)


def _leaves(x, prefix=""):
    """(name, tensor) of every tensor of a state, in a fixed order."""
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{prefix}.{k}")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{prefix}.{f.name}")


def assert_runs_equal(a, b):
    """Two RunResults bit for bit: rasters, counts and every state tensor
    (dtype, shape and bits, sign bits of zeros included)."""
    for name in a.spike_counts:
        assert torch.equal(a.spike_counts[name], b.spike_counts[name]), name
        if a.raster is not None:
            assert torch.equal(a.raster[name], b.raster[name]), name
    la, lb = dict(_leaves(a.state)), dict(_leaves(b.state))
    assert la.keys() == lb.keys()
    for k in la:
        x, y = la[k], lb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.is_floating_point():
            assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                               else x, y.view(torch.int32)
                               if y.dtype == torch.float32 else y), k
        else:
            assert torch.equal(x, y), k
    assert torch.equal(a.finite, b.finite)


def _stim(model, n_steps, batch=None, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, pop in model.network.populations.items():
        shape = ((n_steps, pop.n) if batch is None
                 else (n_steps, batch, pop.n))
        out[name] = torch.tensor(3.0 * rng.standard_normal(shape),
                                 dtype=torch.float32)
    return out


@pytest.mark.parametrize("variant", ["plain", "delay", "homogeneous",
                                     "stdp"])
@pytest.mark.parametrize("n_steps", [32, 45])
def test_chunked_run_equals_eager_run(monkeypatch, variant, n_steps):
    """Chunks of 8 steps: 32 is 4 whole chunks, 45 leaves a remainder of 5;
    the delay rings (6 and 4 slots) wrap several times."""
    monkeypatch.setattr(graphs, "CHUNK_STEPS", 8)
    model = _net(variant)
    sim = model.simulator
    stim = _stim(model, n_steps)
    for gs in (_exc(1.5), _exc(torch.tensor([0.5, 1.0, 2.0])), {}):
        batch = 3 if isinstance(gs.get("exc_exc"), torch.Tensor) else 1
        st = sim.init_state(batch)
        eager = sim.run(st, n_steps, gs, record_raster=True, stim=stim)
        comp = sim.run_compiled(st, n_steps, gs, record_raster=True,
                                stim=stim)
        assert_runs_equal(eager, comp)
        assert comp.state.t.tolist() == [float(n_steps)] * batch
        assert int(comp.spike_counts["exc"].sum()) > 0
        for g in model.network.synapses:
            if g.needs_ring:
                assert comp.state.syn[g.name].cursor.tolist() == (
                    [n_steps % g.ring_slots] * batch)
    # the caller's state is left as it was, and the result owns its tensors
    st = sim.init_state()
    before = {k: v.clone() for k, v in _leaves(st)}
    res = sim.run_compiled(st, n_steps)
    assert all(torch.equal(v, before[k]) for k, v in _leaves(st))
    runner = next(iter(sim._compiled.values()))
    assert all(v.data_ptr() != s.data_ptr() for (_, v), (_, s) in
               zip(_leaves(res.state), _leaves(runner.state)))


def test_one_runner_serves_new_gscales_and_stims(monkeypatch):
    """The stale-input hazard: two calls through one cache entry with other
    gScale values and other stims each equal their own eager runs, and the
    second call sets nothing up anew."""
    monkeypatch.setattr(graphs, "CHUNK_STEPS", 8)
    model = _net("delay")
    sim = model.simulator
    st = sim.init_state(2)
    for i, gs in enumerate(([0.5, 2.0], [1.25, 0.75])):
        gsd = {**_exc(torch.tensor(gs)), "inh_exc": 0.8 + 0.1 * i}
        stim = _stim(model, 20, batch=2, seed=i)
        comp = sim.run_compiled(st, 20, gsd, stim=stim)
        eager = sim.run(st, 20, gsd, stim=stim)
        assert_runs_equal(eager, comp)
        if i == 0:
            first = dict(sim.graph_counts)
    assert len(sim._compiled) == 1
    # chunks of 8 and the remainder 4: set up once, replayed 3 times a run
    assert first == {"captures": 2, "replays": 3}
    assert sim.graph_counts == {"captures": 2, "replays": 6}
    # another remainder replaces the old one: at most two per runner
    sim.run_compiled(st, 11, {**_exc(torch.tensor([1.0, 1.0])),
                              "inh_exc": 1.0}, stim=_stim(model, 11, batch=2))
    runner = next(iter(sim._compiled.values()))
    assert sorted(runner.graphs) == [3, 8]


def test_model_run_and_sweep_go_through_the_compiled_loop():
    model = _net("delay")
    sim = model.simulator
    r1 = model.run(40, gscales={"exc": 1.2}, record_raster=True)
    eager = sim.run(sim.init_state(), 40, _exc(1.2), record_raster=True)
    assert torch.equal(r1.raster["exc"], eager.raster["exc"][:, 0])
    assert r1.spike_counts["exc"].shape == (N_EXC,)
    values = [0.5, 1.0, 2.0]
    s = model.sweep_gscale("exc", values, 40)
    # every candidate starts from PRNGKey(seed), as the JAX sweep shares
    # its key: member i is the single run at its gScale
    for i, v in enumerate(values):
        one = model.run(40, gscales={"exc": v})
        assert torch.equal(one.spike_counts["exc"], s.spike_counts["exc"][i])
    keys = {k[:2] for k in sim._compiled}
    assert keys == {(1, ("exc_exc", "exc_inh")), (3, ("exc_exc", "exc_inh"))}


def test_run_jit_is_cached_per_steps_and_raster():
    model = _net("plain")
    sim = model.simulator
    f = sim.run_jit(20)
    assert sim.run_jit(20) is f and sim.run_jit(20, True) is not f
    st = sim.init_state(2)
    gs = _exc(torch.tensor([0.7, 1.4]))
    assert_runs_equal(sim.run(st, 20, gs), f(st, gs))
    r = sim.run_jit(20, True)(st)
    assert r.raster["exc"].shape == (20, 2, N_EXC)


def test_search_bisect_sets_up_once_per_group_and_steps():
    """A bisection over CompiledModel.run: one runner for the group, its
    chunk lengths set up once (captured once on a card), every candidate a
    copy into the gScale buffer; the host reads ``finite`` between runs."""
    model = _net("plain")
    sim = model.simulator
    seen = []

    def run_fn(gs):
        seen.append(gs)
        res = model.run(40, gscales={"exc": gs})
        return res.rates_hz["exc"], res.finite

    band = (1.0, 2.0)
    pick = TCOND.search_bisect(run_fn, 0.0, 4.0, band, max_iters=6)
    assert len(seen) == pick.iters >= 2
    assert len(sim._compiled) == 1
    # 40 steps = one chunk of 32 and a remainder of 8, each set up once
    assert sim.graph_counts == {"captures": 2, "replays": 2 * len(seen)}
    for gs in seen[:2]:
        eager = sim.run(sim.init_state(), 40, _exc(gs))
        again = model.run(40, gscales={"exc": gs})
        assert torch.equal(eager.spike_counts["exc"][0],
                           again.spike_counts["exc"])
    # another step count is another pair of chunk lengths on the same runner
    model.run(50, gscales={"exc": 1.0})
    assert len(sim._compiled) == 1 and sim.graph_counts["captures"] == 3


def test_init_state_takes_the_jax_state():
    """convert.init_state carries the JAX state's key, t and cursors: the
    port's next draws are the JAX package's."""
    cfg = JIZ.IzhikevichNetConfig(n_total=N_EXC + N_INH, n_conn=N_CONN,
                                  seed=SEED)
    jm = JIZ.compile_model(cfg)
    jr = jm.run(7)
    arrays = {"populations": {}, "synapses": {},
              "key": np.asarray(jax.random.key_data(jr.state.key)),
              "t": float(jr.state.t)}
    tm = TIZ.compile_model(TIZ.IzhikevichNetConfig(
        n_total=N_EXC + N_INH, n_conn=N_CONN, seed=SEED), device="cpu")
    st = convert.init_state(tm, arrays, batch=2)
    assert st.key.shape == (2, 2) and st.t.tolist() == [7.0, 7.0]
    np.testing.assert_array_equal(st.key[1].numpy().view(np.uint32),
                                  np.asarray(jax.random.key_data(
                                      jr.state.key)))
    # the port's own 7 steps reach the same key and t
    tr = tm.run(7)
    assert torch.equal(tr.state.key[0], st.key[0])
    assert float(tr.state.t) == float(jr.state.t)
    # a delayed group's cursor
    dm = _net("delay")
    arrays = {"populations": {}, "synapses": {"exc_exc": {"cursor": 4}}}
    st = convert.init_state(dm, arrays)
    assert st.syn["exc_exc"].cursor.dtype == torch.int32
    assert int(st.syn["exc_exc"].cursor) == 4
    with pytest.raises(ValueError):
        convert.init_state(dm, {"populations": {},
                                "synapses": {"inh_exc": {"cursor": 1}}})


def test_init_state_keys_and_batch():
    model = _net("plain")
    sim = model.simulator
    st = sim.init_state(3)
    assert st.key.dtype == torch.int32 and st.key.shape == (3, 2)
    assert st.t.dtype == torch.float32 and st.t.shape == (3,)
    keys = torch.tensor([[0, 1], [0, 2]], dtype=torch.int32)
    st2 = sim.init_state(2, keys)
    r = sim.run(st2, 5)
    assert not torch.equal(r.state.key[0], r.state.key[1])
    with pytest.raises(ValueError):
        sim.init_state(3, keys)
    with pytest.raises(ValueError):
        sim.run_compiled(sim.init_state(2), 5, {"nope": 1.0})
    # a state of another batch does not fit a runner's buffers
    sim.run_compiled(sim.init_state(2), 5)
    runner = next(iter(sim._compiled.values()))
    with pytest.raises(ValueError):
        runner.run(sim.init_state(3), 5, {}, {})


def test_a_state_buffer_returned_as_a_view_is_refused(monkeypatch):
    """A one-step chunk whose new U is a view of the static V cannot be
    stored (the copies would read a buffer already overwritten)."""
    model = _net("plain")
    sim = model.simulator
    real = sim.step

    def aliasing(state, gscales=None, stim=None):
        new, spk = real(state, gscales, stim)
        new.neurons["exc"]["U"] = state.neurons["exc"]["V"][:, :]
        return new, spk
    monkeypatch.setattr(sim, "step", aliasing)
    with pytest.raises(RuntimeError):
        sim.run_compiled(sim.init_state(), 1)


def test_population_rand_and_input_draw_per_member():
    """Each member draws from its own key: members that start from one key
    draw alike, members with other keys draw otherwise."""
    ms = TSPEC.ModelSpec("poisson")
    ms.add_neuron_population("p", 50, TN.POISSON, {"rate_hz": 200.0})
    model = ms.build(dt=1.0, seed=5, device="cpu")
    sim = model.simulator
    same = sim.run(sim.init_state(2), 30, record_raster=True)
    assert torch.equal(same.raster["p"][:, 0], same.raster["p"][:, 1])
    other = sim.run(sim.init_state(2, torch.tensor([[0, 5], [0, 6]],
                                                   dtype=torch.int32)), 30,
                    record_raster=True)
    assert torch.equal(other.raster["p"][:, 0], same.raster["p"][:, 0])
    assert not torch.equal(other.raster["p"][:, 0], other.raster["p"][:, 1])


def test_a_dropped_model_frees_its_runners_at_once():
    """Runners hold their Simulator weakly: dropping the model frees its
    static buffers (and on a card its graphs) without waiting for the
    cycle collector, which must not run while a capture is open."""
    model = _net("delay")
    model.run(5)
    ref = weakref.ref(next(iter(model.simulator._compiled.values())))
    assert ref() is not None
    del model
    assert ref() is None


# ---------------------------------------------------------------------------
# probes, scheduled custom updates and the health monitor in the chunks
# ---------------------------------------------------------------------------

def _observed_net(variant: str):
    """_net's variant with probes of every kind and schedule (a packed
    spike ring, strided and windowed rings that wrap inside a chunk,
    reductions over neurons and over a state-resident g), two scheduled
    custom updates (a population's and a group's that makes exc_exc's g
    state) and the health monitor."""
    from repro_torch.obs.health import HealthConfig
    base = TIZ.spec(TIZ.IzhikevichNetConfig(n_total=N_EXC + N_INH,
                                            n_conn=N_CONN, seed=SEED))
    ms = TSPEC.ModelSpec(f"observed_{variant}")
    for pop in base.populations.values():
        ms.add_neuron_population(pop.name, pop.n, pop.model, pop.params,
                                 pop.input_fn)
    kw = {"delay": {"delay": TF.UniformIntDelay(0, 5)},
          "stdp": {"wum": TSYN.STDP(lr=0.01, g_max=0.5)}}[variant]
    ms.add_synapse_population("exc", "exc", ["exc", "inh"],
                              connect=TF.FixedFanout(N_CONN),
                              weight=TF.UniformWeight(0.0, 0.5), **kw)
    ms.add_synapse_population("inh", "inh", ["exc", "inh"],
                              connect=TF.FixedFanout(N_CONN),
                              weight=TF.UniformWeight(0.0, -1.0),
                              psm=TSYN.ExpDecay(3.0))
    ms.probe("spk", "exc", "spikes")
    ms.probe("inh_spk", "inh", "spikes", every=10, window=2)
    ms.probe("v3", "exc", "V", every=3, window=4)
    ms.probe("vmean", "inh", "V", reduce="mean")
    ms.probe("gmax", "exc_exc", "g", reduce="max", every=5)
    ms.probe("insyn", "inh_exc", "in_syn", every=7)
    ms.add_custom_update("recenter", "inh", "V = V - 0.5 * (v_mean + 65.0)",
                         reduce={"v_mean": ("mean", "V")}, every=7)
    ms.add_custom_update("norm", "exc_exc",
                         "g = g * 4.0 / maximum(w_sum, 1e-9)",
                         reduce={"w_sum": ("sum", "g", "post")}, every=11)
    return ms.build(dt=1.0, seed=SEED, device="cpu",
                    monitor=HealthConfig(ema_tau_ms=10.0))


def assert_observations_equal(a, b):
    """Recordings (data and counts) and health reports bit for bit."""
    assert a.recordings.keys() == b.recordings.keys()
    for name in a.recordings.keys():
        x, y = a.recordings[name], b.recordings[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y), name
        assert torch.equal(a.recordings.count(name),
                           b.recordings.count(name)), name
    la, lb = dict(_leaves(a.health)), dict(_leaves(b.health))
    assert la.keys() == lb.keys() and la
    for k in la:
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("variant", ["delay", "stdp"])
@pytest.mark.parametrize("n_steps", [32, 45, 70])
def test_chunked_observed_run_equals_eager_run(variant, n_steps):
    """Chunks of 32 (one, one and a remainder of 13, two and 6): the
    recordings, counts, health report and state equal the eager run's bit
    for bit, from a fresh state and resumed mid-schedule, at B=1 and 2."""
    model = _observed_net(variant)
    sim = model.simulator
    assert model.network.synapses[0].mutable_g
    stim = _stim(model, n_steps)
    for batch, gs in ((1, {}), (2, _exc(torch.tensor([0.8, 1.3])))):
        st = sim.init_state(batch)
        eager = sim.run(st, n_steps, gs, stim=stim)
        comp = sim.run_compiled(st, n_steps, gs, stim=stim)
        assert_runs_equal(eager, comp)
        assert_observations_equal(eager, comp)
        assert int(comp.recordings["spk"].sum()) > 0
        assert comp.recordings["spk"].shape == (batch, n_steps, N_EXC)
        # resumed at global step 13: the schedules keep counting from it
        mid = sim.run(st, 13, gs, stim=_stim(model, 13, seed=1)).state
        eager = sim.run(mid, n_steps, gs, stim=stim)
        comp = sim.run_compiled(mid, n_steps, gs, stim=stim)
        assert_runs_equal(eager, comp)
        assert_observations_equal(eager, comp)
        assert int(comp.recordings.count("v3")[0]) == min(
            (13 + n_steps) // 3 - 13 // 3, 4)
        assert int(comp.health.steps[0]) == n_steps


def test_chunked_spike_probe_equals_the_raster_and_health_totals():
    """The packed spike ring through chunks unpacks to the raster bit for
    bit, and the monitor's totals are the summed counts."""
    model = _observed_net("delay")
    res = model.run(45, record_raster=True)
    assert torch.equal(res.recordings["spk"], res.raster["exc"])
    assert int(res.health.spike_total["exc"]) == int(
        res.spike_counts["exc"].sum())
    assert int(res.health.spike_total["inh"]) == int(
        res.spike_counts["inh"].sum())
    # a windowed spike ring of 2 rows: the last two samples (steps 30, 40)
    want = res.raster["inh"][[29, 39]]
    assert torch.equal(res.recordings["inh_spk"], want)
