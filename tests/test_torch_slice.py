"""The port's main path against the JAX package: a small Izhikevich net
built, run and gScale-swept by both, with the graph and parameters carried
across by ``repro_torch.convert`` and the same numpy drive, and built from
its config and seed alone (the port's threefry keys give JAX's parameters
and thalamic draws).

The JAX side runs as its own tests run it on the CPU (jit, jnp reference
kernels).  Contract (ROADMAP parity contract): spike rasters agree on at
least 99.8% of neuron-steps.  XLA's CPU compiler and PyTorch's eager CPU ops
do not round the Izhikevich update the same way (the jitted scan contracts
multiply-adds; membrane V drifts apart by ~1e-3 mV over 100 steps), so V is
not held to exact equality; the rasters of these runs agree exactly all the
same, and the checks below would see a single flipped spike in the rates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conductance as JCOND  # noqa: E402
from repro.core.models import izhikevich_net as JIZ  # noqa: E402
from repro.core.snn import neurons as JN  # noqa: E402
from repro.core.snn import spec as JSPEC  # noqa: E402
from repro.core.snn import synapses as JSYN  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import conductance as TCOND  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.snn import neurons as TN  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.core.snn import synapses as TSYN  # noqa: E402
from repro_torch.kernels import ell_spmv as TK  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

T = 100
N_TOTAL, N_CONN, SEED = 200, 20, 7
N_EXC = 160
RASTER_AGREEMENT = 0.998

JAXPKG = dict(spec=JSPEC, neurons=JN, syn=JSYN, formats=JF, iz=JIZ)
PORT = dict(spec=TSPEC, neurons=TN, syn=TSYN, formats=TF, iz=TIZ)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _izh_spec(P, inh_representation="sparse"):
    """izhikevich_net's own spec, without the thalamic noise (these tests
    drive both packages with the same numpy stim), one group forced
    dense."""
    cfg = P["iz"].IzhikevichNetConfig(n_total=N_TOTAL, n_conn=N_CONN,
                                      representation="sparse", seed=SEED)
    ms = P["iz"].spec(cfg)
    for pop in ms.populations.values():
        pop.input_fn = None
    ms.synapses[1].representation = inh_representation
    return ms


def _variant_spec(P, variant):
    """The same net declared by hand, with per-synapse delays or STDP on
    the excitatory synapses."""
    F = P["formats"]
    ms = P["spec"].ModelSpec("variant")
    ms.add_neuron_population("exc", N_EXC, P["neurons"].IZHIKEVICH)
    ms.add_neuron_population("inh", N_TOTAL - N_EXC, P["neurons"].IZHIKEVICH)
    kw = ({"delay": F.UniformIntDelay(0, 5)} if variant == "delay"
          else {"wum": P["syn"].STDP(lr=0.01, g_max=0.5)})
    ms.add_synapse_population("exc", "exc", ["exc", "inh"],
                              connect=F.FixedFanout(N_CONN),
                              weight=F.UniformWeight(0.0, 0.5), **kw)
    ms.add_synapse_population("inh", "inh", ["exc", "inh"],
                              connect=F.FixedFanout(N_CONN),
                              weight=F.UniformWeight(0.0, -1.0))
    return ms


def _export(jm):
    """A JAX model's arrays as the numpy dict convert.load_arrays takes."""
    pops = {n: {"params": {k: np.asarray(v) for k, v in p.params.items()},
                "state": {k: np.full(p.n, v, np.float32)
                          for k, v in p.model.state.items()}}
            for n, p in jm.network.populations.items()}
    syn = {g.name: {"g": np.asarray(g.ell.g),
                    "post_ind": np.asarray(g.ell.post_ind),
                    "valid": np.asarray(g.ell.valid),
                    "delay": (None if g.ell.delay is None
                              else np.asarray(g.ell.delay)),
                    "dense": None if g.dense is None else np.asarray(g.dense),
                    "sign": g.sign, "representation": g.representation,
                    "delay_steps": g.delay_steps, "max_delay": g.max_delay}
           for g in jm.network.synapses}
    return {"populations": pops, "synapses": syn}


def _pair(jspec, tspec):
    """(JAX model with spike probes, port model carrying its arrays)."""
    jspec.probe("exc_spk", "exc", "spikes")
    jspec.probe("inh_spk", "inh", "spikes")
    jm = jspec.build(dt=1.0, seed=SEED)
    arrays = _export(jm)
    tm = convert.load_arrays(tspec.build(dt=1.0, seed=SEED, device="cpu"),
                             arrays)
    return jm, tm, arrays


def _stim():
    rng = np.random.default_rng(0)
    return {"exc": (5.0 * rng.standard_normal((T, N_EXC))).astype(np.float32),
            "inh": (2.0 * rng.standard_normal(
                (T, N_TOTAL - N_EXC))).astype(np.float32)}


def _assert_rasters_agree(jr, tr):
    n_spikes = 0
    for pop in ("exc", "inh"):
        a = np.asarray(jr.recordings[f"{pop}_spk"])
        b = tr.raster[pop].numpy()
        assert a.shape == b.shape == (T, N_EXC if pop == "exc"
                                      else N_TOTAL - N_EXC)
        assert (a == b).mean() >= RASTER_AGREEMENT, pop
        n_spikes += int(a.sum())
    assert bool(jr.finite) and bool(tr.finite)
    assert n_spikes > 0


@pytest.mark.parametrize("inh_rep", ["sparse", "dense"])
def test_izhikevich_run_matches_jax(inh_rep):
    jm, tm, arrays = _pair(_izh_spec(JAXPKG, inh_rep),
                           _izh_spec(PORT, inh_rep))
    # the host-built graphs are bit-identical before any conversion
    tm0 = _izh_spec(PORT, inh_rep).build(dt=1.0, seed=SEED, device="cpu")
    for g in tm0.network.synapses:
        a = arrays["synapses"][g.name]
        assert g.representation == a["representation"]
        np.testing.assert_array_equal(g.ell.post_ind.numpy(), a["post_ind"])
        np.testing.assert_array_equal(g.ell.g.numpy(), a["g"])
        np.testing.assert_array_equal(g.ell.valid.numpy(), a["valid"])
    assert [g.representation for g in tm.network.synapses] == [
        "sparse", "sparse", inh_rep, inh_rep]
    stim = _stim()
    jr = jm.run(T, stim=stim)
    tr = tm.run(T, stim=stim, record_raster=True,
                state=convert.init_state(tm, arrays))
    _assert_rasters_agree(jr, tr)
    for pop in ("exc", "inh"):
        assert abs(float(jr.rates_hz[pop]) - float(tr.rates_hz[pop])) <= \
            (1.0 - RASTER_AGREEMENT) * 1e3


@pytest.mark.parametrize("variant", ["delay", "stdp"])
def test_variants_match_jax(variant):
    jm, tm, _ = _pair(_variant_spec(JAXPKG, variant),
                      _variant_spec(PORT, variant))
    stim = _stim()
    jr = jm.run(T, stim=stim)
    tr = tm.run(T, stim=stim, record_raster=True)
    _assert_rasters_agree(jr, tr)
    if variant == "delay":
        assert tm.network.synapses[0].ring_slots == 6
        np.testing.assert_allclose(
            tr.state.syn["exc_exc"].dendritic[0].numpy(),
            np.asarray(jr.state.syn["exc_exc"].dendritic), rtol=2e-4,
            atol=2e-4)
    else:
        for name in ("exc_exc", "exc_inh"):
            jg = np.asarray(jr.state.syn[name].g)
            tg = tr.state.syn[name].g[0].numpy()
            assert np.mean(np.abs(jg - tg) <= 2e-4) >= RASTER_AGREEMENT


def _seeded_pair():
    """The cortical net built by both packages from its config and seed
    alone (thalamic drive on; no numpy-made params or stim), with spike
    probes on the JAX side."""
    kw = dict(n_total=N_TOTAL, n_conn=N_CONN, representation="sparse",
              seed=SEED)
    jspec = JIZ.spec(JIZ.IzhikevichNetConfig(**kw))
    jspec.probe("exc_spk", "exc", "spikes")
    jspec.probe("inh_spk", "inh", "spikes")
    jm = jspec.build(dt=1.0, seed=SEED)
    tm = TIZ.compile_model(TIZ.IzhikevichNetConfig(**kw), device="cpu")
    return jm, tm


def test_izhikevich_net_from_seed_alone_matches_jax():
    """The same seed gives the JAX package's per-neuron parameters bit for
    bit (threefry keys), its thalamic noise (within 4 ulp) and so its
    spikes: rasters agree on >= 99.8% of neuron-steps; the key and t after
    the run are equal."""
    jm, tm = _seeded_pair()
    for name in ("exc", "inh"):
        jp = jm.network.populations[name].params
        tp = tm.network.populations[name].params
        for k in "abcd":
            np.testing.assert_array_equal(tp[k].numpy().view(np.uint32),
                                          np.asarray(jp[k]).view(np.uint32))
    jr = jm.run(T)
    tr = tm.run(T, record_raster=True)
    _assert_rasters_agree(jr, tr)
    np.testing.assert_array_equal(
        tr.state.key[0].numpy().view(np.uint32),
        np.asarray(jax.random.key_data(jr.state.key)))
    assert float(tr.state.t) == float(jr.state.t) == float(T)


def test_sweep_from_seed_alone_matches_jax():
    """A sweep shares its key across candidates in both packages: the
    candidates' rates agree within the raster tolerance."""
    jm, tm = _seeded_pair()
    values = [0.5, 1.0, 2.0]
    js = jm.sweep_gscale("exc", values, T)
    ts = tm.sweep_gscale("exc", values, T)
    np.testing.assert_array_equal(ts.finite.numpy(), np.asarray(js.finite))
    for pop in ("exc", "inh"):
        np.testing.assert_allclose(ts.rates_hz[pop].numpy(),
                                   np.asarray(js.rates_hz[pop]),
                                   atol=(1.0 - RASTER_AGREEMENT) * 1e3)
    assert float(ts.rates_hz["exc"].min()) > 0


def _dc_drive(P):
    """A deterministic per-neuron DC input_fn (the sweep takes no stim)."""
    rng = np.random.default_rng(1)
    drive = {"exc": rng.uniform(0.0, 12.0, N_EXC).astype(np.float32),
             "inh": rng.uniform(0.0, 6.0, N_TOTAL - N_EXC).astype(np.float32)}
    if P is JAXPKG:
        return {k: (lambda key, t, n, d=v: jnp.asarray(d))
                for k, v in drive.items()}
    return {k: (lambda key, t, n, d=v: torch.tensor(d, device=key.device))
            for k, v in drive.items()}


def test_sweep_gscale_matches_jax_and_port_runs():
    specs = []
    for P in (JAXPKG, PORT):
        ms = _izh_spec(P)
        for name, fn in _dc_drive(P).items():
            ms.populations[name].input_fn = fn
        specs.append(ms)
    jm, tm, _ = _pair(*specs)
    values = [0.5, 1.0, 2.0, 4.0]
    js = jm.sweep_gscale("exc", values, T)
    ts = tm.sweep_gscale("exc", values, T)
    np.testing.assert_array_equal(ts.finite.numpy(), np.asarray(js.finite))
    for pop in ("exc", "inh"):
        np.testing.assert_allclose(ts.rates_hz[pop].numpy(),
                                   np.asarray(js.rates_hz[pop]),
                                   atol=(1.0 - RASTER_AGREEMENT) * 1e3)
        assert ts.spike_counts[pop].shape == (4, tm.network.populations[
            pop].n)
    # each candidate of the batched sweep is the single run at its gscale
    for i, v in enumerate(values):
        r = tm.run(T, gscales={"exc": v})
        assert torch.equal(r.spike_counts["exc"], ts.spike_counts["exc"][i])
    # the conductance search picks the same candidate from either sweep
    target = float(js.rates_hz["exc"][1])
    jpick = JCOND.search_sweep(lambda g: (js.rates_hz["exc"], js.finite),
                               jnp.asarray(values), target)
    tpick = TCOND.search_sweep(lambda g: (ts.rates_hz["exc"], ts.finite),
                               values, target)
    assert (tpick.gscale, tpick.finite, tpick.iters) == (
        jpick.gscale, jpick.finite, jpick.iters)
    assert tpick.rate_hz == pytest.approx(jpick.rate_hz,
                                          abs=(1 - RASTER_AGREEMENT) * 1e3)


def test_conductance_search_and_fit_match_jax():
    nconn = np.array([100, 200, 300, 500, 700, 1000], np.float64)
    g = 400.0 / (50.0 + nconn) + 0.3
    g_noisy = g * (1 + 0.01 * np.random.default_rng(2).standard_normal(6))
    for refine in (False, True):
        assert TCOND.fit_hyperbola(nconn, g_noisy, refine=refine) == \
            JCOND.fit_hyperbola(nconn, g_noisy, refine=refine)
    np.testing.assert_array_equal(TCOND.hyperbola(nconn, 1.0, 2.0, 3.0),
                                  JCOND.hyperbola(nconn, 1.0, 2.0, 3.0))
    assert TCOND.mape(g, g_noisy) == JCOND.mape(g, g_noisy)

    def rate(gs):                  # monotone, NaN above 3
        gs = float(gs)
        return 10.0 * gs, gs < 3.0
    for band in ((4.0, 6.0), (25.0, 26.0), (0.0, 0.1)):
        a = TCOND.search_bisect(rate, 0.0, 4.0, band)
        b = JCOND.search_bisect(rate, 0.0, 4.0, band)
        assert (a.gscale, a.rate_hz, a.finite, a.iters) == pytest.approx(
            (b.gscale, b.rate_hz, b.finite, b.iters))
    cands = np.array([0.5, 1.0, 2.0, 8.0], np.float32)
    fin = np.array([True, True, True, False])
    a = TCOND.search_sweep(lambda c: (c * 10.0, fin), cands, 75.0)
    b = JCOND.search_sweep(lambda c: (c * 10.0, jnp.asarray(fin)),
                           jnp.asarray(cands), 75.0)
    assert (a.gscale, a.rate_hz, a.finite) == (b.gscale, b.rate_hz, b.finite)


def test_port_model_surface():
    """Entry points, shapes, validation and the slice's declared limits."""
    tm = TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=100, n_conn=10),
                           device="cpu")
    assert tm.group_names == ["exc_exc", "exc_inh", "inh_exc", "inh_inh"]
    TK.reset_launches()
    r = tm.run(20, record_raster=True)
    assert r.raster["exc"].shape == (20, 80) and r.rates_hz["exc"].dim() == 0
    assert TK.launches == {"ell_spmv": 0, "ell_spmv_delay": 0}
    st, spk = tm.step(tm.init_state(2), gscales={"exc": [1.0, 2.0]})
    assert spk["inh"].shape == (2, 20) and st.finite.shape == (2,)
    with pytest.raises(TSPEC.SpecError):
        tm.run(5, gscales={"nope": 1.0})
    with pytest.raises(TSPEC.SpecError):
        tm.run(5, stim={"nope": np.zeros((5, 3))})
    ms = TSPEC.ModelSpec("x")
    ms.add_neuron_population("a", 4, "lif")
    # probes, custom updates, monitors (test_torch_probes,
    # test_torch_health) and on-device construction
    # (test_torch_device_init) are ported; a mesh is a launch.mesh.Mesh
    # (tests/test_torch_engine.py)
    ms.probe("p", "a", "V")
    ms.add_custom_update("u", "a", "V = V")
    assert ms.build(device="cpu", init="device").run(3).recordings[
        "p"].shape == (3, 4)
    with pytest.raises(TSPEC.SpecError, match="Mesh"):
        ms.build(device="cpu", mesh=object())
    with pytest.raises(TSPEC.SpecError, match="HealthConfig"):
        ms.build(device="cpu", monitor=object())
    assert ms.build(device="cpu").run(3).recordings["p"].shape == (3, 4)
    with pytest.raises(TSPEC.SpecError):
        ms.add_synapse_population("s", "a", "a", TF.FixedFanout(2),
                                  representation="dense",
                                  propagation="event")
