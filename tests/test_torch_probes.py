"""Probes and custom updates in the port against the JAX package.

The single-device oracles of tests/test_probes.py, re-run on the port
(built on the CPU) and held to the JAX package on the same spec, seed and
numpy drive.  Tolerances (ROADMAP parity contract): spike probes and
sample counts bit for bit; state probes within rtol=atol=2e-4 on at least
99.8% of entries (XLA's jitted scan and PyTorch's eager ops round the
Izhikevich update differently, and a V on a spike's upstroke amplifies
that, as the contract's threshold allowance says); custom-update results
within 1e-5, and bit for bit with integer-valued weights.  Each probe is also held to the port's own eager
step loop or raster, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.models import izhikevich_net as JIZ  # noqa: E402
from repro.core.models import mushroom_body as JMB  # noqa: E402
from repro.core.snn import spec as JSPEC  # noqa: E402
from repro.core.snn import synapses as JSYN  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.models import mushroom_body as TMB  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.core.snn import synapses as TSYN  # noqa: E402
from repro_torch.kernels import ell_spmv as TK  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

JAXPKG = dict(spec=JSPEC, syn=JSYN, formats=JF)
PORT = dict(spec=TSPEC, syn=TSYN, formats=TF)
STATE_TOL = dict(rtol=2e-4, atol=2e-4)
AGREEMENT = 0.998
N_A, N_B = 30, 14


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(P, probes=(), custom=(), stdp=True):
    """tests/test_probes.py's net: two Izhikevich populations, an ExpDecay
    group and an STDP group (every state kind a probe can read), driven by
    numpy stim on "a" instead of a random input_fn."""
    F, S = P["formats"], P["syn"]
    s = P["spec"].ModelSpec("probe_net")
    s.add_neuron_population("a", N_A, "izhikevich")
    s.add_neuron_population("b", N_B, "izhikevich")
    s.add_synapse_population("ab", "a", "b", connect=F.FixedFanout(4),
                             weight=F.UniformWeight(0, 0.8),
                             psm=S.ExpDecay(4.0))
    if stdp:
        s.add_synapse_population("aa", "a", "a", connect=F.FixedFanout(5),
                                 weight=F.UniformWeight(0, 0.4),
                                 wum=S.STDP(0.01))
    for args, kw in probes:
        s.probe(*args, **kw)
    for args, kw in custom:
        s.add_custom_update(*args, **kw)
    return s


def _pair(probes=(), custom=(), stdp=True, seed=0):
    jm = _spec(JAXPKG, probes, custom, stdp).build(dt=1.0, seed=seed)
    tm = _spec(PORT, probes, custom, stdp).build(dt=1.0, seed=seed,
                                                 device="cpu")
    return jm, tm


def _stim(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": (6.0 * rng.standard_normal((n_steps, N_A))
                  ).astype(np.float32)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(b, a, name):
    """State samples within rtol=atol=2e-4 on >= 99.8% of entries (the
    parity contract's neuron tolerance and its threshold allowance: a V
    on a spike's upstroke amplifies the packages' rounding differences)."""
    close = np.isclose(b, a, **STATE_TOL)
    assert close.mean() >= AGREEMENT, (name, np.abs(b - a).max())


def _assert_recordings_match(jr, tr, names=None):
    """Spike probes and counts bit for bit, state probes within 2e-4."""
    for name in names or jr.recordings.keys():
        a, b = _np(jr.recordings[name]), _np(tr.recordings[name])
        assert a.shape == b.shape, name
        assert int(_np(jr.recordings.count(name))) == int(
            _np(tr.recordings.count(name))), name
        if a.dtype == bool:
            assert b.dtype == bool and np.array_equal(a, b), name
        else:
            _assert_close(b, a, name)


# ---------------------------------------------------------------------------
# probe semantics
# ---------------------------------------------------------------------------

def test_strided_probe_subsamples_the_full_probe():
    jm, tm = _pair(probes=[(("v1", "a", "V"), {}),
                           (("v3", "a", "V"), {"every": 3})], stdp=False)
    stim = _stim(10)
    r = tm.run(10, stim=stim)
    full, stri = r.recordings["v1"].numpy(), r.recordings["v3"].numpy()
    assert full.shape == (10, N_A) and stri.shape == (4, N_A)
    assert int(r.recordings.count("v1")) == 10
    assert int(r.recordings.count("v3")) == 3          # steps 3, 6, 9
    assert np.array_equal(stri[:3], full[2::3])
    assert not np.any(stri[3])                         # unfilled tail
    _assert_recordings_match(jm.run(10, stim=stim), r)


def test_spike_probe_reproduces_the_raster_oracle():
    jm, tm = _pair(probes=[(("spk_a", "a", "spikes"), {}),
                           (("spk_b", "b", "spikes"), {})], seed=1)
    stim = _stim(12, 1)
    r = tm.run(12, record_raster=True, stim=stim)
    for pop, probe in (("a", "spk_a"), ("b", "spk_b")):
        rec = r.recordings[probe]
        assert rec.dtype == torch.bool
        assert torch.equal(rec, r.raster[pop]), pop
    assert int(r.raster["a"].sum()) > 0
    _assert_recordings_match(jm.run(12, stim=stim), r)


def test_windowed_probe_keeps_last_samples_chronologically():
    jm, tm = _pair(probes=[(("v1", "a", "V"), {"every": 2}),
                           (("vw", "a", "V"), {"every": 2, "window": 3}),
                           (("vbig", "a", "V"), {"every": 2, "window": 9})],
                   stdp=False, seed=2)
    stim = _stim(14, 2)
    r = tm.run(14, stim=stim)                          # 7 samples
    full = r.recordings["v1"].numpy()
    wind = r.recordings["vw"].numpy()
    big = r.recordings["vbig"].numpy()
    assert wind.shape == (3, N_A) and int(r.recordings.count("vw")) == 3
    assert np.array_equal(wind, full[-3:])             # last 3, in order
    assert int(r.recordings.count("vbig")) == 7
    assert np.array_equal(big[:7], full) and not np.any(big[7:])
    _assert_recordings_match(jm.run(14, stim=stim), r)


def test_reduced_probes_match_the_full_probe():
    jm, tm = _pair(probes=[(("v1", "a", "V"), {}),
                           (("vmax", "a", "V"), {"reduce": "max"}),
                           (("vmin", "a", "V"), {"reduce": "min"}),
                           (("vmean", "a", "V"), {"reduce": "mean"}),
                           (("nspk", "a", "spikes"), {"reduce": "sum"})],
                   stdp=False, seed=3)
    stim = _stim(9, 3)
    r = tm.run(9, record_raster=True, stim=stim)
    full = r.recordings["v1"].numpy()
    assert np.array_equal(r.recordings["vmax"].numpy(), full.max(axis=1))
    assert np.array_equal(r.recordings["vmin"].numpy(), full.min(axis=1))
    np.testing.assert_allclose(r.recordings["vmean"].numpy(),
                               full.mean(axis=1), rtol=1e-6)
    assert np.array_equal(r.recordings["nspk"].numpy(),
                          r.raster["a"].numpy().sum(axis=1)
                          .astype(np.float32))
    _assert_recordings_match(jm.run(9, stim=stim), r)


def test_probe_every_state_kind_matches_eager_step_loop():
    """Which array and which step: the port's recordings equal its own
    step loop bit for bit, and the JAX package's within 2e-4."""
    jm, tm = _pair(probes=[(("bv", "b", "V"), {}),
                           (("insyn", "ab", "in_syn"), {}),
                           (("xpre", "aa", "x_pre"), {}),
                           (("xpost", "aa", "x_post"), {"every": 2}),
                           (("gmax", "aa", "g"), {"reduce": "max"}),
                           (("gmean", "aa", "g"), {"reduce": "mean"})],
                   seed=4)
    stim = _stim(8, 4)
    r = tm.run(8, stim=stim)
    st = tm.init_state()
    bv, insyn, xpre, gmax = [], [], [], []
    valid = tm.network.synapses[1].ell.valid
    for i in range(8):
        st, _ = tm.step(st, stim={"a": stim["a"][i]})
        bv.append(st.neurons["b"]["V"][0])
        insyn.append(st.syn["ab"].psm["in_syn"][0])
        xpre.append(st.syn["aa"].wu_pre["x_pre"][0])
        gmax.append(st.syn["aa"].g[0][valid].max())
    assert torch.equal(r.recordings["bv"], torch.stack(bv))
    assert torch.equal(r.recordings["insyn"], torch.stack(insyn))
    assert torch.equal(r.recordings["xpre"], torch.stack(xpre))
    assert torch.equal(r.recordings["gmax"], torch.stack(gmax))
    _assert_recordings_match(jm.run(8, stim=stim), r)


def test_run_resumed_from_state_keeps_global_schedule():
    """Two chained 5-step runs sample the steps one 10-step run does
    (round(t/dt) is the schedule), in both packages."""
    probes = [(("v3", "a", "V"), {"every": 3}),
              (("s4", "a", "spikes"), {"every": 4})]
    jm, tm = _pair(probes=probes, stdp=False, seed=5)
    stim = _stim(10, 5)
    whole = tm.run(10, stim=stim)
    first = tm.run(5, stim={"a": stim["a"][:5]})
    second = tm.run(5, state=first.state, stim={"a": stim["a"][5:]})
    for name, (ca_want, cb_want) in (("v3", (1, 2)), ("s4", (1, 1))):
        ca = int(first.recordings.count(name))
        cb = int(second.recordings.count(name))
        assert (ca, cb) == (ca_want, cb_want), name
        got = torch.cat([first.recordings[name][:ca],
                         second.recordings[name][:cb]])
        assert torch.equal(got, whole.recordings[name][:ca + cb]), name
    j1 = jm.run(5, stim={"a": stim["a"][:5]})
    j2 = jm.run(5, state=j1.state, stim={"a": stim["a"][5:]})
    _assert_recordings_match(j2, second)


def _poisson_spec(P, probes=()):
    """A Poisson population (uniform draws from the step's keys: the same
    bits in both packages) driving an Izhikevich one: a net that fires
    without stim, as a sweep runs."""
    F, S = P["formats"], P["syn"]
    s = P["spec"].ModelSpec("poisson_net")
    s.add_neuron_population("p", 30, "poisson", {"rate_hz": 300.0})
    s.add_neuron_population("b", N_B, "izhikevich")
    s.add_synapse_population("pb", "p", "b", connect=F.FixedFanout(6),
                             weight=F.UniformWeight(0, 8.0),
                             psm=S.ExpDecay(4.0))
    for args, kw in probes:
        s.probe(*args, **kw)
    return s


def test_sweep_recordings_per_candidate():
    probes = [(("bv", "b", "V"), {"every": 2}),
              (("vmean", "b", "V"), {"reduce": "mean"}),
              (("spk", "b", "spikes"), {}),
              (("pspk", "p", "spikes"), {"every": 3})]
    jm = _poisson_spec(JAXPKG, probes).build(dt=1.0, seed=7)
    tm = _poisson_spec(PORT, probes).build(dt=1.0, seed=7, device="cpu")
    vals = [0.5, 1.0, 2.0]
    js = jm.sweep_gscale("pb", vals, 9)
    ts = tm.sweep_gscale("pb", vals, 9)
    assert int(ts.recordings["spk"].sum()) > 0
    for name in ("bv", "vmean", "spk", "pspk"):
        a, b = _np(js.recordings[name]), _np(ts.recordings[name])
        assert a.shape == b.shape and b.shape[0] == 3, name
        assert _np(ts.recordings.count(name)).tolist() == \
            _np(js.recordings.count(name)).tolist()
        if a.dtype == bool:
            assert np.array_equal(a, b), name
        else:
            _assert_close(b, a, name)
    # candidate i is the single run at its gScale, bit for bit
    r1 = tm.run(9, gscales={"pb": 2.0})
    assert torch.equal(ts.recordings["bv"][2], r1.recordings["bv"])
    assert torch.equal(ts.recordings["spk"][2], r1.recordings["spk"])


# ---------------------------------------------------------------------------
# custom updates
# ---------------------------------------------------------------------------

_NORM = (("norm", "ab", "g = g * g_target / maximum(w_sum, 1e-9)"),
         {"params": {"g_target": 2.0},
          "reduce": {"w_sum": ("sum", "g", "post")}})


def _post_totals(model, gname, g):
    grp = next(x for x in model.network.synapses if x.name == gname)
    valid = _np(grp.ell.valid)
    post = _np(grp.ell.post_ind)
    tot = np.zeros(grp.ell.n_post, np.float64)
    np.add.at(tot, post[valid], np.asarray(g, np.float64)[valid])
    return tot, valid, post


def test_custom_update_normalization_matches_numpy_oracle():
    """Per-post totals renormalized to g_target: a float64 numpy oracle,
    and the JAX package's update from the same weights, within 1e-5."""
    jm, tm = _pair(custom=[_NORM], stdp=False, seed=10)
    assert tm.custom_update_names == ["norm"]
    assert tm.network.synapses[0].mutable_g
    assert tm.network.synapses[0].representation == "sparse"
    stim = _stim(5, 10)
    st = tm.run(5, stim=stim).state
    g0 = st.syn["ab"].g[0].numpy()
    st2 = tm.custom_update("norm", st)
    g1 = st2.syn["ab"].g[0].numpy()
    tot0, valid, post = _post_totals(tm, "ab", g0)
    expect = np.where(valid, g0 * 2.0 / np.maximum(tot0[post], 1e-9), g0)
    np.testing.assert_allclose(g1, expect, rtol=1e-5)
    tot1, _, _ = _post_totals(tm, "ab", g1)
    np.testing.assert_allclose(tot1, 2.0, rtol=1e-5)
    # the JAX package's update of the same weights
    jst = jm.init_state()
    jst.syn["ab"].g = jax.numpy.asarray(g0)
    jg = np.asarray(jm.custom_update("norm", jst).syn["ab"].g)
    np.testing.assert_allclose(g1, jg, rtol=1e-5, atol=1e-7)
    # the resumed dynamics stay finite
    assert bool(tm.run(6, state=st2, stim=_stim(6, 11)).finite)


def test_state_carried_from_jax_keeps_its_mutable_g():
    """convert.init_state takes a JAX state's V, U and state-resident g:
    both packages then normalize the same weights alike."""
    from repro_torch import convert
    jm, tm = _pair(custom=[_NORM], stdp=False, seed=16)
    js = jm.run(5, stim=_stim(5, 16)).state
    arrays = {"populations": {p: {"state": {k: np.asarray(v) for k, v in
                                            js.neurons[p].items()}}
                              for p in ("a", "b")},
              "synapses": {"ab": {"state": {"g": np.asarray(js.syn["ab"].g)}}}}
    ts = convert.init_state(tm, arrays, batch=2)
    assert ts.syn["ab"].g.shape == (2,) + tuple(js.syn["ab"].g.shape)
    np.testing.assert_array_equal(ts.syn["ab"].g[1].numpy(),
                                  np.asarray(js.syn["ab"].g))
    tg = tm.custom_update("norm", ts).syn["ab"].g
    jg = np.asarray(jm.custom_update("norm", js).syn["ab"].g)
    for b in range(2):
        np.testing.assert_allclose(tg[b].numpy(), jg, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="keeps no g"):
        _, plain = _pair(stdp=False, seed=16)
        convert.init_state(plain, {"populations": {}, "synapses": {
            "ab": {"state": {"g": np.asarray(js.syn["ab"].g)}}}})


def _int_weight_spec(P):
    """Integer-valued weights: every reduction is exact in any order."""
    F = P["formats"]
    s = P["spec"].ModelSpec("axes")
    s.add_neuron_population("a", 12, "izhikevich")
    s.add_neuron_population("b", 6, "izhikevich")
    s.add_synapse_population(
        "ab", "a", "b", connect=F.FixedFanout(3),
        weight=lambda r, sh: r.integers(1, 7, size=sh).astype(np.float32))
    s.add_custom_update(
        "combine", "ab",
        update_code=("g = g / maximum(col_max, 1.0) + 0.0 * (row_sum + "
                     "g_mean + col_sum + col_mean + row_min + g_max)"),
        reduce={"col_max": ("max", "g", "post"),
                "col_sum": ("sum", "g", "post"),
                "col_mean": ("mean", "g", "post"),
                "row_sum": ("sum", "g", "pre"),
                "row_min": ("min", "g", "pre"),
                "g_mean": ("mean", "g", "all"),
                "g_max": ("max", "g", "all")})
    return s


def test_custom_update_axes_and_ops_match_numpy_oracle():
    """post / pre / all reductions: a numpy oracle and the JAX package,
    bit for bit (integer weights)."""
    tm = _int_weight_spec(PORT).build(dt=1.0, seed=12, device="cpu")
    jm = _int_weight_spec(JAXPKG).build(dt=1.0, seed=12)
    st = tm.init_state()
    g0 = st.syn["ab"].g[0].numpy()
    TK.reset_launches()
    st2 = tm.custom_update("combine", st)
    assert TK.launches == {"ell_spmv": 0, "ell_spmv_delay": 0}  # CPU
    grp = tm.network.synapses[0]
    valid, post = grp.ell.valid.numpy(), grp.ell.post_ind.numpy()
    colmax = np.full(6, -np.inf, np.float32)
    np.maximum.at(colmax, post[valid], g0[valid])
    expect = np.where(valid, g0 / np.maximum(colmax[post], 1.0), g0)
    g1 = st2.syn["ab"].g[0].numpy()
    np.testing.assert_array_equal(g1, expect.astype(np.float32))
    jg = np.asarray(jm.custom_update("combine",
                                     jm.init_state()).syn["ab"].g)
    np.testing.assert_array_equal(g1, jg)
    assert bool(st2.finite)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("axis", ["post", "pre", "all"])
def test_group_reductions_equal_jax(op, axis):
    """Each (op, axis) on float weights, per member of a batch of 2 with
    different weights: within 1e-5 of the JAX package's host reduction."""
    from repro.core.snn import custom_updates as JCU
    from repro_torch.core.snn import custom_updates as TCU
    rng = np.random.default_rng(3)
    n_pre, k, n_post = 40, 6, 9
    post = rng.integers(0, n_post, (n_pre, k)).astype(np.int32)
    valid = rng.random((n_pre, k)) < 0.7
    g = rng.random((2, n_pre, k)).astype(np.float32)
    ell = TF.triple_to_ell(post, g[0], valid, n_post, device="cpu")
    jell = JF.triple_to_ell(post, g[0], valid, n_post)
    denom = float(valid.sum())
    got = TCU.group_reduce_host(op, torch.from_numpy(g), ell, axis, denom,
                                2)
    for b in range(2):
        want = np.asarray(JCU.group_reduce_host(
            op, jax.numpy.asarray(g[b]), jell, axis, denom))
        gb = got[b].numpy()
        np.testing.assert_allclose(np.broadcast_to(gb, np.broadcast_shapes(
            gb.shape, want.shape)), np.broadcast_to(want, np.broadcast_shapes(
                gb.shape, want.shape)), rtol=1e-5, atol=1e-6)


def test_population_custom_update_with_reduction():
    cu = (("recenter", "a", "V = V - (v_mean - c)"),
          {"reduce": {"v_mean": ("mean", "V")}})
    jm, tm = _pair(custom=[cu], stdp=False, seed=13)
    stim = _stim(3, 13)
    st = tm.run(3, stim=stim).state
    v0 = st.neurons["a"]["V"][0].numpy()
    st2 = tm.custom_update("recenter", st)
    v1 = st2.neurons["a"]["V"][0].numpy()
    c = float(tm.network.populations["a"].params["c"])
    np.testing.assert_allclose(v1, v0 - (v0.mean() - c), atol=1e-4)
    assert torch.equal(st.neurons["a"]["U"], st2.neurons["a"]["U"])
    jst = jm.run(3, stim=stim).state
    jv = np.asarray(jm.custom_update("recenter", jst).neurons["a"]["V"])
    _assert_close(v1, jv, "recenter")


def test_scheduled_custom_update_fires_on_global_schedule():
    """every=n fires after steps n, 2n, ...: seen through a V probe
    (sampled after the update), in both packages, and again from a
    resumed state."""
    cu = (("reset_v", "b", "V = -70.0"), {"every": 4})
    probes = [(("bv", "b", "V"), {})]
    jm, tm = _pair(probes=probes, custom=[cu], stdp=False, seed=14)
    stim = _stim(9, 14)
    r = tm.run(9, stim=stim)
    bv = r.recordings["bv"].numpy()
    assert np.all(bv[3] == -70.0) and np.all(bv[7] == -70.0)
    assert not np.all(bv[4] == -70.0)
    _assert_recordings_match(jm.run(9, stim=stim), r)
    # the eager loop and a resumed run fire on the same steps
    e = tm.simulator.run(tm.init_state(), 9, stim=stim)
    assert torch.equal(e.recordings["bv"][0], r.recordings["bv"])
    a = tm.run(6, stim={"a": stim["a"][:6]})
    b = tm.run(3, state=a.state, stim={"a": stim["a"][6:]})
    assert np.all(b.recordings["bv"][1].numpy() == -70.0)     # step 8


def test_custom_update_writes_trip_the_nan_guard():
    """A 0/0 reduction ratio trips ``finite`` when the update fires, even
    on the run's last step, and on demand."""
    cu = (("poison", "b", "V = V + (v_max - v_max) / (v_min - v_min)"),
          {"reduce": {"v_max": ("max", "V"), "v_min": ("min", "V")},
           "every": 4})
    jm, tm = _pair(custom=[cu], stdp=False, seed=17)
    for model in (jm, tm):
        assert bool(model.run(3).finite)
        assert not bool(model.run(4).finite)
        st = model.custom_update("poison", model.init_state())
        assert not bool(np.asarray(st.finite).all())


def test_group_update_nan_fold_counts_valid_slots_only():
    """A group update's NaN fold reads the valid slots only, and only
    when the update fires."""
    cu = (("blow", "ab", "g = (g - g) / (g - g)"), {"every": 3})
    _, tm = _pair(custom=[cu], stdp=False, seed=18)
    assert bool(tm.run(2).finite)
    r = tm.run(3)
    assert not bool(r.finite)
    g = r.state.syn["ab"].g[0]
    valid = tm.network.synapses[0].ell.valid
    assert torch.isnan(g[valid]).all() and not g[~valid].isnan().any()


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_probe_validation_errors():
    s = _spec(PORT)
    SpecError = TSPEC.SpecError
    with pytest.raises(SpecError, match="unknown target"):
        s.probe("p", "nope", "V")
    with pytest.raises(SpecError, match="every must be a positive int"):
        s.probe("p", "a", "V", every=0)
    with pytest.raises(SpecError, match="window must be a positive int"):
        s.probe("p", "a", "V", window=-1)
    with pytest.raises(SpecError, match="unknown reduce"):
        s.probe("p", "a", "V", reduce="median")
    s.probe("p", "a", "V")
    with pytest.raises(SpecError, match="duplicate probe name"):
        s.probe("p", "a", "U")
    with pytest.raises(SpecError, match="non-empty string"):
        s.probe("", "a", "V")

    def build(probes):
        return _spec(PORT, probes=probes).build(device="cpu")
    with pytest.raises(SpecError, match="no state variable 'W'"):
        build([(("q", "a", "W"), {})])
    with pytest.raises(SpecError, match="no state variable 'bogus'"):
        build([(("q", "ab", "bogus"), {})])
    with pytest.raises(SpecError, match="must declare reduce"):
        build([(("q", "aa", "g"), {})])
    with pytest.raises(SpecError, match="constant"):
        build([(("q", "ab", "g"), {"reduce": "max"})])


def test_probe_multi_post_target_names_concrete_groups():
    s = TSPEC.ModelSpec("mp")
    s.add_neuron_population("e", 10, "izhikevich")
    s.add_neuron_population("i", 5, "izhikevich")
    s.add_synapse_population("exc", "e", ["e", "i"],
                             connect=TF.FixedFanout(3), weight=0.1)
    with pytest.raises(TSPEC.SpecError, match="exc_e"):
        s.probe("p", "exc", "in_syn")
    s.probe("p", "exc_e", "in_syn")


def test_custom_update_validation_errors():
    SpecError = TSPEC.SpecError
    s = _spec(PORT)
    with pytest.raises(SpecError, match="unknown target"):
        s.add_custom_update("c", "nope", "g = g")
    with pytest.raises(SpecError, match="every must be a positive int"):
        s.add_custom_update("c", "ab", "g = g * 0.5", every=0)
    s.add_custom_update("c", "ab", "g = g * 0.5")
    with pytest.raises(SpecError, match="duplicate custom update"):
        s.add_custom_update("c", "ab", "g = g * 0.5")

    def build(custom):
        return _spec(PORT, custom=custom).build(device="cpu")
    with pytest.raises(SpecError, match="unknown reduction axis"):
        build([(("c", "ab", "g = g * s"),
                {"reduce": {"s": ("sum", "g", "diag")}})])
    with pytest.raises(SpecError, match="unknown reduction op"):
        build([(("c", "ab", "g = g * s"),
                {"reduce": {"s": ("median", "g", "post")}})])
    with pytest.raises(SpecError, match="unknown state variable"):
        build([(("c", "ab", "g = g * s"),
                {"reduce": {"s": ("sum", "w", "post")}})])
    with pytest.raises(SpecError, match="declared as \\(op, var\\)"):
        build([(("c", "a", "V = V - s"),
                {"reduce": {"s": ("sum", "V", "pop")}})])
    with pytest.raises(SpecError, match="no-op"):
        build([(("c", "ab", "tmp = g * 2.0"), {})])
    with pytest.raises(SpecError, match="shadows"):
        build([(("c", "a", "V = V - a"), {"params": {"a": 1.0}})])
    with pytest.raises(SpecError, match="reserved"):
        build([(("c", "a", "V = V - dt"), {"params": {"dt": 1.0}})])
    with pytest.raises(SpecError, match="non-whitelisted"):
        build([(("c", "ab", "g = eval(g)"), {})])
    with pytest.raises(SpecError, match="unknown custom update"):
        _spec(PORT).build(device="cpu").custom_update("nope")


def test_custom_update_dense_representation_conflict():
    s = TSPEC.ModelSpec("dense_conflict")
    s.add_neuron_population("a", 10, "izhikevich")
    s.add_neuron_population("b", 5, "izhikevich")
    s.add_synapse_population("ab", "a", "b", connect=TF.FixedFanout(3),
                             weight=0.1, representation="dense")
    s.add_custom_update("scale", "ab", "g = g * 0.5")
    with pytest.raises(TSPEC.SpecError, match="dense"):
        s.build(device="cpu")


def test_mutable_g_turns_an_auto_dense_group_sparse():
    """A group the representation choice would make dense (a small full
    matrix) takes the ELL path once a custom update writes its g, and
    propagates what the dense group propagates."""
    def spec(custom):
        s = TSPEC.ModelSpec("auto_dense")
        s.add_neuron_population("a", 8, "izhikevich")
        s.add_neuron_population("b", 6, "izhikevich")
        s.add_synapse_population("ab", "a", "b", connect=TF.FixedFanout(6),
                                 weight=TF.UniformWeight(5.0, 15.0))
        if custom:
            s.add_custom_update("scale", "ab", "g = g * 1.0")
        return s.build(dt=1.0, seed=0, device="cpu")
    dense, mut = spec(False), spec(True)
    assert dense.network.synapses[0].representation == "dense"
    assert mut.network.synapses[0].representation == "sparse"
    stim = {"a": np.full((20, 8), 12.0, np.float32)}
    a, b = dense.run(20, stim=stim), mut.run(20, stim=stim)
    assert torch.equal(a.spike_counts["b"], b.spike_counts["b"])
    assert int(a.spike_counts["b"].sum()) > 0


# ---------------------------------------------------------------------------
# memory report
# ---------------------------------------------------------------------------

def test_memory_report_covers_runtime_state():
    s = _spec(PORT, probes=[(("av", "a", "V"), {"every": 2}),
                            (("vm", "a", "V"), {"reduce": "max",
                                                "window": 8})],
              custom=[_NORM])
    s.add_synapse_population("abd", "a", "b", connect=TF.FixedFanout(3),
                             weight=0.1, delay_steps=4)
    model = s.build(dt=1.0, seed=15, device="cpu")
    rep = model.memory_report(n_steps=100, max_streams=6)
    by_name = {r["name"]: r for r in rep}
    delayed = by_name["abd"]
    assert delayed["dendritic_ring_elements"] == 5 * N_B
    assert delayed["state_elements"] >= 5 * N_B
    assert by_name["a"]["kind"] == "population"
    assert by_name["a"]["state_elements"] >= 3 * N_A
    assert by_name["av"]["buffer_elements"] == 50 * N_A
    assert by_name["vm"]["buffer_elements"] == 8
    assert by_name["norm"]["kind"] == "custom_update"
    streams = by_name["streams"]
    assert streams["stream_state_elements"] == \
        6 * streams["state_elements_per_stream"]
    # the same numbers as the JAX package's report
    js = _spec(JAXPKG, probes=[(("av", "a", "V"), {"every": 2}),
                               (("vm", "a", "V"), {"reduce": "max",
                                                   "window": 8})],
               custom=[_NORM])
    js.add_synapse_population("abd", "a", "b", connect=JF.FixedFanout(3),
                              weight=0.1, delay_steps=4)
    jrep = {r["name"]: r for r in js.build(dt=1.0, seed=15).memory_report(
        n_steps=100, max_streams=6)}
    keys = ("state_elements", "sparse_elements", "dense_elements",
            "dendritic_ring_elements", "representation", "buffer_elements",
            "buffer_bytes", "bytes_per_sample", "is_packed",
            "stream_state_elements", "n_reductions", "propagation",
            "propagation_mode", "event_capacity")
    for name, r in by_name.items():
        for k in keys:
            if k in jrep[name]:
                assert r[k] == jrep[name][k], (name, k)


def test_memory_report_probe_bytes_match_allocated_rings():
    """Each probe's buffer_bytes is what the run allocates for one
    member: spike rings as int32 words, 32x under bool [cap, n]."""
    model = _spec(PORT, probes=[
        (("raster", "a", "spikes"), {}),
        (("rate", "a", "spikes"), {"reduce": "sum"}),
        (("vm", "a", "V"), {"every": 3, "window": 2}),
        (("tr", "aa", "x_pre"), {"every": 5}),
    ]).build(dt=1.0, seed=0, device="cpu")
    n_steps = 24
    rings, _ = model.simulator._probe_init(n_steps, 1)
    by_name = {r["name"]: r for r in model.memory_report(n_steps=n_steps)
               if r["kind"] == "probe"}
    assert set(by_name) == set(rings)
    for name, ring in rings.items():
        entry = by_name[name]
        assert entry["buffer_bytes"] == ring.numel() * ring.element_size()
        assert entry["is_packed"] == (ring.dtype == torch.int32), name
    assert by_name["raster"]["buffer_bytes"] == 24 * 4
    assert by_name["rate"]["buffer_bytes"] == 24 * 4
    assert by_name["vm"]["buffer_bytes"] == 2 * N_A * 4
    s = _spec(PORT, probes=[(("vm", "a", "V"), {"window": 5}),
                            (("raster", "a", "spikes"), {})], stdp=False)
    by_name = {r["name"]: r for r in s.build(device="cpu").memory_report()
               if r["kind"] == "probe"}
    assert by_name["vm"]["buffer_bytes"] == 5 * N_A * 4
    assert "buffer_bytes" not in by_name["raster"]
    assert by_name["raster"]["bytes_per_sample"] == 4 * ((N_A + 31) // 32)


@pytest.mark.parametrize("order", ["spikes_first", "spikes_last"])
def test_record_raster_collides_with_probe_named_spikes(order):
    probes = [(("spikes", "a", "spikes"), {}), (("vm", "a", "V"), {})]
    if order == "spikes_last":
        probes.reverse()
    model = _spec(PORT, probes=probes, stdp=False).build(dt=1.0, seed=0,
                                                         device="cpu")
    with pytest.raises(TSPEC.SpecError, match="record_raster.*spikes"):
        model.run(5, record_raster=True)
    assert model.run(5).recordings["spikes"].shape == (5, N_A)


def test_record_raster_beside_other_spike_probes():
    model = _spec(PORT, probes=[(("spk_a", "a", "spikes"), {}),
                                (("spk_b", "b", "spikes"), {})],
                  stdp=False).build(dt=1.0, seed=0, device="cpu")
    r = model.run(5, record_raster=True, stim=_stim(5))
    assert torch.equal(r.raster["a"], r.recordings["spk_a"])


# ---------------------------------------------------------------------------
# the models' options
# ---------------------------------------------------------------------------

def test_izhikevich_probe_v_every_matches_jax():
    kw = dict(n_total=100, n_conn=10, seed=3, probe_v_every=4)
    jm = JIZ.compile_model(JIZ.IzhikevichNetConfig(**kw))
    tm = TIZ.compile_model(TIZ.IzhikevichNetConfig(**kw), device="cpu")
    for model in (jm, tm):
        for pop in model.network.populations.values():
            pop.input_fn = None
    rng = np.random.default_rng(0)
    stim = {"exc": (5.0 * rng.standard_normal((40, 80))).astype(np.float32),
            "inh": (2.0 * rng.standard_normal((40, 20))).astype(np.float32)}
    jr, tr = jm.run(40, stim=stim), tm.run(40, stim=stim)
    assert tr.recordings["exc_v"].shape == (10, 80)
    _assert_recordings_match(jr, tr)


def test_mushroom_body_probe_and_normalization_match_jax():
    kw = dict(n_pn=16, n_lhi=4, n_kc=64, n_dn=12, seed=5, kc_probe_every=5,
              kc_dn_normalize=True)
    jm = JMB.compile_model(JMB.MushroomBodyConfig(**kw))
    tm = TMB.compile_model(TMB.MushroomBodyConfig(**kw), device="cpu")
    kc_dn = next(g for g in tm.network.synapses if g.name == "KC_DN")
    assert kc_dn.mutable_g and kc_dn.representation == "sparse"
    assert tm.custom_update_names == ["normalize_kc_dn"]
    st = tm.init_state()
    g0 = st.syn["KC_DN"].g[0].numpy()
    st2 = tm.custom_update("normalize_kc_dn", st)
    tot, _, _ = _post_totals(tm, "KC_DN", st2.syn["KC_DN"].g[0].numpy())
    np.testing.assert_allclose(tot, 64 * 0.02 / 2.0, rtol=1e-5)
    jst = jm.init_state()
    np.testing.assert_array_equal(np.asarray(jst.syn["KC_DN"].g), g0)
    jg = np.asarray(jm.custom_update("normalize_kc_dn", jst).syn["KC_DN"].g)
    np.testing.assert_allclose(st2.syn["KC_DN"].g[0].numpy(), jg,
                               rtol=1e-5, atol=1e-9)
    r = tm.run(50)
    assert r.recordings["kc_v"].shape == (10, 64)
    assert int(r.recordings.count("kc_v")) == 10 and bool(r.finite)
