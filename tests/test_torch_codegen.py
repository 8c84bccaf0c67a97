"""repro_torch codegen: every built-in neuron model and synapse snippet
stepped against the JAX package's codegen on the same numpy inputs (``rand``
supplied from numpy), and the same snippets rejected.

Tolerance: state within 2e-4 and threshold decisions disagreeing on <0.2%
of neurons (the parity contract): both packages run the same float32
operations, but their exp/log implementations differ in the last ulp."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import codegen as JC  # noqa: E402
from repro.core.snn import neurons as JN  # noqa: E402
from repro.core.snn import synapses as JS  # noqa: E402
from repro_torch.core import codegen as TC  # noqa: E402
from repro_torch.core.snn import neurons as TN  # noqa: E402
from repro_torch.core.snn import synapses as TS  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
N = 512

# per-model initial-state ranges that exercise threshold, reset and the
# guarded rate functions
_RANGES = {
    "izhikevich": {"V": (-80.0, 35.0), "U": (-20.0, 5.0)},
    "lif": {"V": (-75.0, -45.0)},
    "rulkov_map": {"V": (-3.0, 70.0), "preV": (-3.0, 3.0)},
    "poisson": {"timeToSpike": (0.0, 1.0)},
}


def _state(model, rng):
    out = {}
    for k in model.state:
        lo, hi = _RANGES.get(model.name, {}).get(k, (-70.0, 20.0) if k == "V"
                                                 else (0.0, 1.0))
        out[k] = rng.uniform(lo, hi, N).astype(np.float32)
    return out


def _params(model, rng):
    # per-neuron arrays for half the params, scalars for the rest
    out = {}
    for i, (k, v) in enumerate(model.params.items()):
        out[k] = (np.float32(v) * rng.uniform(0.9, 1.1, N).astype(np.float32)
                  if i % 2 == 0 else float(v))
    return out


def _step_both(jmodel, tmodel, seed, dt=0.5, isyn_scale=5.0, n_steps=3):
    rng = np.random.default_rng(seed)
    st, params = _state(jmodel, rng), _params(jmodel, rng)
    ju, tu = JC.compile_sim(jmodel), TC.compile_sim(tmodel)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = {k: torch.tensor(v)[None] for k, v in st.items()}
    jp = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in params.items()}
    tp = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
          for k, v in params.items()}
    for i in range(n_steps):
        isyn = (isyn_scale * rng.standard_normal(N)).astype(np.float32)
        rand = rng.random(N).astype(np.float32)
        jext = {"Isyn": jnp.asarray(isyn), "dt": jnp.float32(dt),
                "t": jnp.float32(i * dt), "rand": jnp.asarray(rand)}
        text = {"Isyn": torch.tensor(isyn)[None],
                "dt": torch.tensor(dt, dtype=torch.float32),
                "t": torch.tensor(i * dt, dtype=torch.float32),
                "rand": torch.tensor(rand)}
        js, jspk = ju(js, jp, jext)
        ts, tspk = tu(ts, tp, text)
        for k in js:
            np.testing.assert_allclose(ts[k][0].numpy(), np.asarray(js[k]),
                                       **TOL, err_msg=f"{jmodel.name}.{k}")
        assert (tspk[0].numpy() != np.asarray(jspk)).mean() < 0.002
    return ts


@pytest.mark.parametrize("name", ["IZHIKEVICH", "TRAUBMILES_HH", "POISSON",
                                  "LIF", "RULKOV_MAP"])
def test_builtin_neuron_models_match_jax(name):
    _step_both(getattr(JN, name), getattr(TN, name), seed=len(name),
               dt=0.1 if name == "TRAUBMILES_HH" else 0.5)


def test_traubmiles_one_substep_matches_jax():
    _step_both(JN.make_traubmiles(1), TN.make_traubmiles(1), seed=3, dt=0.1)


def test_builtins_declared_identically():
    for name in ("IZHIKEVICH", "TRAUBMILES_HH", "POISSON", "LIF",
                 "RULKOV_MAP"):
        j, t = getattr(JN, name), getattr(TN, name)
        assert (j.name, dict(j.state), dict(j.params), j.sim_code,
                j.threshold_code, j.reset_code) == (
            t.name, dict(t.state), dict(t.params), t.sim_code,
            t.threshold_code, t.reset_code)


def test_batched_state_equals_each_member():
    upd = TC.compile_sim(TN.IZHIKEVICH)
    rng = np.random.default_rng(0)
    v = torch.tensor(rng.uniform(-80, 35, (3, 64)), dtype=torch.float32)
    u = torch.tensor(rng.uniform(-20, 5, (3, 64)), dtype=torch.float32)
    isyn = torch.tensor(rng.standard_normal((3, 64)), dtype=torch.float32)
    ext = {"Isyn": isyn, "dt": torch.tensor(1.0), "t": torch.tensor(0.0)}
    new, spk = upd({"V": v, "U": u}, dict(TN.IZHIKEVICH.params), ext)
    for b in range(3):
        nb, sb = upd({"V": v[b:b + 1], "U": u[b:b + 1]},
                     dict(TN.IZHIKEVICH.params),
                     {**ext, "Isyn": isyn[b:b + 1]})
        assert torch.equal(new["V"][b:b + 1], nb["V"])
        assert torch.equal(spk[b:b + 1], sb)


@pytest.mark.parametrize("name,args", [
    ("Pulse", ()), ("ExpDecay", (5.0,)), ("ExpCond", (4.0, -80.0)),
    ("Alpha", (3.0,)),
])
def test_postsynaptic_snippets_match_jax(name, args):
    jm, tm = getattr(JS, name)(*args), getattr(TS, name)(*args)
    jstep, tstep = JC.compile_postsynaptic(jm), TC.compile_postsynaptic(tm)
    rng = np.random.default_rng(len(name))
    st = {k: rng.random(N).astype(np.float32) for k in jm.state}
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = {k: torch.tensor(v)[None] for k, v in st.items()}
    for i in range(4):
        inj = rng.standard_normal(N).astype(np.float32)
        v = rng.uniform(-70, 0, N).astype(np.float32)
        js, jc = jstep(js, jm.params, {"inj": jnp.asarray(inj), "dt": 0.5,
                                       "t": jnp.float32(i),
                                       "V": jnp.asarray(v)})
        ts, tc = tstep(ts, tm.params, {"inj": torch.tensor(inj)[None],
                                       "dt": 0.5, "t": torch.tensor(float(i)),
                                       "V": torch.tensor(v)[None]})
        np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc), **TOL)
        for k in js:
            np.testing.assert_allclose(ts[k][0].numpy(), np.asarray(js[k]),
                                       **TOL)


def _wu_models(S, C):
    return [S.StaticPulse(), S.STDP(lr=0.01, g_max=0.8),
            C.WeightUpdateModel(name="atten", params={"lam": 4.0},
                                syn_state={"w": 0.5},
                                spike_code="g * w * exp(-delay / lam)",
                                learn_code="w = w * 0.99 + 0.01 * pre_spike")]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_weight_update_snippets_match_jax(which):
    jm, tm = _wu_models(JS, JC)[which], _wu_models(TS, TC)[which]
    jw, tw = JC.compile_weight_update(jm), TC.compile_weight_update(tm)
    rng = np.random.default_rng(which)
    n_pre, n_post, k = 20, 30, 6
    g = rng.random((n_pre, k)).astype(np.float32)
    syn = {n: np.full((n_pre, k), v, np.float32)
           for n, v in jm.syn_state.items()}
    delay = rng.integers(0, 5, (n_pre, k)).astype(np.float32)
    jext = {"dt": 0.5, "t": jnp.float32(1.0), "delay": jnp.asarray(delay)}
    text = {"dt": 0.5, "t": torch.tensor(1.0), "delay": torch.tensor(delay)}
    np.testing.assert_allclose(
        tw.effective_weight(torch.tensor(g),
                            {n: torch.tensor(v) for n, v in syn.items()},
                            tm.params, text).numpy(),
        np.asarray(jw.effective_weight(
            jnp.asarray(g), {n: jnp.asarray(v) for n, v in syn.items()},
            jm.params, jext)), **TOL)
    pre = (rng.random(n_pre) < 0.3).astype(np.float32)
    post = (rng.random(n_post) < 0.3).astype(np.float32)
    for attr, keys, spk_name, spk, n in (
            ("pre_step", jm.pre_state, "pre_spike", pre, n_pre),
            ("post_step", jm.post_state, "post_spike", post, n_post)):
        jf, tf = getattr(jw, attr), getattr(tw, attr)
        assert (jf is None) == (tf is None)
        if jf is None:
            continue
        st = {kk: rng.random(n).astype(np.float32) for kk in keys}
        a = jf({kk: jnp.asarray(v) for kk, v in st.items()}, jm.params,
               {**jext, spk_name: jnp.asarray(spk)})
        b = tf({kk: torch.tensor(v)[None] for kk, v in st.items()}, tm.params,
               {**text, spk_name: torch.tensor(spk)[None]})
        for kk in a:
            np.testing.assert_allclose(b[kk][0].numpy(), np.asarray(a[kk]),
                                       **TOL)
    assert (jw.learn is None) == (tw.learn is None)
    if jw.learn is not None:
        idx = rng.integers(0, n_post, (n_pre, k))
        traces = {"pre_spike": pre[:, None], "post_spike": post[idx]}
        traces.update({kk: rng.random((n_pre, 1)).astype(np.float32)
                       for kk in jm.pre_state})
        traces.update({kk: rng.random((n_pre, k)).astype(np.float32)
                       for kk in jm.post_state})
        jg, jsyn = jw.learn(jnp.asarray(g), {n: jnp.asarray(v)
                                             for n, v in syn.items()},
                            {kk: jnp.asarray(v) for kk, v in traces.items()},
                            jm.params, jext)
        tg, tsyn = tw.learn(torch.tensor(g)[None],
                            {n: torch.tensor(v)[None] for n, v in syn.items()},
                            {kk: torch.tensor(v)[None]
                             for kk, v in traces.items()}, tm.params, text)
        np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg), **TOL)
        for n in jsyn:
            np.testing.assert_allclose(tsyn[n][0].numpy(),
                                       np.asarray(jsyn[n]), **TOL)


def _simple(M, sim="V = V + dt*Isyn", thr="V >= 1.0", reset="V = 0.0"):
    return M.NeuronModel(name="m", state={"V": 0.0}, params={},
                         sim_code=sim, threshold_code=thr, reset_code=reset)


@pytest.mark.parametrize("bad", [
    "import os", "__import__('os')", "open('/etc/passwd')", "V.__class__",
    "[x for x in V]", "exec('1')", "V[0] = 1.0", "V = V + mystery",
    "V = lambda: 0",
])
def test_rejects_the_same_snippets(bad):
    for M in (JC, TC):
        with pytest.raises((M.CodegenError, SyntaxError)):
            M.compile_sim(_simple(M, sim=bad))


@pytest.mark.parametrize("build", [
    lambda M: M.NeuronModel(name="m", state={"Isyn": 0.0}, params={},
                            sim_code="Isyn = 1.0"),
    lambda M: M.NeuronModel(name="m", state={"a": 0.0}, params={"a": 1.0},
                            sim_code="a = a"),
    lambda M: M.compile_sim(M.NeuronModel(
        name="m", state={"V": 0.0}, params={}, sim_code="V = V",
        threshold_code="V > 1.0", reset_code="tmp = 1.0")),
    lambda M: M.PostsynapticModel(name="p", state={"inj": 0.0}),
    lambda M: M.WeightUpdateModel(name="w", params={"g": 1.0}),
    lambda M: M.compile_postsynaptic(M.PostsynapticModel(
        name="p", apply_code="inj.real")),
])
def test_reserved_and_invalid_declarations_rejected(build):
    for M in (JC, TC):
        with pytest.raises(M.CodegenError):
            build(M)


def test_bool_ops_needs_rand_and_generated_source():
    upd = TC.compile_sim(_simple(TC, sim="V = V + Isyn",
                                 thr="(V > 1.0) and not (V >= 3.0)",
                                 reset=""))
    _, spk = upd({"V": torch.tensor([[0.0, 1.5, 4.0]])}, {},
                 {"Isyn": torch.zeros(1, 3), "dt": torch.tensor(1.0),
                  "t": torch.tensor(0.0)})
    assert spk.tolist() == [[False, True, False]]
    assert TN.POISSON.needs_rand and not _simple(TC).needs_rand
    assert (TC.generated_source(_simple(TC))
            == JC.generated_source(_simple(JC)))
    assert TC.assigned_names("a = 1\nb += a") == {"a", "b"}
