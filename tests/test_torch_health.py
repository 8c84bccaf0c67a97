"""The health monitor in the port (``repro_torch.obs.health``) against the
JAX package's (``repro.obs.health``), on the CPU.

Contract: spike totals, step counts, ``nonfinite`` and ``first_bad_step``
exact; rate EMAs and mean rates within 1e-6 relative; silent / saturated
flags equal; a numpy oracle of the EMA fold; the NaN guard tripping on the
conductance blow-up at the same step as the JAX monitor.  A monitor-off
build runs the same aten ops as an unmonitored one (counted with a
``TorchDispatchMode``: the port's form of the JAX package's "identical
jaxpr"), and declaring probes changes nothing a step runs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core.models import izhikevich_net as JIZ  # noqa: E402
from repro.core.models import mushroom_body as JMB  # noqa: E402
from repro.obs import health as JHE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.models import mushroom_body as TMB  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.obs import health as THE  # noqa: E402
from repro_torch.obs.health import HealthConfig  # noqa: E402

EMA_RTOL = 1e-6
IZH = dict(n_total=60, n_conn=10, seed=2)
MB_SMALL = dict(n_pn=16, n_lhi=4, n_kc=64, n_dn=12, seed=5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _izh_pair(monitor):
    jm = JIZ.compile_model(JIZ.IzhikevichNetConfig(**IZH),
                           monitor=JHE.HealthConfig(**monitor))
    tm = TIZ.compile_model(TIZ.IzhikevichNetConfig(**IZH), device="cpu",
                           monitor=HealthConfig(**monitor))
    for model in (jm, tm):
        for pop in model.network.populations.values():
            pop.input_fn = None
    return jm, tm


def _izh_stim(T, seed=0):
    rng = np.random.default_rng(seed)
    return {"exc": (6.0 * rng.standard_normal((T, 48))).astype(np.float32),
            "inh": (3.0 * rng.standard_normal((T, 12))).astype(np.float32)}


def assert_reports_equal(jrep, trep):
    """Totals and the guard exactly, EMAs and mean rates within 1e-6."""
    for p in jrep.spike_total:
        assert int(trep.spike_total[p]) == int(jrep.spike_total[p]), p
        np.testing.assert_allclose(float(trep.rate_ema_hz[p]),
                                   float(jrep.rate_ema_hz[p]),
                                   rtol=EMA_RTOL, atol=1e-30)
        np.testing.assert_allclose(float(trep.mean_rate_hz[p]),
                                   float(jrep.mean_rate_hz[p]),
                                   rtol=EMA_RTOL, atol=1e-30)
        assert bool(trep.silent[p]) == bool(jrep.silent[p]), p
        assert bool(trep.saturated[p]) == bool(jrep.saturated[p]), p
    assert int(trep.steps) == int(jrep.steps)
    assert bool(trep.nonfinite) == bool(jrep.nonfinite)
    assert int(trep.first_bad_step) == int(jrep.first_bad_step)


def test_health_report_matches_jax_and_numpy_oracle():
    jm, tm = _izh_pair({})
    T = 40
    stim = _izh_stim(T)
    tr = tm.run(T, record_raster=True, stim=stim)
    jr = jm.run(T, stim=stim)
    assert_reports_equal(jr.health, tr.health)
    mon, rep = tm.monitor, tr.health
    alpha = np.float32(mon.alpha(1.0))
    for pop in ("exc", "inh"):
        n = tm.network.populations[pop].n
        per_step = tr.raster[pop].numpy().sum(axis=1).astype(np.int64)
        assert int(rep.spike_total[pop]) == int(per_step.sum())
        inv = np.float32(1.0 / (n * 1.0 * 1e-3))
        ema = np.float32(0.0)
        for c in per_step:
            ema = ema + alpha * (np.float32(c) * inv - ema)
        np.testing.assert_allclose(float(rep.rate_ema_hz[pop]), ema,
                                   rtol=1e-5, atol=1e-6)
        lo, hi = mon.band(pop)
        assert bool(rep.silent[pop]) == (float(ema) < lo)
        assert bool(rep.saturated[pop]) == (float(ema) > hi)
    assert int(per_step.sum()) >= 0 and int(rep.steps) == T
    assert int(rep.first_bad_step) == -1 and not bool(rep.nonfinite)
    assert rep.summary()["populations"]["exc"]["spikes"] == int(
        rep.spike_total["exc"])


def test_bands_and_no_nan_guard_match_jax():
    mon = dict(ema_tau_ms=5.0, bands_hz={"exc": (0.5, 2.0)},
               default_band_hz=None, nan_guard=False)
    jm, tm = _izh_pair(mon)
    stim = _izh_stim(30, 1)
    jr, tr = jm.run(30, stim=stim), tm.run(30, stim=stim)
    assert_reports_equal(jr.health, tr.health)
    assert not bool(tr.health.silent["inh"])       # no band: never flagged


def test_unmonitored_run_has_no_health():
    tm = TIZ.compile_model(TIZ.IzhikevichNetConfig(**IZH), device="cpu")
    assert tm.monitor is None and tm.run(5).health is None
    off = TIZ.compile_model(TIZ.IzhikevichNetConfig(**IZH), device="cpu",
                            monitor=HealthConfig(enabled=False))
    assert off.monitor is None and off.run(5).health is None


def test_nan_guard_trips_on_conductance_blowup():
    """PN->KC over-scaled past the explicit-coupling bound (the paper's
    float overflow): the monitor trips at the JAX monitor's step."""
    jm = JMB.compile_model(JMB.MushroomBodyConfig(**MB_SMALL),
                           monitor=JHE.HealthConfig())
    tm = TMB.compile_model(TMB.MushroomBodyConfig(**MB_SMALL), device="cpu",
                           monitor=HealthConfig())
    T = 300
    jr = jm.run(T, gscales={"PN_KC": jnp.float32(500.0)})
    tr = tm.run(T, gscales={"PN_KC": 500.0})
    rep = tr.health
    assert bool(rep.nonfinite) and not bool(tr.finite)
    assert 0 <= int(rep.first_bad_step) < T
    assert int(rep.first_bad_step) == int(jr.health.first_bad_step)
    assert int(rep.steps) == T
    for p in ("PN", "LHI"):
        assert int(rep.spike_total[p]) == int(jr.health.spike_total[p]), p


def test_silent_population_is_flagged():
    cfg = dict(MB_SMALL, g_pn_kc=1e-6)
    mon = dict(ema_tau_ms=5.0)
    jm = JMB.compile_model(JMB.MushroomBodyConfig(**cfg),
                           monitor=JHE.HealthConfig(**mon))
    tm = TMB.compile_model(TMB.MushroomBodyConfig(**cfg), device="cpu",
                           monitor=HealthConfig(**mon))
    jr, tr = jm.run(60), tm.run(60)
    assert bool(tr.health.silent["KC"]) and not bool(tr.health.silent["PN"])
    assert not bool(tr.health.nonfinite)
    assert_reports_equal(jr.health, tr.health)


def test_batched_members_report_their_own_health():
    """A batch of gScales: each member's report equals its single run."""
    _, tm = _izh_pair({})
    sim = tm.simulator
    names = tm._expand_group("exc")
    gs = torch.tensor([0.5, 1.0, 3.0])
    st = sim.init_state(3)
    stim = {k: torch.from_numpy(v) for k, v in _izh_stim(25, 2).items()}
    batched = sim.run(st, 25, {n: gs for n in names}, stim=stim)
    assert batched.health.steps.shape == (3,)
    for i in range(3):
        one = tm.run(25, gscales={"exc": float(gs[i])}, stim=stim)
        for p in ("exc", "inh"):
            assert int(one.health.spike_total[p]) == int(
                batched.health.spike_total[p][i])
            assert torch.equal(one.health.rate_ema_hz[p],
                               batched.health.rate_ema_hz[p][i])
        assert batched.health.summary(i)["steps"] == 25


def test_health_state_carried_from_jax_finalizes_alike():
    """convert.health_state starts the port's accumulator from a JAX
    HealthState: both finalize to the same report, and one more step
    accumulates alike."""
    _, tm = _izh_pair({})
    mon = tm.monitor
    jmon = JHE.HealthConfig()
    sizes = {"exc": 48, "inh": 12}
    js = JHE.HealthState(
        spike_total={"exc": jnp.int32(17), "inh": jnp.int32(3)},
        rate_ema_hz={"exc": jnp.float32(7.25), "inh": jnp.float32(0.5)},
        steps=jnp.int32(9), nonfinite=jnp.bool_(True),
        first_bad_step=jnp.int32(4))
    arrays = {"spike_total": {k: np.asarray(v) for k, v in
                              js.spike_total.items()},
              "rate_ema_hz": {k: np.asarray(v) for k, v in
                              js.rate_ema_hz.items()},
              "steps": np.asarray(js.steps),
              "nonfinite": np.asarray(js.nonfinite),
              "first_bad_step": np.asarray(js.first_bad_step)}
    ts = convert.health_state(tm, arrays, batch=2)
    assert ts.steps.shape == (2,)
    assert_reports_equal(JHE.finalize(jmon, js, 1.0, sizes),
                         _member(THE.finalize(mon, ts, 1.0, sizes), 1))
    counts = {"exc": 5, "inh": 2}
    js2 = JHE.accumulate(jmon, js, {k: jnp.int32(v) for k, v in
                                    counts.items()}, jnp.bool_(True), 1.0,
                         sizes)
    ts2 = THE.accumulate(mon, ts, {k: torch.full((2,), v, dtype=torch.int32)
                                   for k, v in counts.items()},
                         torch.ones(2, dtype=torch.bool), 1.0, sizes)
    assert_reports_equal(JHE.finalize(jmon, js2, 1.0, sizes),
                         _member(THE.finalize(mon, ts2, 1.0, sizes), 0))


def _member(rep, i):
    def pick(x):
        return {k: v[i] for k, v in x.items()} if isinstance(x, dict) \
            else x[i]
    return THE.HealthReport(**{k: pick(getattr(rep, k)) for k in (
        "spike_total", "rate_ema_hz", "mean_rate_hz", "silent", "saturated",
        "steps", "nonfinite", "first_bad_step")})


class _AtenOps(TorchDispatchMode):
    """The aten ops run under it, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with _AtenOps() as mode:
        fn()
    return mode.ops


def test_monitor_off_build_runs_the_unmonitored_ops():
    """The port's "identical jaxpr": a monitor-off build runs the same
    aten ops, in the same order, as one built without a monitor, eagerly
    and in chunks; a monitored build runs more."""
    cfg = TIZ.IzhikevichNetConfig(**IZH)
    plain = TIZ.compile_model(cfg, device="cpu")
    off = TIZ.compile_model(cfg, device="cpu",
                            monitor=HealthConfig(enabled=False))
    on = TIZ.compile_model(cfg, device="cpu", monitor=HealthConfig())
    runs = {}
    for name, m in (("plain", plain), ("off", off), ("on", on)):
        st = m.init_state()
        m.simulator.run_compiled(st, 9)          # set the chunks up first
        runs[name] = (_ops(lambda: m.simulator.run(st, 7)),
                      _ops(lambda: m.simulator.run_compiled(st, 9)))
    assert runs["off"] == runs["plain"]
    assert len(runs["on"][0]) > len(runs["plain"][0])


def test_declared_probes_leave_the_step_as_it_was():
    """Probes sample in the run loop, not in ``step``: a step runs the
    same aten ops with or without them, and a run without probes, custom
    updates or a monitor reads nothing on the host to set them up."""
    base = TIZ.spec(TIZ.IzhikevichNetConfig(**IZH))
    probed = TIZ.spec(TIZ.IzhikevichNetConfig(**IZH))
    probed.probe("v", "exc", "V", every=2)
    probed.probe("s", "inh", "spikes")
    a = base.build(dt=1.0, seed=2, device="cpu")
    b = probed.build(dt=1.0, seed=2, device="cpu")
    sa, sb = a.init_state(), b.init_state()
    assert _ops(lambda: a.simulator.step(sa)) == _ops(
        lambda: b.simulator.step(sb))
    ops = _ops(lambda: a.simulator.run(sa, 3))
    assert "aten._local_scalar_dense.default" not in ops


def test_monitor_validation_errors():
    cfg = TIZ.IzhikevichNetConfig(**IZH)
    with pytest.raises(TSPEC.SpecError, match="monitor"):
        TIZ.compile_model(cfg, device="cpu", monitor=HealthConfig(
            bands_hz={"nope": (1.0, 2.0)}))
    with pytest.raises(ValueError, match="ema_tau_ms"):
        HealthConfig(ema_tau_ms=0.0).validate(["exc"])
    with pytest.raises(ValueError, match="lo > hi"):
        HealthConfig(bands_hz={"exc": (5.0, 1.0)}).validate(["exc"])
    # the JAX package's checks, message for message
    for bad in (dict(ema_tau_ms=0.0), dict(bands_hz={"exc": (5.0, 1.0)})):
        with pytest.raises(ValueError) as te:
            HealthConfig(**bad).validate(["exc"])
        with pytest.raises(ValueError) as je:
            JHE.HealthConfig(**bad).validate(["exc"])
        assert str(te.value) == str(je.value)
    assert THE.NO_BAD_STEP == int(JHE.NO_BAD_STEP)
