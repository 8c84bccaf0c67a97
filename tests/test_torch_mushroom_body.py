"""The port's mushroom-body net against the JAX package's, on the CPU.

The graph (connectivity, dense matrices, the KC->DN ``r.random`` weights)
comes from the host numpy generator in both packages and must be bit for
bit the same.  Dynamics are compared under a drive both packages compute
alike: ``pn_rate_hz = 10000`` makes ``rand < rate * dt * 1e-3 = 1`` true
for every PN at every step (an edge-spiking population, so the PNs fire one
volley at step 1), and numpy currents drive LHI, KC and DN; and under the
Poisson drive itself, from the config and seed alone: the port draws each
step's ``rand`` from the JAX package's threefry keys, so the PN spike
trains are bit for bit the same.  Contract: rasters agree on at least
99.8% of neuron-steps (PN's bit for bit over the first 200 steps), and the
``finite`` flags are equal; the port is also held to the JAX suite's own
oracles (tests/test_snn_system.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.models import mushroom_body as JMB  # noqa: E402
from repro_torch.core.models import mushroom_body as TMB  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.core.snn.network import Network  # noqa: E402
from repro_torch.core.snn.simulator import Simulator  # noqa: E402
from repro_torch.kernels import hh_step as HH  # noqa: E402

RASTER_AGREEMENT = 0.998
EXAMPLE = dict(n_pn=24, n_lhi=6, n_kc=150, n_dn=12)     # examples/
SMALL = dict(n_pn=20, n_lhi=5, n_kc=100, n_dn=10)       # test_snn_system
POPS = ("PN", "LHI", "KC", "DN")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sizes", [EXAMPLE, SMALL], ids=["example", "small"])
def test_graph_is_bit_identical_to_jax(sizes):
    jm = JMB.compile_model(JMB.MushroomBodyConfig(**sizes))
    tm = TMB.compile_model(TMB.MushroomBodyConfig(**sizes), device="cpu")
    assert tm.group_names == [g.name for g in jm.network.synapses] == [
        "PN_KC", "PN_LHI", "LHI_KC", "KC_DN", "DN_DN"]
    for jg, tg in zip(jm.network.synapses, tm.network.synapses):
        assert (tg.pre, tg.post, tg.representation) == (
            jg.pre, jg.post, jg.representation)
        np.testing.assert_array_equal(tg.ell.g.numpy(), np.asarray(jg.ell.g))
        np.testing.assert_array_equal(tg.ell.post_ind.numpy(),
                                      np.asarray(jg.ell.post_ind))
        np.testing.assert_array_equal(tg.ell.valid.numpy(),
                                      np.asarray(jg.ell.valid))
        np.testing.assert_array_equal(tg.dense.numpy(), np.asarray(jg.dense))
        assert tg.psm.params == jg.psm.params
    for name, jp in jm.network.populations.items():
        tp = tm.network.populations[name]
        assert (tp.n, tp.edge_spikes) == (jp.n, jp.edge_spikes)
        # the port keeps scalar params as their float32 values
        assert tp.params == {k: float(np.float32(v))
                             for k, v in jp.params.items()}


def test_deterministic_drive_matches_jax():
    t = 300
    kw = dict(EXAMPLE, pn_rate_hz=10000.0)
    rng = np.random.default_rng(0)
    stim = {p: (amp * rng.uniform(0.5, 1.5, n)
                + 0.05 * rng.standard_normal((t, n))).astype(np.float32)
            for p, n, amp in (("LHI", 6, 0.1), ("KC", 150, 2.0),
                              ("DN", 12, 0.1))}
    js = JMB.spec(JMB.MushroomBodyConfig(**kw))
    for p in POPS:
        js.probe(f"{p}_spk", p, "spikes")
    cfg = JMB.MushroomBodyConfig(**kw)
    jr = js.build(dt=cfg.dt, seed=cfg.seed).run(t, stim=stim)
    tm = TMB.compile_model(TMB.MushroomBodyConfig(**kw), device="cpu")
    tr = tm.run(t, stim=stim, record_raster=True)
    assert bool(tr.finite) == bool(jr.finite)
    for p in POPS:
        a = np.asarray(jr.recordings[f"{p}_spk"])
        b = tr.raster[p].numpy()
        assert a.shape == b.shape == (t, kw[f"n_{p.lower()}"])
        assert (a == b).mean() >= RASTER_AGREEMENT, p
        assert a.sum() > 0, p
    np.testing.assert_allclose(tr.state.neurons["KC"]["V"][0].numpy(),
                               np.asarray(jr.state.neurons["KC"]["V"]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sizes", [EXAMPLE, SMALL], ids=["example", "small"])
def test_poisson_drive_from_seed_alone_matches_jax(sizes):
    t = 400
    cfg = JMB.MushroomBodyConfig(**sizes)
    jspec = JMB.spec(cfg)
    for pop in POPS:
        jspec.probe(pop, pop, "spikes")
    jr = jspec.build(dt=cfg.dt, seed=cfg.seed).run(t)
    tm = TMB.compile_model(TMB.MushroomBodyConfig(**sizes), device="cpu")
    tr = tm.run(t, record_raster=True)
    pn_j, pn_t = np.asarray(jr.recordings["PN"]), tr.raster["PN"].numpy()
    np.testing.assert_array_equal(pn_t[:200], pn_j[:200])
    assert pn_j[:200].sum() > 0
    for pop in POPS:
        a, b = np.asarray(jr.recordings[pop]), tr.raster[pop].numpy()
        assert a.shape == b.shape
        assert (a == b).mean() >= RASTER_AGREEMENT, pop
    assert bool(jr.finite) and bool(tr.finite)


def test_gscale_overflow_sets_finite_flag():
    """tests/test_snn_system.py's NaN-guard oracle, on the port."""
    net, sim = TMB.build(TMB.MushroomBodyConfig(**SMALL), device="cpu")
    assert isinstance(net, Network) and isinstance(sim, Simulator)
    res = sim.run(sim.init_state(), 1500, {"PN_KC": 50.0})
    assert not bool(res.finite[0])


def test_mushroom_body_baseline_healthy():
    """tests/test_snn_system.py's baseline oracle, on the port; LHI, KC and
    DN advance through hh_step (its plain version, here)."""
    cfg = TMB.MushroomBodyConfig(**SMALL)
    net, sim = TMB.build(cfg, device="cpu")
    assert sim.routes == {"PN": "codegen", "LHI": "hh_step",
                          "KC": "hh_step", "DN": "hh_step"}
    HH.reset_launches()
    res = sim.run(sim.init_state(), 2000)
    assert HH.launches["hh_step"] == 0
    assert bool(res.finite[0])
    assert abs(float(res.rates_hz["PN"][0]) - cfg.pn_rate_hz) < 15.0


def test_unported_observation_raises():
    """The KC probe and the KC->DN normalisation are ported: they declare
    what the JAX package declares; a malformed probe period still raises
    (tests/test_torch_probes.py holds both to the JAX package)."""
    ms = TMB.spec(TMB.MushroomBodyConfig(**SMALL, kc_probe_every=25,
                                         kc_dn_normalize=True))
    assert [(p.name, p.target, p.var, p.every) for p in ms.probes] == [
        ("kc_v", "KC", "V", 25)]
    assert [(c.name, c.target) for c in ms.custom_updates] == [
        ("normalize_kc_dn", "KC_DN")]
    with pytest.raises(TSPEC.SpecError):
        TMB.spec(TMB.MushroomBodyConfig(**SMALL, kc_probe_every=-1))
