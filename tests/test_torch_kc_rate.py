"""The mushroom body's KC rate at fan-in gScales: the port against the JAX
package under the same PN spike trains, on the CPU.

chip_smoke.py's phase 6b runs the mushroom body at 100 PN / 20 LHI / 100k
KC / 100 DN with every group's gScale scaled by fan-in from the example's
(24 / 6 / 150 / 12): PN_KC and PN_LHI 24/100, LHI_KC 6/20, KC_DN 150/n_kc,
DN_DN 12/100.  Here the same groups and gScales at 200 KCs (each KC still
sees ~50 PNs), 1000 steps of dt 0.1 ms.  The PNs are driven by one
numpy-made set of 50 Hz spike trains, through ``stim``, in both packages
(a PN model whose V is its stimulus and that spikes above 0.5), so the
Poisson generators (torch's vs threefry) drop out.

Contract: KC, LHI and DN rates equal within 1% (relative), rasters agree
on at least 99.8% of neuron-steps, and both runs stay finite.  Measured:
the LHI and KC rasters agree bit for bit and DN's on >99.8%.

The JAX run is jit-compiled with the dense weight matrices passed as
arguments, not closed over.  jax 0.9.0's CPU backend miscomputes
``jax.jit(lambda s: s @ W)`` for a constant W of [100, 20] (PN_LHI at this
size) or [100, 16]: 24 of the 2000 entries over the 100 one-hot spike
vectors come out doubled (W [100, 32], [50, 20] or [24, 6] are exact).
With W closed over, the JAX package's own ``run`` gives KC 14.5 Hz against
the port's and its own eager step's 22.8 Hz at this size; that fault, not
the PN draws, is what made the port's chip-run KC rate look ~2x the JAX
reference's (experiments/mushroom_body_reference.py runs jit on the CPU).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import codegen as JC  # noqa: E402
from repro.core.models import mushroom_body as JMB  # noqa: E402
from repro_torch.core import codegen as TC  # noqa: E402
from repro_torch.core.models import mushroom_body as TMB  # noqa: E402

SIZES = dict(n_pn=100, n_lhi=20, n_kc=200, n_dn=100)
EXAMPLE = dict(n_pn=24, n_lhi=6, n_kc=150, n_dn=12)
STEPS = 1000
PN_RATE_HZ = 50.0
RATE_RTOL = 0.01
RASTER_AGREEMENT = 0.998
STIM_PN = dict(name="stim_pn", state={"V": 0.0}, params={},
               sim_code="V = Isyn", threshold_code="V > 0.5", reset_code="")


def _fan_in_gscales() -> dict:
    s, e = SIZES, EXAMPLE
    return {"PN_KC": e["n_pn"] / s["n_pn"], "PN_LHI": e["n_pn"] / s["n_pn"],
            "LHI_KC": e["n_lhi"] / s["n_lhi"],
            "KC_DN": e["n_kc"] / s["n_kc"], "DN_DN": e["n_dn"] / s["n_dn"]}


def _spec(package, codegen):
    """The package's mushroom body with its Poisson PNs replaced by
    stimulus-driven ones."""
    ms = package.spec(package.MushroomBodyConfig(**SIZES))
    ms.populations["PN"] = dataclasses.replace(
        ms.populations["PN"], model=codegen.NeuronModel(**STIM_PN),
        params={})
    return ms


def _jax_run(model, gscales, stim):
    """``model.simulator.run`` jit-compiled with the dense weights as
    arguments (see the module docstring)."""
    groups = model.network.synapses
    dense = [g.dense for g in groups]

    def run(mats, gs, st):
        for g, d in zip(groups, mats):
            g.dense = d
        try:
            return model.simulator.run(model.init_state(), STEPS, gs,
                                       stim=st)
        finally:
            for g, d in zip(groups, dense):
                g.dense = d

    return jax.jit(run)(dense, gscales, stim)


def test_kc_rate_matches_jax_under_the_same_pn_trains():
    cfg = JMB.MushroomBodyConfig(**SIZES)
    rng = np.random.default_rng(0)
    pn = (rng.random((STEPS, SIZES["n_pn"]))
          < PN_RATE_HZ * cfg.dt * 1e-3).astype(np.float32)
    gs = _fan_in_gscales()
    js = _spec(JMB, JC)
    for p in ("LHI", "KC", "DN"):
        js.probe(p, p, "spikes")
    jm = js.build(dt=cfg.dt, seed=cfg.seed)
    jr = _jax_run(jm, {k: jnp.float32(v) for k, v in gs.items()},
                  {"PN": jnp.asarray(pn)})
    tm = _spec(TMB, TC).build(dt=cfg.dt, seed=cfg.seed, device="cpu")
    assert tm.simulator.routes["KC"] == "hh_step"
    tr = tm.run(STEPS, stim={"PN": pn}, gscales=gs, record_raster=True)
    assert bool(tr.finite) and bool(jr.finite)
    for p in ("LHI", "KC", "DN"):
        jrate, trate = float(jr.rates_hz[p]), float(tr.rates_hz[p])
        assert trate > 0.0, p
        assert abs(trate - jrate) <= RATE_RTOL * jrate, (p, trate, jrate)
        agree = (np.asarray(jr.recordings[p]) == tr.raster[p].numpy()).mean()
        assert agree >= RASTER_AGREEMENT, (p, agree)
    assert float(tr.rates_hz["PN"]) == float(jr.rates_hz["PN"])
