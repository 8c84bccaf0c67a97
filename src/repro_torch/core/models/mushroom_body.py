"""The insect olfactory system / mushroom-body model (paper §5.1, ref [10]).

Counterpart of ``repro/core/models/mushroom_body.py``:

  PN   projection neurons        -- Poisson inputs (odor-driven rates)
  LHI  lateral horn interneurons -- Traub-Miles HH, driven by PNs, inhibit
                                    KCs (feedforward gain control)
  KC   Kenyon cells              -- Traub-Miles HH, sparse PN input
  DN   detection neurons         -- Traub-Miles HH, driven by KCs, mutual
                                    inhibition

Every synapse group is an ExpCond postsynaptic model.  The connectivity and
the KC->DN weights come from the host numpy generator in declaration order,
so the same config and seed give the JAX package's graph bit for bit.  The
PN Poisson draws (``rand``) come from each step's threefry subkey as in the
JAX package, so the same seed gives its PN spike trains bit for bit.  The
LHI, KC and DN populations advance through the fused ``hh_step`` kernel
(``neurons.fused_kernel``).

Baseline conductances are the JAX package's, calibrated at the reduced
sizes of its tests and example (24 PN / 6 LHI / 150 KC / 12 DN and
smaller): at gScale 1 the summed inSyn stays under the explicit-coupling
bound (dt / C_m) * inSyn < 2, and gScale ~50 on PN->KC crosses it and trips
the NaN guard (the paper's float-overflow phenomenon).  Larger populations
need their gScales rescaled by fan-in, the paper's own method.

Observation and intervention, as in the JAX package: a KC membrane-voltage
probe sampled every ``kc_probe_every`` steps (0: none), and the KC->DN
incoming-weight normalisation as a declared custom update (each DN's total
conductance rescaled to its expected build value, on demand through
``model.custom_update("normalize_kc_dn", state)``).  The normalisation
makes KC_DN's g state-resident, which takes the ELL path; both are off by
default, so the default configuration's dynamics are unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.snn import neurons as N
from repro_torch.core.snn.network import Network
from repro_torch.core.snn.simulator import Simulator
from repro_torch.core.snn.spec import CompiledModel, ModelSpec
from repro_torch.core.snn.synapses import ExpCond
from repro_torch.sparse.formats import FixedFanout

__all__ = ["MushroomBodyConfig", "spec", "compile_model", "build"]


@dataclasses.dataclass(frozen=True)
class MushroomBodyConfig:
    n_pn: int = 100
    n_lhi: int = 20
    n_kc: int = 1000
    n_dn: int = 100
    pn_kc_fanout_frac: float = 0.5     # fraction of KCs each PN contacts
    pn_rate_hz: float = 50.0           # odor-on Poisson rate
    dt: float = 0.1
    seed: int = 7
    representation: str = "auto"
    # baseline conductances (uS), the JAX package's (module docstring)
    g_pn_kc: float = 0.015
    g_pn_lhi: float = 0.0025
    g_lhi_kc: float = 0.40
    g_kc_dn: float = 0.02
    g_dn_dn: float = 0.01
    # observation / intervention (module docstring)
    kc_probe_every: int = 0
    kc_dn_normalize: bool = False


def spec(cfg: MushroomBodyConfig) -> ModelSpec:
    """Declarative description of the mushroom-body net."""
    ms = ModelSpec(name=f"mbody_pn{cfg.n_pn}_lhi{cfg.n_lhi}")

    ms.add_neuron_population("PN", cfg.n_pn, N.POISSON,
                             {"rate_hz": cfg.pn_rate_hz})
    ms.add_neuron_population("LHI", cfg.n_lhi, N.TRAUBMILES_HH)
    ms.add_neuron_population("KC", cfg.n_kc, N.TRAUBMILES_HH)
    ms.add_neuron_population("DN", cfg.n_dn, N.TRAUBMILES_HH)

    n_kc_per_pn = max(1, int(round(cfg.pn_kc_fanout_frac * cfg.n_kc)))
    ms.add_synapse_population(
        "PN_KC", "PN", "KC", connect=FixedFanout(n_kc_per_pn),
        weight=cfg.g_pn_kc, representation=cfg.representation,
        psm=ExpCond(tau_ms=2.0, e_rev=0.0))

    ms.add_synapse_population(
        "PN_LHI", "PN", "LHI", connect=FixedFanout(cfg.n_lhi),
        weight=cfg.g_pn_lhi, representation="dense",
        psm=ExpCond(tau_ms=1.0, e_rev=0.0))

    ms.add_synapse_population(
        "LHI_KC", "LHI", "KC", connect=FixedFanout(cfg.n_kc),
        weight=cfg.g_lhi_kc, representation="dense",
        psm=ExpCond(tau_ms=3.0, e_rev=-92.0))

    ms.add_synapse_population(
        "KC_DN", "KC", "DN", connect=FixedFanout(cfg.n_dn),
        weight=lambda r, s: (cfg.g_kc_dn * r.random(s)).astype(np.float32),
        representation=cfg.representation,
        psm=ExpCond(tau_ms=5.0, e_rev=0.0))

    ms.add_synapse_population(
        "DN_DN", "DN", "DN", connect=FixedFanout(cfg.n_dn),
        weight=cfg.g_dn_dn, representation="dense",
        psm=ExpCond(tau_ms=10.0, e_rev=-92.0))

    if cfg.kc_probe_every:
        ms.probe("kc_v", "KC", "V", every=cfg.kc_probe_every)
    if cfg.kc_dn_normalize:
        # hold each DN's total incoming conductance at its expected build
        # value (n_kc synapses, weights ~ U(0, g_kc_dn): mean g_kc_dn / 2)
        ms.add_custom_update(
            "normalize_kc_dn", "KC_DN",
            update_code="g = g * g_total / maximum(w_sum, eps)",
            params={"g_total": cfg.n_kc * cfg.g_kc_dn / 2.0, "eps": 1e-9},
            reduce={"w_sum": ("sum", "g", "post")})
    return ms


def compile_model(cfg: MushroomBodyConfig, device=None,
                  monitor=None, init: str = "host",
                  mesh=None) -> CompiledModel:
    """Build the net on ``device`` ("cuda" unless the caller asks), with
    the health monitor ``monitor`` (a HealthConfig) if given; ``init``
    ("host" or "device") and ``mesh`` (a ``launch.mesh.Mesh``: the
    sharded engine on the mesh's device) are ``ModelSpec.build``'s."""
    return spec(cfg).build(dt=cfg.dt, seed=cfg.seed, device=device,
                           monitor=monitor, init=init, mesh=mesh)


def build(cfg: MushroomBodyConfig, device=None) -> tuple[Network, Simulator]:
    """Legacy entry point: (Network, Simulator) from the compiled spec."""
    model = compile_model(cfg, device=device)
    return model.network, model.simulator
