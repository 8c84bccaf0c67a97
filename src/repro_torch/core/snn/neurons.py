"""Built-in neuron models, declared in the GeNN equation DSL.

Counterpart of ``repro/core/snn/neurons.py``: the same declarations
(Izhikevich for the cortical net, Traub-Miles Hodgkin-Huxley and Poisson for
the mushroom body, LIF, the Rulkov map), compiled by the port's codegen.

``fused_kernel`` is the table of models whose whole update one hand-written
kernel computes (``IZHIKEVICH`` -> ``izhikevich_step``, any
``make_traubmiles(k)`` -> ``hh_step`` with ``substeps=k``); the simulator
runs those populations through the kernel and every other model through
codegen.  ``NormalInput`` declares a population's input as a scaled normal
draw a neuron a step, which the Izhikevich kernel then hashes itself.

Units follow GeNN: time in ms, voltages in mV, conductances in uS, currents
in nA, capacitance in nF.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import random as _random
from repro_torch.core.codegen import NeuronModel

__all__ = [
    "IZHIKEVICH", "TRAUBMILES_HH", "POISSON", "LIF", "RULKOV_MAP",
    "make_traubmiles", "izhikevich_population_params", "get_model",
    "fused_kernel", "NormalInput",
]

# ---------------------------------------------------------------------------
# Izhikevich (2003) "simple model of spiking neurons".
# Two coupled ODEs, Euler-integrated with two half-steps on V for stability —
# exactly the update GeNN generates for its Izhikevich model.
# ---------------------------------------------------------------------------
IZHIKEVICH = NeuronModel(
    name="izhikevich",
    state={"V": -65.0, "U": -13.0},
    params={"a": 0.02, "b": 0.2, "c": -65.0, "d": 8.0},
    sim_code="""
V = V + 0.5*dt*(0.04*V*V + 5.0*V + 140.0 - U + Isyn)
V = V + 0.5*dt*(0.04*V*V + 5.0*V + 140.0 - U + Isyn)
U = U + dt*a*(b*V - U)
V = minimum(V, 30.0)
""",
    threshold_code="V >= 29.99",
    reset_code="""
V = c
U = U + d
""",
)


def izhikevich_population_params(key: torch.Tensor, n_exc: int,
                                 n_inh: int):
    """Per-neuron parameter tensors for the Izhikevich (2003) cortical net,
    drawn from the threefry ``key`` (``repro_torch.random``; on its device),
    equal to the JAX package's bit for bit.

    Excitatory: (a,b) = (0.02, 0.2), (c,d) = (-65+15 r^2, 8-6 r^2)
    Inhibitory: (a,b) = (0.02+0.08 r, 0.25-0.05 r), (c,d) = (-65, 2)
    """
    ke, ki = _random.split(key)
    re = _random.uniform(ke, (n_exc,))
    ri = _random.uniform(ki, (n_inh,))
    dev = key.device

    def full(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    a = torch.cat([full(n_exc, 0.02), 0.02 + 0.08 * ri])
    b = torch.cat([full(n_exc, 0.2), 0.25 - 0.05 * ri])
    c = torch.cat([-65.0 + 15.0 * (re * re), full(n_inh, -65.0)])
    d = torch.cat([8.0 - 6.0 * (re * re), full(n_inh, 2.0)])
    return {"a": a, "b": b, "c": c, "d": d}


# ---------------------------------------------------------------------------
# Traub-Miles Hodgkin-Huxley (the HH variant GeNN uses for KC/LHI/DN in the
# mushroom-body model): guarded rate functions, `substeps` Euler substeps.
# ---------------------------------------------------------------------------

_HH_SUBSTEP = """
Imem = -(m*m*m*h*gNa*(V-ENa) + n*n*n*n*gK*(V-EK) + gl*(V-El) - Isyn)
V = V + {h_dt}*Imem/C
xm = (-52.0 - V)/4.0
a_m = 1.28*where(abs(xm) > 1e-4, xm/(exp(xm) - 1.0), 1.0 - xm/2.0)
xb = (V + 25.0)/5.0
b_m = 1.4*where(abs(xb) > 1e-4, xb/(exp(xb) - 1.0), 1.0 - xb/2.0)
a_h = 0.128*exp((-48.0 - V)/18.0)
b_h = 4.0/(exp((-25.0 - V)/5.0) + 1.0)
xn = (-50.0 - V)/5.0
a_n = 0.16*where(abs(xn) > 1e-4, xn/(exp(xn) - 1.0), 1.0 - xn/2.0)
b_n = 0.5*exp((-55.0 - V)/40.0)
m = clip(m + {h_dt}*(a_m*(1.0 - m) - b_m*m), 0.0, 1.0)
h = clip(h + {h_dt}*(a_h*(1.0 - h) - b_h*h), 0.0, 1.0)
n = clip(n + {h_dt}*(a_n*(1.0 - n) - b_n*n), 0.0, 1.0)
"""


def make_traubmiles(substeps: int = 5) -> NeuronModel:
    """Generate a Traub-Miles HH model with `substeps` Euler substeps/dt."""
    body = "".join(
        _HH_SUBSTEP.format(h_dt=f"(dt/{float(substeps)})")
        for _ in range(substeps))
    return NeuronModel(
        name=f"traubmiles_hh_x{substeps}",
        state={"V": -60.0, "m": 0.0529, "h": 0.3177, "n": 0.3177},
        params={
            "gNa": 7.15, "ENa": 50.0, "gK": 1.43, "EK": -95.0,
            "gl": 0.02672, "El": -63.563, "C": 0.143,
        },
        sim_code=body,
        # Spike = upward crossing of 0 mV; populations using this model
        # default to edge_spikes=True in Network.add_population.
        threshold_code="V >= 0.0",
        reset_code="",
    )


TRAUBMILES_HH = make_traubmiles(5)

# ---------------------------------------------------------------------------
# Poisson input neurons (the PN population of the mushroom-body model).
# ---------------------------------------------------------------------------
POISSON = NeuronModel(
    name="poisson",
    state={"timeToSpike": 0.0},
    params={"rate_hz": 20.0},
    sim_code="timeToSpike = rand",
    threshold_code="timeToSpike < rate_hz * dt * 0.001",
    reset_code="",
)

# ---------------------------------------------------------------------------
# Leaky integrate-and-fire, the minimal sanity model.
# ---------------------------------------------------------------------------
LIF = NeuronModel(
    name="lif",
    state={"V": -70.0},
    params={"tau": 20.0, "Vrest": -70.0, "Vreset": -70.0,
            "Vthresh": -50.0, "R": 1.0},
    sim_code="V = V + dt*((Vrest - V) + R*Isyn)/tau",
    threshold_code="V >= Vthresh",
    reset_code="V = Vreset",
)

# ---------------------------------------------------------------------------
# Rulkov map neuron (GeNN's MAPNEURON).
# ---------------------------------------------------------------------------
RULKOV_MAP = NeuronModel(
    name="rulkov_map",
    state={"V": -60.0, "preV": -60.0},
    params={"Vspike": 60.0, "alpha": 3.0, "y": -2.468, "beta": 0.0165},
    sim_code="""
tmp = where(V <= 0.0, alpha*V/(1.0 - V) + y + beta*Isyn,
            where((V < Vspike) * (preV <= 0.0), Vspike + y, -2.468))
preV = V
V = tmp
""",
    threshold_code="V >= Vspike",
    reset_code="",
)

_REGISTRY = {
    m.name: m for m in (IZHIKEVICH, TRAUBMILES_HH, POISSON, LIF, RULKOV_MAP)
}
_REGISTRY["traubmiles_hh"] = TRAUBMILES_HH


def _declaration(model: NeuronModel) -> tuple:
    """What a model's update depends on: its code, state and params (not
    its name)."""
    return (model.sim_code, model.threshold_code, model.reset_code,
            dict(model.state), dict(model.params))


def fused_kernel(model: NeuronModel) -> Optional[Tuple[str, Dict[str, int]]]:
    """The fused kernel that computes ``model``'s update and its static
    arguments: ("izhikevich_step", {}) for a declaration equal to
    ``IZHIKEVICH``, ("hh_step", {"substeps": k}) for one equal to
    ``make_traubmiles(k)``, None for any other (a model named "izhikevich"
    with other code stays on codegen)."""
    decl = _declaration(model)
    if decl == _declaration(IZHIKEVICH):
        return "izhikevich_step", {}
    k = model.sim_code.count("Imem =")
    if k >= 1 and decl == _declaration(make_traubmiles(k)):
        return "hh_step", {"substeps": k}
    return None


@dataclasses.dataclass(frozen=True)
class NormalInput:
    """An input function that draws ``scale * N(0, 1)`` a neuron a step
    from the population's input key (the paper's thalamic drive), as
    ``random.normal(keys, (n,), scale=scale)`` draws it, the scale
    rounded to float32.  Declared this way (not as a lambda), an
    Izhikevich population's draw runs inside its fused kernel, which sums
    the group currents, hashes the normals in registers and updates the
    state in one launch; any route that calls the input function gets
    the same draw."""

    scale: float

    def __call__(self, keys: torch.Tensor, t, n: int) -> torch.Tensor:
        return _random.normal(keys, (n,), scale=self.scale)


def get_model(name: str) -> NeuronModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown neuron model {name!r}; have {sorted(_REGISTRY)}")
