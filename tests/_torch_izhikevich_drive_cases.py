"""The sharded engine's cases of ``tests/test_torch_izhikevich_drive.py`` --
not a test module (``_torch_dist.py`` runs them, a gloo rank a worker).

A small Izhikevich net whose thalamic inputs are ``neurons.NormalInput``
drives, so each rank's fused kernel hashes the normals of its own lanes
only.  Neither 2 nor 8 divides its populations (45 and 11 neurons): the
ranks' windows end in padded lanes, and at 8 ranks two ranks hold none of
the 11.  Each case returns what the engine gave, gathered; the test holds
it to the port's single-device ``Simulator`` bit for bit."""

import numpy as np
import torch

from _torch_engine_cases import leaves, stim
from repro_torch.core.snn import neurons as TN
from repro_torch.core.snn import spec as TSPEC
from repro_torch.sparse import formats as TF

SIZES = {"exc": 45, "inh": 11}
STEPS = 30
KEYS = ((0, 1), (0, 9))          # two members, each its own key


def drive_spec():
    s = TSPEC.ModelSpec("drive")
    s.add_neuron_population("exc", SIZES["exc"], TN.IZHIKEVICH,
                            {"c": np.linspace(-65.0, -50.0, SIZES["exc"])},
                            TN.NormalInput(5.0))
    s.add_neuron_population("inh", SIZES["inh"], TN.IZHIKEVICH,
                            {"a": 0.1, "d": 2.0}, TN.NormalInput(7.0))
    s.add_synapse_population("e", "exc", ["exc", "inh"],
                             connect=TF.FixedFanout(8),
                             weight=TF.UniformWeight(0.0, 0.5))
    s.add_synapse_population("i", "inh", ["exc", "inh"],
                             connect=TF.FixedFanout(4),
                             weight=TF.UniformWeight(0.0, -1.0))
    return s


def build(mesh=None):
    return drive_spec().build(dt=1.0, seed=2, mesh=mesh,
                              device="cpu" if mesh is None else None)


def run_case(model, state_of):
    """The compiled run of STEPS with a [STEPS, 2, n] stim on "exc", then
    four public steps with an [n] stim on "inh"."""
    keys = torch.tensor(KEYS, dtype=torch.int32)
    res = model.run(STEPS, state=model.init_state(2, key=keys),
                    record_raster=True,
                    stim=stim(STEPS, {"exc": SIZES["exc"]}, batch=2, seed=4))
    st = res.state
    drive = stim(4, {"inh": SIZES["inh"]}, seed=5)
    spikes = []
    for i in range(4):
        st, spk = model.step(st, stim={"inh": drive["inh"][i]})
        spikes.append(spk)
    return {"counts": res.spike_counts, "raster": res.raster,
            "finite": res.finite, "rates": res.rates_hz,
            "state": leaves(state_of(res.state)), "spikes": spikes,
            "stepped": leaves(state_of(st)),
            "routes": dict(model.backend.routes)}


def case_drive(mesh):
    m = build(mesh)
    return {"global": run_case(m, m.engine.gather_state)}
