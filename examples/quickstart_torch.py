"""Quickstart on the PyTorch/CUDA port: declare a spiking network (neuron
models, synapse models and connectivity) as data and code snippets in the
GeNN-style ModelSpec, build it (validation, seeded connectivity,
representation choice), run it with probes, read its memory report, and
sweep the paper's conductance scaling factor as one batch.

The flow of ``examples/quickstart.py`` through ``repro_torch``.  Runs on the
card (``cuda``) unless asked otherwise:

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --steps 100
"""

import argparse

import numpy as np

from repro_torch import random as R
from repro_torch.core.codegen import NeuronModel, generated_source
from repro_torch.core.snn.spec import ModelSpec
from repro_torch.core.snn.synapses import ExpDecay
from repro_torch.sparse.formats import FixedFanout, FixedProbability

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--steps", type=int, default=400,
                help="steps of 1 ms to run and to sweep (default 400)")
args = ap.parse_args()

# 1. Declare a neuron model as code (GeNN's defining workflow) -------------
izhi = NeuronModel(
    name="izhi",
    state={"V": -65.0, "U": -13.0},
    params={"a": 0.02, "b": 0.2, "c": -65.0, "d": 8.0},
    sim_code="""
V = V + 0.5*dt*(0.04*V*V + 5.0*V + 140.0 - U + Isyn)
V = V + 0.5*dt*(0.04*V*V + 5.0*V + 140.0 - U + Isyn)
U = U + dt*a*(b*V - U)
V = minimum(V, 30.0)
""",
    threshold_code="V >= 29.99",
    reset_code="V = c\nU = U + d",
)
print("=== generated update function ===")
print(generated_source(izhi))

# 2. Declare the network: populations and synapse populations ---------------
#    Input draws take each member's threefry subkey ([B, 2] keys on the
#    model's device); connectivity is resolved from the build seed.
spec = ModelSpec("quickstart")
spec.add_neuron_population(
    "exc", 160, izhi, input_fn=lambda k, t, n: R.normal(k, (n,), scale=5.0))
spec.add_neuron_population(
    "inh", 40, izhi, params={"a": 0.1, "d": 2.0},
    input_fn=lambda k, t, n: R.normal(k, (n,), scale=2.0))

spec.add_synapse_population("ee", "exc", "exc", connect=FixedFanout(40),
                            weight=lambda r, s: 0.5 * r.random(s))
spec.add_synapse_population("ei", "exc", "inh", connect=FixedProbability(0.25),
                            weight=lambda r, s: 0.5 * r.random(s))
spec.add_synapse_population("ie", "inh", "exc", connect=FixedFanout(40),
                            weight=lambda r, s: -r.random(s),
                            psm=ExpDecay(tau_ms=3.0))

# Probes: recording of any declared state variable on the device (a
# "spikes" probe is the raster, kept as 32x bitmask words while it runs)
spec.probe("exc_raster", "exc", "spikes")
spec.probe("exc_v_mean", "exc", "V", reduce="mean")

# 3. Build: validation, seeded connectivity, representation choice ---------
model = spec.build(dt=1.0, seed=0, device=args.device)
print("\n=== compiled model ===")
print(model)

print("\n=== representation choice (paper eq 1/2) ===")
for rep in model.memory_report(n_steps=args.steps):
    if rep["kind"] == "synapse_group":
        print(f"  {rep['name']}: {rep['representation']} "
              f"(sparse {rep['sparse_elements']} vs dense "
              f"{rep['dense_elements']} elements)")
    elif rep["kind"] == "probe":
        print(f"  probe {rep['name']}: {rep['buffer_bytes']} bytes "
              f"({'packed spike words' if rep['is_packed'] else 'float32'})")

# 4. Run; probes come back in Recordings keyed by probe name ----------------
res = model.run(args.steps)

print(f"\n=== results ({args.steps} ms) ===")
for pop, rate in res.rates_hz.items():
    print(f"  {pop}: {float(rate):.1f} Hz, finite={bool(res.finite)}")
vmean = res.recordings["exc_v_mean"].cpu().numpy()
print(f"  exc mean V over the last 5 samples: {vmean[-5:].round(1)}")

print("\n=== exc raster (first 40 neurons x 80 ms, probe 'exc_raster') ===")
raster = res.recordings["exc_raster"].cpu().numpy()[:80, :40]
for t in range(0, raster.shape[0], 2):
    print("  " + "".join("|" if raster[t, i] else "." for i in range(40)))

# 5. Sweep gscale for one synapse group: the candidates ride one batch -----
grid = np.logspace(-0.5, 0.8, 8)
sweep = model.sweep_gscale("ee", grid, n_steps=args.steps)
print("\n=== gscale sweep over 'ee' (one batch of candidates) ===")
print(" gscale | exc Hz | finite")
for g, r, f in zip(sweep.values.tolist(), sweep.rates_hz["exc"].tolist(),
                   sweep.finite.tolist()):
    print(f" {g:6.2f} | {r:6.1f} | {bool(f)}")
