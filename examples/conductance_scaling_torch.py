"""The paper's core experiment in miniature on the PyTorch/CUDA port: find
gScale(nConn) keeping the Izhikevich network's firing rate constant, under
the NaN guard, and fit the paper's hyperbola  gScale = k1/(k2 + nConn) + k3
(Table 1 / Fig 2).

The flow of ``examples/conductance_scaling.py`` through ``repro_torch``:
each candidate grid is one batched ``CompiledModel.sweep_gscale`` (replayed
from CUDA graphs on the card).  Runs on the card (``cuda``) unless asked
otherwise; ``--trace FILE`` writes the builds' and runs' spans and the
occupancy model's decisions as a Chrome trace:

  PYTHONPATH=src:. python examples/conductance_scaling_torch.py
  PYTHONPATH=src:. python examples/conductance_scaling_torch.py --device cpu
  PYTHONPATH=src:. python examples/conductance_scaling_torch.py --trace t.json
"""

import argparse
import sys

import numpy as np

from benchmarks.gscale_experiments_torch import izhikevich_gscale_sweep
from repro_torch.core.conductance import hyperbola
from repro_torch.obs.profile import export_trace_cli

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--steps", type=int, default=250,
                help="steps of 1 ms a candidate runs (default 250)")
ap.add_argument("--trace", default="",
                help="write the Chrome trace of the run to this file")
args = ap.parse_args()

res = izhikevich_gscale_sweep(
    n_total=300, n_conns=(30, 60, 90, 150, 220, 300), n_steps=args.steps,
    device=args.device)

print("=== gScale search (target rate "
      f"{res['target_rate']:.1f} Hz) ===")
print(f"{'nConn':>6} {'gScale':>9} {'rate Hz':>8}")
for n, g, r in zip(res["n_conns"], res["gscales"], res["rates"]):
    print(f"{n:6d} {g:9.3f} {r:8.1f}")

print("\n=== hyperbola fit gScale = k1/(k2+nConn) + k3 ===")
print(f"k1={res['k1']:.4g}  k2={res['k2']:.4g}  k3={res['k3']:.4g}  "
      f"MAPE={res['mape_pct']:.2f}% (paper reports 3.95% at full scale)")

n = np.asarray(res["n_conns"], float)
pred = hyperbola(n, res["k1"], res["k2"], res["k3"])
print("\nfit vs observed:")
for ni, p, o in zip(res["n_conns"], pred, res["gscales"]):
    bar = int(max(0.0, min(p, 40)))
    print(f"  nConn={ni:4d} fit={p:7.3f} obs={o:7.3f} " + "#" * bar)

sys.exit(export_trace_cli(args.trace, "conductance_scaling"))
