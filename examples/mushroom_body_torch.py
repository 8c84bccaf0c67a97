"""The paper's second benchmark network on the PyTorch/CUDA port: the
insect-olfaction mushroom body (PN -> LHI/KC -> DN), Poisson input neurons
and Traub-Miles HH units.  Shows sparse KC coding, the NaN guard tripping
when PN->KC is over-scaled (the paper's float-overflow discussion), the KC
membrane-voltage probe recorded per sweep candidate, and the KC->DN
incoming-weight normalisation as a custom update applied on demand.

The flow of ``examples/mushroom_body.py`` through ``repro_torch``.  Runs on
the card (``cuda``) unless asked otherwise:

  PYTHONPATH=src python examples/mushroom_body_torch.py
  PYTHONPATH=src python examples/mushroom_body_torch.py --device cpu --steps 300
"""

import argparse

import numpy as np

from repro_torch.core.models.mushroom_body import (MushroomBodyConfig,
                                                   compile_model)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--steps", type=int, default=2500,
                help="steps of 0.1 ms a candidate runs (default 2500)")
args = ap.parse_args()

cfg = MushroomBodyConfig(n_pn=24, n_lhi=6, n_kc=150, n_dn=12,
                         kc_probe_every=25, kc_dn_normalize=True)
model = compile_model(cfg, device=args.device)

print(model)
print("synapse representations:")
for rep in model.memory_report():
    if rep["kind"] == "synapse_group":
        print(f"  {rep['name']}: {rep['representation']}")

sweep = model.sweep_gscale("PN_KC", [0.5, 1.0, 2.0, 8.0, 50.0],
                           n_steps=args.steps)

print("\n gScale |  PN Hz |  KC Hz |  DN Hz | finite (NaN guard)")
for i, g in enumerate(sweep.values.tolist()):
    r = {k: float(v[i]) for k, v in sweep.rates_hz.items()}
    print(f" {g:6.1f} | {r['PN']:6.1f} | {r['KC']:6.1f} | {r['DN']:6.1f} "
          f"| {bool(sweep.finite[i])}")

print("\nKC population sparseness at gScale=1:")
kc_rate = float(sweep.rates_hz["KC"][1])
pn_rate = float(sweep.rates_hz["PN"][1])
counts = sweep.spike_counts["KC"][1].cpu().numpy()
# temporal sparseness: each KC's duty cycle (expected spikes per 5 ms
# window) stays far below the PN drive although every KC receives PN input
duty = min(kc_rate * 5e-3, 1.0)
print(f"  mean KC rate {kc_rate:.1f} Hz vs PN drive {pn_rate:.1f} Hz "
      f"(each KC spikes in ~{100 * duty:.0f}% of 5 ms windows); "
      f"{np.mean(counts > 0):.2f} of KCs fired at least once")

# --- probes: the KC membrane voltage, recorded per sweep candidate --------
kc_v = sweep.recordings["kc_v"].cpu().numpy()       # [cand, samples, n_kc]
n_samp = int(sweep.recordings.counts["kc_v"][0])
print(f"\nKC V probe ('kc_v', every {cfg.kc_probe_every} steps): "
      f"{n_samp} samples x {kc_v.shape[-1]} KCs per candidate")
print("  mean KC V (last sample) per gScale: "
      + str(kc_v[:, n_samp - 1].mean(axis=1).round(1)))

# --- custom update: KC->DN weight normalisation on demand -----------------
grp = next(g for g in model.network.synapses if g.name == "KC_DN")
valid = grp.ell.valid.cpu().numpy()
post = grp.ell.post_ind.cpu().numpy()


def dn_totals(g):
    tot = np.zeros(cfg.n_dn, np.float64)
    np.add.at(tot, post[valid], g[0].cpu().numpy()[valid])
    return tot


state = model.init_state()
before = dn_totals(state.syn["KC_DN"].g)
state = model.custom_update("normalize_kc_dn", state)
after = dn_totals(state.syn["KC_DN"].g)
print("\nKC->DN normalisation (custom update 'normalize_kc_dn'):")
print(f"  per-DN incoming conductance before: "
      f"{before.min():.3f}..{before.max():.3f} uS")
print(f"  after: {after.min():.3f}..{after.max():.3f} uS "
      f"(target {cfg.n_kc * cfg.g_kc_dn / 2.0:.3f})")
