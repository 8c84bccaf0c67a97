"""The JAX package's mushroom body at three sizes, on any JAX backend: the
reference rates that the PyTorch port's chip_smoke.py phases 6a and 6b are
set beside.

JAX_PLATFORMS=cpu PYTHONPATH=src python experiments/mushroom_body_reference.py

Prints, for 2500 steps at dt = 0.1 ms (250 ms of model time):
  1. the NaN-guard table (PN_KC gScale 0.5 .. 50 as one vmapped sweep) at
     the example's size (24 PN / 6 LHI / 150 KC / 12 DN) and at
     MushroomBodyConfig()'s default size (100 / 20 / 1000 / 100);
  2. single runs at the default size and at 10,000 KCs with every group's
     gScale scaled by fan-in from the example's: PN_KC and PN_LHI by
     24 / n_pn, LHI_KC by 6 / n_lhi, KC_DN by 150 / n_kc, DN_DN by
     12 / n_dn.
"""

import jax.numpy as jnp

from repro.core.models.mushroom_body import MushroomBodyConfig, compile_model

EXAMPLE = dict(n_pn=24, n_lhi=6, n_kc=150, n_dn=12)
VALUES = [0.5, 1.0, 2.0, 8.0, 50.0]
STEPS = 2500


def table(sizes: dict) -> None:
    model = compile_model(MushroomBodyConfig(**sizes))
    sweep = model.sweep_gscale("PN_KC", VALUES, n_steps=STEPS)
    print(f"\nNaN-guard table at {sizes}")
    print(" gScale |  PN Hz |  LHI Hz |  KC Hz |  DN Hz | finite")
    for i, g in enumerate(VALUES):
        r = {k: float(v[i]) for k, v in sweep.rates_hz.items()}
        print(f" {g:6.1f} | {r['PN']:6.1f} | {r['LHI']:7.1f} | "
              f"{r['KC']:6.1f} | {r['DN']:6.1f} | {bool(sweep.finite[i])}")


def fan_in(sizes: dict) -> None:
    cfg = MushroomBodyConfig(**sizes)
    gs = {"PN_KC": EXAMPLE["n_pn"] / cfg.n_pn,
          "PN_LHI": EXAMPLE["n_pn"] / cfg.n_pn,
          "LHI_KC": EXAMPLE["n_lhi"] / cfg.n_lhi,
          "KC_DN": EXAMPLE["n_kc"] / cfg.n_kc,
          "DN_DN": EXAMPLE["n_dn"] / cfg.n_dn}
    res = compile_model(cfg).run(
        STEPS, gscales={k: jnp.float32(v) for k, v in gs.items()})
    rates = {k: round(float(v), 2) for k, v in res.rates_hz.items()}
    print(f"\nfan-in gScales {gs} at {sizes}: finite {bool(res.finite)}, "
          f"rates Hz {rates}")


if __name__ == "__main__":
    table(EXAMPLE)
    table({})
    fan_in({})
    fan_in({"n_kc": 10_000})
