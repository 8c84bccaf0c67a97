"""Probe overhead on the port: ``benchmarks/snn_probes.py``'s step time with
0 / 1 / 4 declared probes, on ``repro_torch`` (one card, or the CPU with
``--device cpu``).

Probes write device-resident rings inside the step (spike probes as
GeNN's 32x bitmask words, ``kernels/csrc/spike_bitmask.cu``); recording
must stay off the hot path when unused (the 0-probe row) and cost roughly
one masked row write per probe per step when used.  ``CompiledModel.run``
replays its steps from CUDA graphs on the card (the JAX script jits a
scan); each row is the best of ``reps`` runs after a warm run that
captures.

Writes ``BENCH_snn_probes_torch.json`` under ``--out`` (default
``experiments/bench``) and prints harness CSV rows.

    PYTHONPATH=src python -m benchmarks.snn_probes_torch [--device cpu]

Env knobs (the JAX script's): SNN_PROBE_BENCH_N (neurons, default 500),
SNN_PROBE_BENCH_NCONN (fanout, default 64), SNN_PROBE_BENCH_STEPS
(default 200), SNN_PROBE_BENCH_REPS (default 3).  The net is built on the
device (``build(init="device")``), where the JAX script draws it on the
host.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[1] / "experiments" / "bench"
OUT_NAME = "BENCH_snn_probes_torch.json"

PROBE_SETS = {
    0: [],
    1: [("v", "exc", "V", {"every": 1})],
    4: [("v", "exc", "V", {"every": 1}),
        ("spk", "exc", "spikes", {"every": 1}),
        ("u", "exc", "U", {"every": 4}),
        ("v_mean", "exc", "V", {"reduce": "mean"})],
}


def _build(n_total: int, n_conn: int, n_probes: int, device):
    from repro_torch.core.models.izhikevich_net import (IzhikevichNetConfig,
                                                        spec)

    cfg = IzhikevichNetConfig(n_total=n_total, n_conn=n_conn, seed=0)
    ms = spec(cfg)
    for name, target, var, kw in PROBE_SETS[n_probes]:
        ms.probe(name, target, var, **kw)
    return ms.build(dt=cfg.dt, seed=cfg.seed, device=device,
                    init="device")


def _time_run(model, n_steps: int, reps: int) -> float:
    import torch

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    state = model.init_state()
    model.run(n_steps, state=state)                 # captures the graphs
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        model.run(n_steps, state=state)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> dict:
    import torch
    from repro_torch._device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--out", default=str(RESULTS),
                    help="directory of the JSON file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n_total = int(os.environ.get("SNN_PROBE_BENCH_N", 500))
    n_conn = int(os.environ.get("SNN_PROBE_BENCH_NCONN", 64))
    n_steps = int(os.environ.get("SNN_PROBE_BENCH_STEPS", 200))
    reps = int(os.environ.get("SNN_PROBE_BENCH_REPS", 3))
    n_conn = min(n_conn, n_total)

    rows = []
    base_us = None
    for n_probes in sorted(PROBE_SETS):
        model = _build(n_total, n_conn, n_probes, device)
        wall = _time_run(model, n_steps, reps)
        del model
        us_per_step = wall / n_steps * 1e6
        if n_probes == 0:
            base_us = us_per_step
        rows.append({
            "probes": n_probes, "n_steps": n_steps, "wall_s": wall,
            "us_per_step": us_per_step,
            "overhead_vs_unprobed": (us_per_step / base_us
                                     if base_us else 1.0),
        })
        print(f"probe_overhead={n_probes},{us_per_step:.1f},us_per_step "
              f"x{rows[-1]['overhead_vs_unprobed']:.2f}", flush=True)

    payload = {
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "n_total": n_total,
        "n_conn": n_conn,
        "n_steps": n_steps,
        "probe_overhead": rows,
    }
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / OUT_NAME).write_text(json.dumps(payload, indent=1,
                                           default=float))
    print(f"wrote {out / OUT_NAME}", flush=True)
    return payload


if __name__ == "__main__":
    main()
