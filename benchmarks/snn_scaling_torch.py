"""Construction and step-time scaling of the port on one card:
``benchmarks/snn_scaling.py``'s single-device series, on ``repro_torch``.

  * construction: the host's numpy initializer (``FixedFanout.resolve``)
    against on-device construction (``repro_torch.sparse.device_init.
    device_resolve``: the threefry kernels), build wall time vs network
    size; the device call is timed after a warm call, synchronized;
  * weak scaling at D = 1: ``compile_model(init="device")`` and the step
    time of ``CompiledModel.run`` (replayed from CUDA graphs on the card).

The JAX script's ``construction_memory`` rows (the fused per-device path)
and its D > 1 rows need the sharded engine (ROADMAP Queue 1 item 7); the
JSON says so in ``left_out``.

Writes ``BENCH_snn_scaling_torch.json`` under ``--out`` (default
``experiments/bench``; the JAX package's baselines are never touched) and
prints the harness CSV rows.

    PYTHONPATH=src python -m benchmarks.snn_scaling_torch [--device cpu]

Env knobs (the JAX script's): SNN_BENCH_PER_DEV (neurons, default 1024;
sizes per_dev, 2 per_dev, 4 per_dev), SNN_BENCH_NCONN (fanout, default
64), SNN_BENCH_STEPS (default 50).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[1] / "experiments" / "bench"
OUT_NAME = "BENCH_snn_scaling_torch.json"
LEFT_OUT = ("construction_memory and the D > 1 weak-scaling rows need the "
            "sharded engine and device_init_local (ROADMAP Queue 1 item 7); "
            "one device here")


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench_construction(n_conn: int, sizes, device) -> list:
    import numpy as np
    from repro_torch import random as RND
    from repro_torch.obs import trace
    from repro_torch.sparse import device_init as DI
    from repro_torch.sparse import formats as F

    rows = []
    for n in sizes:
        k = min(n_conn, n)
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        F.FixedFanout(k).resolve(rng, n, n, F.UniformWeight(0, 0.5))
        host_s = time.perf_counter() - t0

        key = RND.PRNGKey(0, device=device)
        args = (F.FixedFanout(k), key, n, n, F.UniformWeight(0, 0.5))
        DI.device_resolve(*args)            # warm: kernel builds, plans
        _sync(device)
        trace.clear()
        t0 = time.perf_counter()
        out = DI.device_resolve(*args)
        _sync(device)
        dev_s = time.perf_counter() - t0
        rounds = [e["args"]["rounds"] for e in trace.events()
                  if e.get("name") == "device_init.redraw"]
        del out
        rows.append({"n": n, "n_conn": k, "host_s": host_s,
                     "device_s": dev_s,
                     "speedup": host_s / max(dev_s, 1e-9),
                     "redraw_rounds": rounds[0] if rounds else 0})
        print(f"construct_n={n},{dev_s * 1e6:.1f},"
              f"host_us={host_s * 1e6:.1f} speedup={rows[-1]['speedup']:.1f}",
              flush=True)
    return rows


def _bench_weak_scaling_steps(per_dev: int, n_conn: int, n_steps: int,
                              device) -> list:
    from repro_torch.core.models.izhikevich_net import (IzhikevichNetConfig,
                                                        compile_model)
    cfg = IzhikevichNetConfig(n_total=per_dev, n_conn=min(n_conn, per_dev))
    model = compile_model(cfg, device=device, init="device")
    state = model.init_state()
    model.run(n_steps, state=state)                 # captures the graphs
    _sync(device)
    t0 = time.perf_counter()
    model.run(n_steps, state=state)
    _sync(device)
    per_step_us = (time.perf_counter() - t0) / n_steps * 1e6
    print(f"weak_scaling_d=1_n={per_dev},{per_step_us:.1f},us_per_step",
          flush=True)
    return [{"devices": 1, "n_total": per_dev, "neurons_per_device": per_dev,
             "us_per_step": per_step_us}]


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

    per_dev = int(os.environ.get("SNN_BENCH_PER_DEV", 1024))
    n_conn = int(os.environ.get("SNN_BENCH_NCONN", 64))
    n_steps = int(os.environ.get("SNN_BENCH_STEPS", 50))
    sizes = [per_dev, 2 * per_dev, 4 * per_dev]

    payload = {
        "devices": 1,
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "per_device_neurons": per_dev,
        "construction": _bench_construction(n_conn, sizes, device),
        "construction_memory": [],
        "weak_scaling": _bench_weak_scaling_steps(per_dev, n_conn, n_steps,
                                                  device),
        "left_out": LEFT_OUT,
    }
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / OUT_NAME).write_text(json.dumps(payload, indent=1,
                                           default=float))
    print(f"wrote {out / OUT_NAME}", flush=True)
    return payload


if __name__ == "__main__":
    main()
