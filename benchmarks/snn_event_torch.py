"""Spike propagation by firing rate on the port: ``benchmarks/snn_event.py``'s
sweep, on ``repro_torch`` (one card, or the CPU with ``--device cpu``).

Sweeps firing rate x propagation mode on one static synapse group and
times ``SynapseGroup.step`` over a precomputed Bernoulli raster at each
rate, so the activity level is exact and every mode runs the identical
workload.  In the port both propagation modes, "dense" and "event", run
the one hand-written live-row ELL kernel (it skips silent presynaptic rows
itself; ``repro_torch/core/snn/synapses.py``), so the two rows measure the
same path; the JSON's ``propagation`` says so.  A third row, "gemv", is
the dense representation: the [n_pre, n_post] float32 matrix and one
matrix-vector product a step (cuBLAS).  On the card each timed scan of
``n_steps`` steps is replayed from one CUDA graph (the JAX script jits a
scan), best of ``reps``; on the CPU it runs eagerly.

Writes ``BENCH_snn_event_torch.json`` under ``--out`` (default
``experiments/bench``) and prints harness CSV rows.

    PYTHONPATH=src python -m benchmarks.snn_event_torch [--device cpu]

Env knobs (the JAX script's): SNN_EVENT_BENCH_N (pre/post neurons,
default 4096), SNN_EVENT_BENCH_NCONN (fanout, default 64),
SNN_EVENT_BENCH_STEPS (default 200), SNN_EVENT_BENCH_REPS (default 3),
SNN_EVENT_BENCH_RATES (percent list, default "1,5,10,25").  The graph is
built on the device (``device_init.device_resolve``) in place of the JAX
script's host numpy draw.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[1] / "experiments" / "bench"
OUT_NAME = "BENCH_snn_event_torch.json"

# speedup rows are gated only where the event path is supposed to win
GATED_RATE_PCT = 5.0
MODES = ("dense", "event", "gemv")
PROPAGATION = ("'dense' and 'event' run the same live-row ELL kernel "
               "(ell_spmv_live_kernel, which skips silent rows itself); "
               "'gemv' is the dense representation's float32 "
               "matrix-vector product")


def _build_ell(n_pre: int, n_conn: int, device):
    from repro_torch import random as RND
    from repro_torch.sparse import device_init as DI
    from repro_torch.sparse import formats as F

    post, g, valid = DI.device_resolve(
        F.FixedFanout(n_conn), RND.PRNGKey(0, device=device), n_pre, n_pre,
        F.UniformWeight(0.0, 1.0))
    return F.triple_to_ell(post, g, valid, n_pre)


def _group(ell, mode: str):
    from repro_torch.core.snn.synapses import SynapseGroup
    if mode == "gemv":
        return SynapseGroup(name="bench_gemv", pre="pop", post="pop",
                            ell=ell, representation="dense",
                            propagation="dense")
    return SynapseGroup(name=f"bench_{mode}", pre="pop", post="pop", ell=ell,
                        representation="sparse", propagation=mode)


def _scan(group, raster, acc) -> None:
    """n_steps of ``group.step`` over the raster [n_steps, 1, n_pre], the
    currents summed into ``acc`` [1, n_post] in place."""
    st = group.init_state(1)
    for i in range(raster.shape[0]):
        st, cur = group.step(st, raster[i], 1.0, 1.0)
        acc.add_(cur)


def _time_mode(group, raster, reps: int) -> float:
    import torch
    acc = torch.zeros((1, group.ell.n_post), device=raster.device)
    if raster.device.type != "cuda":
        _scan(group, raster, acc)                    # warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _scan(group, raster, acc)
            best = min(best, time.perf_counter() - t0)
        return best
    side = torch.cuda.Stream(raster.device)
    side.wait_stream(torch.cuda.current_stream(raster.device))
    with torch.cuda.stream(side):                  # kernels, plans, memory
        _scan(group, raster[:1], acc)
    torch.cuda.current_stream(raster.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _scan(group, raster, acc)
    graph.replay()                                 # warm the replay
    torch.cuda.synchronize(raster.device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize(raster.device)
        best = min(best, time.perf_counter() - t0)
    del graph
    return best


def main(argv=None) -> dict:
    import numpy as np
    import torch
    from repro_torch._device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--out", default=str(RESULTS),
                    help="directory of the JSON file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n_pre = int(os.environ.get("SNN_EVENT_BENCH_N", 4096))
    n_conn = int(os.environ.get("SNN_EVENT_BENCH_NCONN", 64))
    n_steps = int(os.environ.get("SNN_EVENT_BENCH_STEPS", 200))
    reps = int(os.environ.get("SNN_EVENT_BENCH_REPS", 3))
    rates = [float(r) for r in os.environ.get(
        "SNN_EVENT_BENCH_RATES", "1,5,10,25").split(",")]
    n_conn = min(n_conn, n_pre)

    ell = _build_ell(n_pre, n_conn, device)
    groups = {m: _group(ell, m) for m in ("dense", "event")}
    cap = groups["event"].event_capacity
    print(f"event_capacity={cap} ({(cap or 0) / n_pre:.1%} of {n_pre} "
          "rows)", flush=True)

    rng = np.random.default_rng(7)
    rasters = [torch.from_numpy(rng.random((n_steps, 1, n_pre))
                                < rate / 100.0).to(device) for rate in rates]
    us = {r: {} for r in rates}
    rows = []
    for mode in MODES:
        # the dense matrix is n_pre x n_pre float32: made for its row alone
        group = groups[mode] if mode in groups else _group(ell, mode)
        for rate, raster in zip(rates, rasters):
            wall = _time_mode(group, raster, reps)
            us[rate][mode] = wall / n_steps * 1e6
            rows.append({"mode": mode, "rate_pct": rate, "wall_s": wall,
                         "us_per_step": us[rate][mode]})
            print(f"mode={mode},rate={rate},{us[rate][mode]:.1f},"
                  "us_per_step", flush=True)
        del group
    del groups
    speedups = []
    for rate in rates:
        speedup = us[rate]["dense"] / us[rate]["event"]
        entry = {"rate_pct": rate, "dense_us_per_step": us[rate]["dense"],
                 "event_us_per_step": us[rate]["event"],
                 "gemv_us_per_step": us[rate]["gemv"],
                 "gemv_over_event": us[rate]["gemv"] / us[rate]["event"]}
        if rate <= GATED_RATE_PCT:
            entry["event_speedup"] = speedup
        else:
            entry["event_speedup_ungated"] = speedup
        speedups.append(entry)
        print(f"speedup,rate={rate},{speedup:.2f}x, gemv/event "
              f"{entry['gemv_over_event']:.2f}x", flush=True)

    payload = {
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "n_pre": n_pre,
        "n_conn": n_conn,
        "n_steps": n_steps,
        "event_capacity": cap,
        "propagation": PROPAGATION,
        "modes": rows,
        "speedups": speedups,
    }
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / OUT_NAME).write_text(json.dumps(payload, indent=1,
                                           default=float))
    print(f"wrote {out / OUT_NAME}", flush=True)
    return payload


if __name__ == "__main__":
    main()
