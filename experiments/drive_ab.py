"""The fused thalamic drive against the lambda-input route, in turns, on one
card:

    python3 experiments/drive_ab.py [--turns N]

Builds ``chip_smoke.py``'s phase 3 net (the Izhikevich net at 100k
neurons, in-degree 1000), phase 5's delayed net and, on a one-rank NCCL
mesh, phase 13a's net, and times each SNN cell of the main path with the
nets' ``NormalInput`` drives (the fused route: each population's step one
``izhikevich_step`` launch that sums its currents and hashes its normals)
and with the same draws as lambda inputs (the route before it: zeros, a
group add each, the draw kernel, the drive's add), in turns (fused,
lambda, lambda, fused, ...):

  main         ``CompiledModel.run`` of 1000 steps at B = 1, replayed
               (us/step); main_eager: 200 steps of ``Simulator.run``;
  sweep        phase 4's ``sweep_gscale``: 8 candidates x 500 steps;
  exp_izh      phase 10's search at nConn 1000: 20 candidates x 350 steps;
  delay        phase 5's run of 200 steps, replayed;
  delay_sweep  phase 5b's grid on phase 5's net, 8 x 500 steps;
  serve_izh    phase 11's drain: 16 requests of 100-200 steps in 8 slots,
               chunks of 50 (slot-steps/s);
  engine_main  phase 13a: the engine's replayed run of 1000 steps.

A route switch drops the models' captured graphs; each cell runs once
before its timed run so that the capture stays out of the times.  Every
run's spike counts are held equal between the routes.  Prints a JSON
line a cell (medians and every sample, the card's ``nvidia-smi`` name and
power limit) and writes them all to ``chiprun_out/drive_ab.json``.
Needs one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class _Lambda:
    """A population's drive as a plain input function of the same draw
    (what the nets declared before ``NormalInput``)."""

    def __init__(self, scale):
        self.scale = scale

    def __call__(self, keys, t, n):
        from repro_torch import random as R
        return R.normal(keys, (n,), scale=self.scale)


def _set_route(models, lam: bool) -> None:
    """Every model's drives as ``NormalInput`` (fused) or as lambdas, its
    captured graphs dropped."""
    from repro_torch.core.snn import neurons as TN
    for m in models:
        for pop in m.network.populations.values():
            fn = pop.input_fn
            if lam and isinstance(fn, TN.NormalInput):
                pop.input_fn = _Lambda(fn.scale)
            elif not lam and isinstance(fn, _Lambda):
                pop.input_fn = TN.NormalInput(fn.scale)
        m.backend._compiled.clear()
        m.backend._run_jit_cache.clear()
        want = set() if lam else {"exc", "inh"}
        if m.backend._takes_currents() != want:
            raise RuntimeError(f"route switch failed: "
                               f"{m.backend._takes_currents()}")


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=4,
                    help="pairs of route slots (ABBA order)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("drive_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as CS
    from repro_torch.core.models import izhikevich_net as IZ
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_snn_mesh, shutdown_distributed
    from repro_torch.launch.snn_serve import SNNServer, StreamRequest
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    _build.build()
    cfg = IZ.IzhikevichNetConfig(n_total=CS.MAIN["n_total"],
                                 n_conn=CS.MAIN["n_conn"],
                                 representation="sparse")
    main_m = IZ.compile_model(cfg)
    delay_m, _ = CS.build_delay_model(torch)
    mesh = make_snn_mesh(1)
    eng_m = IZ.compile_model(cfg, init="device", mesh=mesh)
    models = (main_m, delay_m, eng_m)
    steps = CS.MAIN["steps"]
    sweep_vals = list(CS.SWEEP["values"])
    exp = CS.EXPERIMENT["izhikevich"]
    exp_vals = list(np.linspace(0.3, 1.2, exp["candidates"]))
    S, C = CS.SNN_SERVE["streams"], CS.SNN_SERVE["chunk"]
    n_exc = main_m.network.populations["exc"].n
    reqs = CS._serve_requests(np, n_exc, CS.SNN_SERVE["izh_scale"],
                              CS.SNN_SERVE["requests"])

    def serve():
        srv = SNNServer(main_m, max_streams=S, chunk=C, stim_pops=("exc",))
        main_m.serve_chunk(srv.states, {"exc": np.zeros((S, C, n_exc),
                                                        np.float32)},
                           np.zeros(S, np.int32), C)      # the capture
        for i, (T, stim, seed) in enumerate(reqs):
            srv.submit(StreamRequest(rid=i, n_steps=T, stim={"exc": stim},
                                     seed=seed))
        d = CS._drain(torch, srv)
        counts = {r.rid: r.spike_counts["exc"].sum() for r in srv.run()}
        return d["slot_steps_per_s"], counts

    # cell -> (run returning its result, (metric, unit of work)); a run is
    # timed after an untimed one of its own (the capture)
    cells = {
        "main": (lambda: main_m.run(steps), ("us_per_step", steps)),
        "main_eager": (lambda: main_m.simulator.run(
            main_m.simulator.init_state(), 200), ("us_per_step", 200)),
        "sweep": (lambda: main_m.sweep_gscale("exc", sweep_vals,
                                              CS.SWEEP["steps"]),
                  ("candidates_per_s", len(sweep_vals))),
        "exp_izh": (lambda: main_m.sweep_gscale("exc", exp_vals,
                                                exp["n_steps"]),
                    ("candidates_per_s", len(exp_vals))),
        "delay": (lambda: delay_m.run(CS.DELAY["steps"]),
                  ("us_per_step", CS.DELAY["steps"])),
        "delay_sweep": (lambda: delay_m.sweep_gscale(
            "exc", sweep_vals, CS.DELAY["sweep_steps"]),
            ("candidates_per_s", len(sweep_vals))),
        "engine_main": (lambda: eng_m.run(steps), ("us_per_step", steps)),
    }
    samples = {k: {"fused": [], "lambda": []}
               for k in list(cells) + ["serve_izh"]}
    first = {}
    order = []
    for t in range(args.turns):
        order += ["fused", "lambda"] if t % 2 == 0 else ["lambda", "fused"]
    current = None
    for route in order:
        if route != current:
            _set_route(models, route == "lambda")
            current = route
        for name, (run, (metric, work)) in cells.items():
            run()
            secs, res = _timed(torch, run)
            samples[name][route].append(
                secs / work * 1e6 if metric == "us_per_step"
                else work / secs)
            counts = {k: v.cpu() for k, v in res.spike_counts.items()}
            if name in first:
                if not all(torch.equal(counts[k], first[name][k])
                           for k in counts):
                    raise RuntimeError(f"{name}: the {route} route's spike "
                                       f"counts differ")
            else:
                first[name] = counts
            del res
        rate, counts = serve()
        samples["serve_izh"][route].append(rate)
        if "serve_izh" in first and counts != first["serve_izh"]:
            raise RuntimeError("serve_izh: the routes' streams differ")
        first.setdefault("serve_izh", counts)
    _set_route(models, False)
    rows = []
    for name, by in samples.items():
        metric = ("slot_steps_per_s" if name == "serve_izh"
                  else cells[name][1][0])
        row = {"cell": name, "metric": metric, "nvidia_smi": smi,
               "order": order,
               **{f"{r}_median": statistics.median(v) for r, v in by.items()},
               **{f"{r}_all": v for r, v in by.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "drive_ab.json").write_text(json.dumps(rows, indent=1))
    del models, main_m, delay_m, eng_m
    shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
