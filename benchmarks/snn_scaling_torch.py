"""Construction and step-time scaling of the port:
``benchmarks/snn_scaling.py``'s series, on ``repro_torch``.

  * construction: the host's numpy initializer (``FixedFanout.resolve``)
    against on-device construction (``repro_torch.sparse.device_init.
    device_resolve``: the threefry kernels), build wall time vs network
    size; the device call is timed after a warm call, synchronized;
  * construction memory: peak construction bytes per device at a fixed
    total size, the fused ``device_init_local`` path against
    generate-then-partition (``construction_peak_model``, with k_local
    from a real fused build over D ranks), D = 1, 2, 4, ... up to the
    world size;
  * weak scaling: ``compile_model(init="device", mesh=...)`` at
    neurons-per-rank held constant, D = 1, 2, 4, ..., and the step time
    of ``CompiledModel.run`` on the sharded engine (replayed from CUDA
    graphs on a card).

Every rank of the launch runs the script (``torchrun --nproc-per-node N``
with ``--devices N``; one rank without a launcher); a series at D runs on
the first D ranks (``launch.mesh.sub_mesh``) and rank 0 writes the JSON.
Here the card is one, so D > 1 runs as gloo ranks on the CPU.

Writes ``BENCH_snn_scaling_torch.json`` under ``--out`` (default
``experiments/bench``; the JAX package's baselines are never touched) and
prints the harness CSV rows.

    PYTHONPATH=src python -m benchmarks.snn_scaling_torch [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m \\
        benchmarks.snn_scaling_torch --device cpu --devices 4

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
LEFT_OUT = ("D > 1 over NCCL needs a card a rank: one card here, so D > 1 "
            "runs as gloo ranks on the CPU")


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


def _series(mesh):
    """(D, the mesh of the first D ranks or None) for D = 1, 2, 4, ...
    up to the world size (every rank walks the series: sub-meshes are
    collective)."""
    from repro_torch.launch.mesh import sub_mesh
    d = 1
    while d <= mesh.world_size:
        yield d, sub_mesh(mesh, d)
        d *= 2


def _bench_construction_memory(per_dev: int, n_conn: int, mesh) -> list:
    """Peak construction bytes per device at a fixed total size (per_dev
    x the world size): the fused path must drop as D doubles, the
    partition path stays O(nnz).  k_local from a real fused build at each
    D, the bytes from the analytic model (deterministic numbers): the peak
    of a rank that holds only its blocks, which ``build(mesh=)`` does not
    reach yet (every rank also holds the full graph; ROADMAP item 7)."""
    from repro_torch import random as RND
    from repro_torch.sparse import device_init as DI
    from repro_torch.sparse import formats as F

    n = per_dev * mesh.world_size
    k = min(n_conn, n)
    rows = []
    for d, sub in _series(mesh):
        if sub is not None:
            out = DI.device_init_local(F.FixedFanout(k),
                                       RND.PRNGKey(0, device=mesh.device),
                                       n, n, sub,
                                       weight=F.UniformWeight(0, 0.5))
            k_local = out[5]
            peak = DI.construction_peak_model(n, k, d, k_local)
            for path, nbytes in (
                    ("fused_local", peak["fused_local_bytes"]),
                    ("generate_partition", peak["generate_partition_bytes"])):
                rows.append({"path": path, "devices": d, "n_pre": n,
                             "k": k, "k_local": k_local,
                             "peak_bytes_per_device": int(nbytes)})
                if mesh.rank == 0:
                    print(f"construct_mem_{path}_d={d}_n={n},{nbytes},"
                          "peak_bytes_per_device", flush=True)
        mesh.barrier()
    return rows


def _bench_weak_scaling_steps(per_dev: int, n_conn: int, n_steps: int,
                              mesh) -> list:
    from repro_torch.core.models.izhikevich_net import (IzhikevichNetConfig,
                                                        compile_model)
    rows = []
    for d, sub in _series(mesh):
        if sub is not None:
            n_total = per_dev * d
            cfg = IzhikevichNetConfig(n_total=n_total,
                                      n_conn=min(n_conn, n_total))
            model = compile_model(cfg, init="device", mesh=sub)
            state = model.init_state()
            model.run(n_steps, state=state)         # captures the graphs
            _sync(mesh.device)
            sub.barrier()
            t0 = time.perf_counter()
            model.run(n_steps, state=state)
            _sync(mesh.device)
            per_step_us = (time.perf_counter() - t0) / n_steps * 1e6
            rows.append({"devices": d, "n_total": n_total,
                         "neurons_per_device": per_dev,
                         "us_per_step": per_step_us})
            if mesh.rank == 0:
                print(f"weak_scaling_d={d}_n={n_total},{per_step_us:.1f},"
                      "us_per_step", flush=True)
            del model
        mesh.barrier()
    return rows


def main(argv=None) -> dict:
    import torch
    from repro_torch._device import resolve_device
    from repro_torch.launch.mesh import make_snn_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the launch (default: the process "
                         "group's, one without a launcher)")
    ap.add_argument("--out", default=str(RESULTS),
                    help="directory of the JSON file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = make_snn_mesh(args.devices, device=device)

    per_dev = int(os.environ.get("SNN_BENCH_PER_DEV", 1024))
    n_conn = int(os.environ.get("SNN_BENCH_NCONN", 64))
    n_steps = int(os.environ.get("SNN_BENCH_STEPS", 50))
    sizes = [per_dev, 2 * per_dev, 4 * per_dev]

    payload = {
        "devices": mesh.world_size,
        "backend": mesh.device.type,
        "process_group": mesh.backend,
        "device": (torch.cuda.get_device_name(mesh.device)
                   if mesh.device.type == "cuda" else "cpu"),
        "per_device_neurons": per_dev,
        "construction": _bench_construction(n_conn, sizes, mesh.device),
        "construction_memory": _bench_construction_memory(per_dev, n_conn,
                                                          mesh),
        "weak_scaling": _bench_weak_scaling_steps(per_dev, n_conn, n_steps,
                                                  mesh),
        "left_out": LEFT_OUT,
    }
    if mesh.rank == 0:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / OUT_NAME).write_text(json.dumps(payload, indent=1,
                                               default=float))
        print(f"wrote {out / OUT_NAME}", flush=True)
    return payload


if __name__ == "__main__":
    main()
