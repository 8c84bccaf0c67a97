"""Seeded-determinism smoke on the port: the same seed under 1 and N ranks
gives the same spikes (``benchmarks/determinism_smoke.py``'s check, on
``repro_torch``).

The sharded engine rests on one invariant: a simulation is a pure function
of (spec, seed), never of the rank count.  This smoke builds the JAX
script's device-initialised model (heterogeneous dendritic delays and a
homogeneous-delay group, the states most likely to break the invariant)
once on a single device (the ``Simulator``) and once over a mesh of N
ranks (the ``ShardedEngine``), and fails if any spike count, raster bit or
generated delay slot differs.

- On the CPU the N ranks are gloo ranks: one rank runs in this process, N
  > 1 are worker processes this script starts, joined over a ``file://``
  store in a temporary directory, under a wall-clock limit.
- On the card (the default device) it compares the single-device
  ``Simulator`` with one NCCL rank (the machine has one card), in this
  process; ``launch.mesh.shutdown_distributed`` ends the group.

Writes ``BENCH_determinism_torch.json`` under ``--out`` (default
``experiments/bench``) and exits non-zero on a mismatch.

    PYTHONPATH=src python -m benchmarks.determinism_smoke_torch \\
        --device cpu --devices 8
    PYTHONPATH=src python -m benchmarks.determinism_smoke_torch  # the card
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "experiments" / "bench"
OUT_NAME = "BENCH_determinism_torch.json"
SRC = ROOT / "src"
# seconds the N worker processes may take together
WORKER_TIMEOUT_S = 600.0
# environment a launcher sets; a worker takes its rank from argv instead
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT", "LOCAL_WORLD_SIZE")


def build_spec():
    """``determinism_smoke.py``'s model: an Izhikevich population driven
    by 8 N(0, 1) a step into a second one over per-synapse delays 0..3,
    and the second onto itself over a homogeneous delay of 2 steps."""
    from repro_torch import random as R
    from repro_torch.core.snn.spec import ModelSpec
    from repro_torch.core.snn.synapses import ExpDecay
    from repro_torch.sparse.formats import (FixedFanout, UniformIntDelay,
                                            UniformWeight)

    def drive(keys, t, n):
        return R.normal(keys, (n,), scale=8.0)

    s = ModelSpec("determinism")
    s.add_neuron_population("a", 48, "izhikevich", input_fn=drive)
    s.add_neuron_population("b", 24, "izhikevich")
    s.add_synapse_population("ab", "a", "b", connect=FixedFanout(6),
                             weight=UniformWeight(0, 9.0), psm=ExpDecay(4.0),
                             delay=UniformIntDelay(0, 3))
    s.add_synapse_population("bb", "b", "b", connect=FixedFanout(4),
                             weight=UniformWeight(0, 0.3), delay_steps=2)
    return s


def simulate(seed: int, steps: int, device, mesh=None) -> dict:
    """Build (``init="device"``, over ``mesh`` when given) and run; the
    run's spike counts, raster hashes and the first group's delay slots."""
    import numpy as np
    model = build_spec().build(dt=1.0, seed=seed, init="device",
                               device=None if mesh else device, mesh=mesh)
    res = model.run(steps, record_raster=True)
    return {
        "finite": bool(res.finite.all()),
        "counts": {k: v.cpu().numpy().tolist()
                   for k, v in res.spike_counts.items()},
        "raster_hash": {k: hashlib.sha256(
            v.cpu().numpy().astype(np.uint8).tobytes()).hexdigest()
            for k, v in res.raster.items()},
        "delay_slots": model.network.synapses[0].ell.delay.cpu().numpy()
        .tolist(),
    }


def _worker(rank: int, world: int, store: str, out: str, seed: int,
            steps: int) -> None:
    """One gloo rank of N: joins the group over ``file://store``, runs the
    model over the mesh, and (rank 0) writes its result to ``out``."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import (init_distributed, make_snn_mesh,
                                         shutdown_distributed)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{store}", timeout_s=120)
    try:
        res = simulate(seed, steps, "cpu", make_snn_mesh(world,
                                                         device="cpu"))
        res["devices"] = world
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        shutdown_distributed()


def _spawn(world: int, seed: int, steps: int) -> dict:
    """N gloo ranks as worker processes; rank 0's result."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), str(ROOT)] + ([env["PYTHONPATH"]]
                                 if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "r.json")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "benchmarks.determinism_smoke_torch",
             "--worker", str(r), str(world), store, out, "--seed",
             str(seed), "--steps", str(steps)], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(0.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise SystemExit(f"determinism workers ({world} ranks) passed "
                             f"the {WORKER_TIMEOUT_S:.0f} s limit")
        if any(p.returncode for p in procs) or not os.path.exists(out):
            raise SystemExit(
                f"a determinism worker ({world} ranks) failed:\n"
                + "\n".join(log[-3000:] for log in logs))
        return json.loads(Path(out).read_text())


def _one_rank(device: str, seed: int, steps: int) -> dict:
    """One rank in this process (NCCL on the card, gloo on the CPU), its
    group ended after the run."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_snn_mesh, shutdown_distributed
    try:
        res = simulate(seed, steps, device, make_snn_mesh(1, device=device))
        res["backend"] = dist.get_backend()
    finally:
        ended = shutdown_distributed()
    res["devices"] = 1
    res["group_ended"] = ended and not dist.is_initialized()
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks to compare with one device (default: 1 on "
                         "the card, 8 on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; one NCCL rank) or cpu (gloo "
                         "ranks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--worker", nargs=4, metavar=("RANK", "WORLD", "STORE",
                                                  "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, world, store, out = args.worker
        _worker(int(rank), int(world), store, out, args.seed, args.steps)
        return {}

    from repro_torch._device import resolve_device
    dev = resolve_device(args.device)
    devices = args.devices or (1 if dev.type == "cuda" else 8)
    if dev.type == "cuda" and devices != 1:
        raise SystemExit("on the card the smoke compares one NCCL rank "
                         f"(one card a rank here), not {devices}")
    t0 = time.perf_counter()
    one = simulate(args.seed, args.steps, dev)
    many = (_one_rank(args.device, args.seed, args.steps) if devices == 1
            else _spawn(devices, args.seed, args.steps))
    checks = {
        "finite": one["finite"] and many["finite"],
        "spike_counts_equal": one["counts"] == many["counts"],
        "rasters_equal": one["raster_hash"] == many["raster_hash"],
        "delay_slots_equal": one["delay_slots"] == many["delay_slots"],
    }
    if "group_ended" in many:
        checks["process_group_ended"] = many["group_ended"]
    payload = {
        "seed": args.seed, "steps": args.steps, "device": str(dev),
        "backend": many.get("backend", "gloo"),
        "devices_compared": [1, devices], "checks": checks,
        "wall_s": time.perf_counter() - t0,
    }
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / OUT_NAME).write_text(json.dumps(payload, indent=1))
    print(f"wrote {out_dir / OUT_NAME}", flush=True)
    for name, ok in checks.items():
        print(f"determinism_{name}: {'OK' if ok else 'MISMATCH'}",
              flush=True)
    if not all(checks.values()):
        raise SystemExit(
            f"seeded-determinism smoke FAILED: {checks}: the same seed "
            f"gave different results on 1 device and {devices} ranks")
    return payload


if __name__ == "__main__":
    main()
    sys.exit(0)
