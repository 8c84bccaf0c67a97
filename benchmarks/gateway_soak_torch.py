"""Gateway soak on the PyTorch/CUDA port: ``benchmarks/gateway_soak.py``'s
drive, on ``repro_torch`` (one card, or the CPU with ``--device cpu``).

Sustain many deadline-bearing streams through one gateway and show (a) the
per-step p99 latency stays flat across the run (no drift as slots churn,
tables resize and expired streams are evicted) and (b) every stream that
was not evicted equals an offline ``model.run`` with the same seed and
stimulus, spike count for spike count.

Traffic: bursts against a bounded admission queue (rejected submits retry
after a tick), every ``evict_every``-th request with a deadline it cannot
meet (queued and mid-flight eviction), the rest with a generous one.

Writes ``experiments/bench/BENCH_gateway_soak_torch.json`` (its own file:
the JAX package's baselines are never touched).

    PYTHONPATH=src python -m benchmarks.gateway_soak_torch --streams 1000
    PYTHONPATH=src python -m benchmarks.gateway_soak_torch --device cpu \\
        --streams 120 --n-steps 24 --chunk 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

RESULTS = Path(__file__).resolve().parents[1] / "experiments" / "bench"
OUT_NAME = "BENCH_gateway_soak_torch.json"


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


def run_soak(streams: int = 1000, n_total: int = 40, n_conn: int = 8,
             n_steps: int = 24, chunk: int = 8, buckets=(8, 16, 32),
             max_queue: int = 48, burst: int = 32,
             deadline_ms: float = 120_000.0, evict_every: int = 9,
             verify: bool = True, warm: bool = True, seed: int = 0,
             device=None) -> Dict:
    """Drive ``streams`` requests through one gateway; returns the metrics
    row the JSON and the assertions read (the JAX script's, without
    ``devices``).  Most requests get ``deadline_ms`` (they must finish),
    every ``evict_every``-th ~0 (it must be evicted); rejected submits are
    retried after a tick, so every request flows through the gateway."""
    import numpy as np
    from repro_torch import random as R
    from repro_torch.core.models.izhikevich_net import (IzhikevichNetConfig,
                                                        compile_model)
    from repro_torch.launch.gateway import Gateway, GatewayOverloaded

    model = compile_model(IzhikevichNetConfig(n_total=n_total,
                                              n_conn=min(n_conn, n_total)),
                          device=device)
    gw = Gateway(chunk=chunk, buckets=buckets, max_queue=max_queue,
                 warm=warm)
    gw.register("soak", model, stim_pops=("exc",))
    worker = gw.workers["soak"]
    n = model.network.populations["exc"].n
    rng = np.random.default_rng(seed)

    rejected_submits = 0
    submitted = 0
    t0 = time.perf_counter()
    i = 0
    while i < streams:
        for _ in range(min(burst, streams - i)):
            stim = {"exc": (3.0 * rng.normal(size=(n_steps, n)))
                    .astype(np.float32)}
            dl = 0.01 if (i % evict_every == evict_every - 1) else deadline_ms
            while True:
                try:
                    gw.submit("soak", stim, n_steps, seed=10_000 + i,
                              deadline_ms=dl)
                    submitted += 1
                    break
                except GatewayOverloaded:
                    rejected_submits += 1
                    gw.tick()        # serve a chunk, then retry
            i += 1
        gw.tick()                    # interleave serving with arrivals
    gw.run_until_drained()
    wall_s = time.perf_counter() - t0

    done = gw.collect_finished()
    completed = [r for r in done if r.status == "done"]
    evicted = [r for r in done if r.evicted]
    metrics = gw.metrics()["models"]["soak"]

    # flatness: p99 per-step latency, first half of the run vs second half
    lat = worker.step_latency_us.samples()
    half = len(lat) // 2
    p99_a = _percentile(lat[:half], 0.99)
    p99_b = _percentile(lat[half:], 0.99)
    flat_ratio = (p99_b / p99_a) if p99_a > 0 else 1.0

    verified = 0
    if verify:
        for r in completed:
            res = model.run(r.n_steps, stim=r.stim,
                            state=model.init_state(key=R.PRNGKey(r.seed)))
            for k, v in res.spike_counts.items():
                if not np.array_equal(v.cpu().numpy(), r.spike_counts[k]):
                    raise AssertionError(
                        f"stream {r.rid} population {k!r}: served spike "
                        "counts diverged from the offline run; eviction or "
                        "resize perturbed a surviving stream")
            verified += 1

    return {
        "streams": streams, "device": str(model.device), "chunk": chunk,
        "n_steps": n_steps, "buckets": list(worker.buckets),
        "max_queue": max_queue, "wall_s": wall_s,
        "submitted": submitted, "completed": len(completed),
        "evicted": len(evicted), "rejected_submits": rejected_submits,
        "occupancy": metrics["occupancy"],
        "steps_per_sec": metrics["slot_steps"] / max(wall_s, 1e-9),
        "p50_step_us": _percentile(lat, 0.50),
        "p99_step_us": _percentile(lat, 0.99),
        "p99_flat_ratio": flat_ratio,
        "p50_queue_wait_s": metrics["queue_wait_s"]["p50"],
        "p99_queue_wait_s": metrics["queue_wait_s"]["p99"],
        "verified_streams": verified,
        "counters": metrics["counters"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="gateway soak (port)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streams", type=int, default=1000)
    ap.add_argument("--n-total", type=int, default=40)
    ap.add_argument("--n-steps", type=int, default=24)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--buckets", default="8,16,32")
    ap.add_argument("--max-queue", type=int, default=48)
    ap.add_argument("--burst", type=int, default=32)
    ap.add_argument("--deadline-ms", type=float, default=120_000.0)
    ap.add_argument("--evict-every", type=int, default=9)
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the per-stream offline exactness check")
    ap.add_argument("--flat-tolerance", type=float, default=3.0,
                    help="fail when second-half p99 per-step latency is "
                         "more than this factor of the first half")
    ap.add_argument("--min-occupancy", type=float, default=0.3)
    ap.add_argument("--require-rejections", action="store_true",
                    help="fail unless backpressure rejected >= 1 submit")
    ap.add_argument("--require-evictions", action="store_true",
                    help="fail unless deadlines evicted >= 1 stream")
    args = ap.parse_args(argv)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    row = run_soak(streams=args.streams, n_total=args.n_total,
                   n_steps=args.n_steps, chunk=args.chunk, buckets=buckets,
                   max_queue=args.max_queue, burst=args.burst,
                   deadline_ms=args.deadline_ms,
                   evict_every=args.evict_every,
                   verify=not args.no_verify, device=args.device)

    payload = {"device": row["device"], "model": f"izhikevich_{args.n_total}",
               "n_total": args.n_total, "summary": [row]}
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / OUT_NAME).write_text(json.dumps(payload, indent=1,
                                               default=float))
    print(f"[gateway_soak_torch] {row['completed']} completed, "
          f"{row['evicted']} evicted, {row['rejected_submits']} rejected "
          f"submits in {row['wall_s']:.1f}s "
          f"({row['steps_per_sec']:.0f} steps/s, "
          f"occupancy {row['occupancy']:.2f})")
    print(f"[gateway_soak_torch] per-step latency "
          f"p50={row['p50_step_us']:.0f}us p99={row['p99_step_us']:.0f}us "
          f"flat-ratio {row['p99_flat_ratio']:.2f} "
          f"(verified {row['verified_streams']} streams exact)")
    print(f"wrote {RESULTS / OUT_NAME}", flush=True)

    failures = []
    if row["completed"] + row["evicted"] != args.streams:
        failures.append(
            f"lost streams: {row['completed']}+{row['evicted']} != "
            f"{args.streams}")
    if row["evicted"] < args.streams // args.evict_every:
        failures.append(
            f"expected >= {args.streams // args.evict_every} evictions "
            f"(every {args.evict_every}th request has a ~0 deadline), "
            f"got {row['evicted']}")
    if row["p99_flat_ratio"] > args.flat_tolerance:
        failures.append(
            f"per-step p99 latency not flat: second half is "
            f"{row['p99_flat_ratio']:.2f}x the first half "
            f"(tolerance {args.flat_tolerance}x)")
    if row["occupancy"] < args.min_occupancy:
        failures.append(f"slot occupancy {row['occupancy']:.2f} below "
                        f"{args.min_occupancy}")
    if args.require_rejections and row["rejected_submits"] == 0:
        failures.append("backpressure never rejected a submit")
    if args.require_evictions and row["evicted"] == 0:
        failures.append("deadlines never evicted a stream")
    if failures:
        for f in failures:
            print(f"[gateway_soak_torch] FAILED: {f}", file=sys.stderr)
        return 1
    print("[gateway_soak_torch] all SLO assertions passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
