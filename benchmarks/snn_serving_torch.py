"""Streams-vs-throughput benchmark of the port's SNN streaming server:
``benchmarks/snn_serving.py``'s sweep, on ``repro_torch`` (one card, or the
CPU with SNN_SERVE_BENCH_DEVICE=cpu).

For a fixed network, sweep the number of stream slots (1, 2, 4, ... up to
SNN_SERVE_BENCH_STREAMS) and measure aggregate serving throughput: all
slots advance together in one replayed chunk graph, so throughput should
grow with streams until the card saturates.  Each row also records p50/p99
per-request total latency (submit to finish) and the last chunk's phases
(host assembly, stim copy and replay by CUDA events, wait and readback).

Writes ``experiments/bench/BENCH_snn_serving_torch.json`` (its own file:
the JAX package's baselines are never touched).

    PYTHONPATH=src python -m benchmarks.snn_serving_torch

Env knobs: SNN_SERVE_BENCH_STREAMS (max slots, default 8),
SNN_SERVE_BENCH_STEPS (stimulus length, default 200), SNN_SERVE_BENCH_N
(neurons, default 500), SNN_SERVE_BENCH_CHUNK (default 50),
SNN_SERVE_BENCH_DEVICE (default cuda).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[1] / "experiments" / "bench"
OUT_NAME = "BENCH_snn_serving_torch.json"


def _percentile(xs, q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


def _bench_streams(model, stim_pop: str, max_streams: int, chunk: int,
                   n_steps: int) -> list:
    import numpy as np
    from repro_torch.launch.snn_serve import SNNServer, StreamRequest

    n = model.network.populations[stim_pop].n

    def one_trial(s: int):
        srv = SNNServer(model, max_streams=s, chunk=chunk,
                        stim_pops=(stim_pop,))
        rng = np.random.default_rng(0)
        # 2x oversubscription so slot turnover (admit/evict) is measured too
        for i in range(2 * s):
            stim = {stim_pop: (3.0 * rng.normal(size=(n_steps, n)))
                    .astype(np.float32)}
            srv.submit(StreamRequest(rid=i, n_steps=n_steps, stim=stim,
                                     seed=i))
        # the first chunk captures the graph: not timed
        srv.serve_step()
        pre = srv.total_slot_steps
        t0 = time.perf_counter()
        srv.run()
        wall = time.perf_counter() - t0
        served = srv.total_slot_steps - pre
        totals = [t.total_s for t in srv.sched.timings.values()
                  if t.finished_at is not None]
        return (served, wall, srv.stats()["slot_utilization"], totals,
                dict(srv.last_chunk_phases))

    rows = []
    s = 1
    while s <= max_streams:
        # best of 2: host noise easily dwarfs the effect measured
        served, wall, util, totals, phases = min(
            (one_trial(s) for _ in range(2)), key=lambda r: r[1] / r[0])
        steps_per_sec = served / max(wall, 1e-9)
        rows.append({
            "streams": s, "requests": 2 * s, "chunk": chunk,
            "n_steps": n_steps, "slot_steps": served, "wall_s": wall,
            "steps_per_sec": steps_per_sec, "utilization": util,
            "p50_total_s": _percentile(totals, 0.50),
            "p99_total_s": _percentile(totals, 0.99),
            "last_chunk_phases": phases,
        })
        print(f"serving_streams={s},{steps_per_sec:.1f},steps_per_sec "
              f"util={util:.2f} p99_total={rows[-1]['p99_total_s']:.3f}s",
              flush=True)
        s *= 2
    return rows


def main() -> None:
    from repro_torch.core.models.izhikevich_net import (IzhikevichNetConfig,
                                                        compile_model)

    max_streams = int(os.environ.get("SNN_SERVE_BENCH_STREAMS", 8))
    n_steps = int(os.environ.get("SNN_SERVE_BENCH_STEPS", 200))
    n_total = int(os.environ.get("SNN_SERVE_BENCH_N", 500))
    chunk = int(os.environ.get("SNN_SERVE_BENCH_CHUNK", 50))
    device = os.environ.get("SNN_SERVE_BENCH_DEVICE", "cuda")

    cfg = IzhikevichNetConfig(n_total=n_total, n_conn=min(64, n_total))
    model = compile_model(cfg, device=device)
    payload = {
        "device": str(model.device),
        "model": model.spec.name,
        "n_total": n_total,
        "streams": _bench_streams(model, "exc", max_streams, chunk,
                                  n_steps),
    }
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / OUT_NAME).write_text(json.dumps(payload, indent=1,
                                               default=float))
    print(f"wrote {RESULTS / OUT_NAME}", flush=True)


if __name__ == "__main__":
    main()
