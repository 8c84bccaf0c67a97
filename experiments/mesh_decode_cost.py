"""What a one-rank NCCL mesh adds to a decode step and a training step,
on one card.

    python3 experiments/mesh_decode_cost.py [--rounds 4] [--steps 20]
    python3 experiments/mesh_decode_cost.py --train [--rounds 4]

qwen2-0.5b at full width, a wave of 8 prompts of 1024 tokens prefilled
once a variant, then ``--steps`` greedy decode steps timed on the host
clock (synchronised), in turns, ``--rounds`` times:

- ``plain``: ``transformer.decode_step`` without a mesh;
- ``mesh``: what ``Server.step`` runs on a 1 x 1 mesh: the caches
  loaded from and stored to ``cache_shardings``' layout around
  ``decode_step`` under ``activate``;
- ``mesh_no_layout``: ``decode_step`` under ``activate`` on the local
  caches, without the load and store.

With ``--train``: granite-moe-1b-a400m at full width, the trainer's step
(``launch.train.make_train_step``: loss, backward, AdamW) on a batch of
4 x 2048, ``plain`` (unplaced params) against ``mesh`` (params placed on
the 1 x 1 mesh, as ``run(model_parallel=1)`` places them), 3 steps a
round after one warm step.

It prints each variant's ms/step per round, the collectives a step (by
counting ``torch.distributed.all_reduce`` / ``all_gather_into_tensor``
calls) and, from one ``torch.profiler`` window a variant, the device ops,
device busy ms and CPU-side ops a step and the top host ops by self
time.  Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _counting(dist, counts: dict):
    real = {n: getattr(dist, n) for n in ("all_reduce",
                                           "all_gather_into_tensor")}

    def wrap(name):
        def f(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return real[name](*a, **k)
        return f
    for n in real:
        setattr(dist, n, wrap(n))
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(dist, n, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("mesh_decode_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import serve as S
    from repro_torch.launch import sharding as SH
    from repro_torch.models import transformer as T

    if args.train:
        return _train(args, torch, dist)
    cfg = get_config("qwen2-0.5b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.tensor(np.random.default_rng(0).integers(
        3, cfg.vocab, (8, 1024)), device="cuda")
    MESH.init_distributed(backend="nccl")
    try:
        mesh = MESH.make_local_mesh(1)
        placed = SH.place_params(params, mesh)
        with SH.activate(mesh), torch.no_grad():
            view = T.compute_view(placed, cfg)
        layout = S._CacheLayout(cfg, mesh, 8, 2048, torch.bfloat16)

        def setup(name):
            with torch.no_grad():
                if name == "plain":
                    logits, caches = T.prefill(params, cfg, toks,
                                               max_seq=2048)
                    return {"caches": caches, "tok": logits.argmax(-1)}
                with SH.activate(mesh, batch_sharded=True):
                    logits, caches = T.prefill(view, cfg, toks,
                                               max_seq=2048)
                if name == "mesh":
                    caches = layout.store(caches, joined=True)
                return {"caches": caches, "tok": logits.argmax(-1)}

        def step(name, box):
            with torch.no_grad():
                if name == "plain":
                    logits, box["caches"] = T.decode_step(
                        params, cfg, box["caches"], box["tok"])
                elif name == "mesh":
                    with SH.activate(mesh, batch_sharded=True):
                        local = layout.load(box["caches"])
                        logits, local = T.decode_step(view, cfg, local,
                                                      box["tok"])
                        box["caches"] = layout.store(local)
                else:
                    with SH.activate(mesh, batch_sharded=True):
                        logits, box["caches"] = T.decode_step(
                            view, cfg, box["caches"], box["tok"])
            box["tok"] = logits.argmax(-1)

        names = ("plain", "mesh", "mesh_no_layout")
        out = {n: {"ms_per_step": []} for n in names}
        for r in range(args.rounds):
            order = names if r % 2 == 0 else names[::-1]
            for name in order:
                box = setup(name)
                step(name, box)                    # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    step(name, box)
                box["tok"].cpu()
                torch.cuda.synchronize()
                out[name]["ms_per_step"].append(
                    (time.perf_counter() - t0) / args.steps * 1e3)
        for name in names:
            box = setup(name)
            step(name, box)
            out[name].update(_profiled(torch, dist, lambda: step(name, box),
                                       5, lambda: box["tok"].cpu()))
    finally:
        MESH.shutdown_distributed()
    return _report(out, "mesh_decode_cost.json")


def _profiled(torch, dist, run, n: int, sync) -> dict:
    """Collectives of one ``run()``, then a profile of ``n`` runs."""
    from torch.profiler import ProfilerActivity, profile
    counts: dict = {}
    with _counting(dist, counts):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        sync()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    dev = [e for e in ev if e.device_type.name == "CUDA"]
    host = sorted(((e.key, e.count / n, e.self_cpu_time_total / n / 1e3)
                   for e in ev if e.device_type.name == "CPU"),
                  key=lambda x: -x[2])
    return {"collectives_per_step": counts,
            "device_ops_per_step": sum(e.count for e in dev) / n,
            "device_ms_per_step": sum(e.self_device_time_total
                                      for e in dev) / n / 1e3,
            "cpu_ops_per_step": sum(e.count for e in ev
                                    if e.device_type.name == "CPU") / n,
            "top_host_ms_per_step": [(k, c, round(ms, 4))
                                     for k, c, ms in host[:12]]}


def _report(out: dict, fname: str) -> int:
    smi = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    for name, o in out.items():
        print(name, json.dumps(o))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / fname).write_text(json.dumps(out, indent=1))
    return 0


def _train(args, torch, dist) -> int:
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    cfg = get_config("granite-moe-1b-a400m")
    ocfg = adamw.AdamWConfig(lr=3e-4, grad_clip=1.0)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=2048,
                                     global_batch=4, seed=0),
                          device="cuda").next_batch()
    MESH.init_distributed(backend="nccl")
    try:
        mesh = MESH.make_local_mesh(1)
        states = {}
        for name in ("plain", "mesh"):
            p = T.init_params(cfg, torch.Generator(
                device="cuda").manual_seed(0))
            if name == "mesh":
                p = SH.place_params(p, mesh)
            states[name] = {"p": p, "o": adamw.init(ocfg, p),
                            "fn": TR.make_train_step(
                                cfg, ocfg, mesh if name == "mesh" else None)}
            del p

        def step(name):
            st = states[name]
            st["p"], st["o"], st["m"] = st["fn"](st["p"], st["o"], batch)

        out = {n: {"ms_per_step": []} for n in states}
        for name in states:
            step(name)                             # warm
        for r in range(args.rounds):
            order = ("plain", "mesh") if r % 2 == 0 else ("mesh", "plain")
            for name in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    step(name)
                float(states[name]["m"]["loss"])
                torch.cuda.synchronize()
                out[name]["ms_per_step"].append(
                    (time.perf_counter() - t0) / 3 * 1e3)
        for name in states:
            out[name].update(_profiled(
                torch, dist, lambda: step(name), 2,
                lambda: float(states[name]["m"]["loss"])))
    finally:
        MESH.shutdown_distributed()
    return _report(out, "mesh_train_cost.json")


if __name__ == "__main__":
    sys.exit(main())
