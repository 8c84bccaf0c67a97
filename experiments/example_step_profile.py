"""Time and profile training steps of examples/train_lm_torch.py's models on
the card, for one tree, so that two versions of the float32 flash route
(for example this tree's and an earlier commit's) are held side by side:

    python3 experiments/example_step_profile.py [--src DIR] [--tag NAME]
        [--steps N] [--profile-steps K]

``DIR`` holds the ``repro_torch`` package to run (default: this tree's
``src``); an earlier commit's comes from ``git archive <commit> src | tar
-x -C <dir>`` into a directory that ``.gitignore`` lists.  The models are
the example's own, built as it builds them: ``--hundred-m`` (qwen2 family,
10 layers, d 640, 10 query heads over 2 of 64, ff 2560, vocab 50304) and
the default (6 layers, d 320, 5 heads over 1, ff 1280, vocab 16384), both
float32 without remat, batch 8 x 256 tokens, AdamW at lr 1e-3, weights
and data from seed 0.  For each: ms/step by the host clock over N steps
after 3 warm-up steps (each step ends in a synchronise), then a
torch.profiler trace of K more steps: device busy ms a step, the flash
kernels' ms a step and share of the busy time (the kernels of the tree's
``ROUTES``, both routes), and the top kernels.  One JSON line each; the
rows also go to ``chiprun_out/example_step_<NAME>.json``.  Needs one card.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# examples/train_lm_torch.py's two models (its dataclasses.replace calls)
MODELS = {
    "hundred_m": dict(n_layers=10, d_model=640, n_heads=10, n_kv=2,
                      head_dim=64, d_ff=2560, vocab=50304),
    "default": dict(n_layers=6, d_model=320, n_heads=5, n_kv=1,
                    head_dim=64, d_ff=1280, vocab=16384),
}
BATCH, SEQ, LR = 8, 256, 1e-3


def main(argv) -> int:
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--src", "--tag", "--steps",
                                     "--profile-steps"}:
        print(__doc__, file=sys.stderr)
        return 2
    src = Path(opts.get("--src", ROOT / "src")).resolve()
    tag = opts.get("--tag", src.parent.name)
    steps = int(opts.get("--steps", 20))
    prof_steps = int(opts.get("--profile-steps", 5))
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("example_step_profile: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as C
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    flash = tuple(n for r in FA.ROUTES.values()
                  for n in r["fwd"] + r["bwd"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rows = []
    for name, widths in MODELS.items():
        cfg = dataclasses.replace(configs.get_config("qwen2-0.5b"), **widths,
                                  dtype="float32", remat=False,
                                  name=f"_example_{name}")
        params, opt, step_fn, pipe = C._train_setup(
            torch, cfg, BATCH, SEQ, steps + prof_steps + 3, LR, seed=0)

        def step():
            nonlocal params, opt
            params, opt, metrics = step_fn(params, opt, pipe.next_batch())
            torch.cuda.synchronize()
            return metrics

        for _ in range(3):
            step()
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = step()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(prof_steps):
                step()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(
                    e, "is_user_annotation", False):
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us())
        busy = sum(by_name.values())
        flash_us = sum(us for n, us in by_name.items()
                       if any(k in n for k in flash))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        row = {"tree": tag, "model": name, "batch": BATCH, "seq": SEQ,
               "ms_per_step": ms,
               "device_busy_ms_per_step": busy / 1e3 / prof_steps,
               "flash_ms_per_step": flash_us / 1e3 / prof_steps,
               "flash_share_of_busy": flash_us / busy,
               "loss": float(metrics["loss"]),
               "top": [[n[:70], us / 1e3 / prof_steps] for n, us in top],
               "nvidia_smi": smi}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del params, opt, step_fn, pipe
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"example_step_{tag}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
