"""Replayed end-to-end times of the main path and of its gScale sweep for
one source tree, so that two trees can be compared in turns on one card:

    python3 experiments/ab_main_sweep.py [--root TREE] [--label NAME]
                                         [--reps N] [--block B]

Builds ``chip_smoke.py``'s phase 3 net (the Izhikevich net at 100k
neurons, in-degree 1000) from ``TREE/src`` (default: this checkout) on the
card, runs ``CompiledModel.run`` of ``MAIN['steps']`` steps and phase 4's
``sweep_gscale`` (8 candidates x ``SWEEP['steps']`` steps) once each to
capture their graphs, then times each ``--reps`` times in turns (run,
sweep, sweep, run, ...).  Prints one JSON line: us/step of the run and
candidates/s of the sweep (medians and every sample), the kernel blocks
the plans chose where the tree's wrappers report them, and the card's
``nvidia-smi`` name and power limit.  ``--block B`` puts B in every plan
of the wrappers whose block the occupancy model chooses (this checkout's
only: ``chip_smoke._forced_block``), to tell the blocks' share of a
difference from the rest.  Run a parent and a change as parent, change,
change, parent, each in its own process.  Needs one card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _timed(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--block", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_main_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    src = str(Path(args.root).resolve() / "src")
    sys.path.insert(0, src)
    from repro_torch.core.models import izhikevich_net as IZ
    from repro_torch.kernels import _build
    if not str(Path(IZ.__file__).resolve()).startswith(src):
        raise RuntimeError(f"imported {IZ.__file__}, not {src}'s")
    # the phase 3 / phase 4 sizes (chip_smoke.py's MAIN and SWEEP)
    n_total, n_conn, steps = 100_000, 1000, 1000
    values, sweep_steps = (0.3, 0.45, 0.6, 0.75, 0.9, 1.0, 1.1, 1.2), 500
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    _build.build()
    forced = contextlib.ExitStack()
    if args.block:
        sys.path.insert(1, str(ROOT))
        import chip_smoke as CS
        for module in CS._plan_modules():
            forced.enter_context(CS._forced_block(module, args.block))
    model = IZ.compile_model(IZ.IzhikevichNetConfig(
        n_total=n_total, n_conn=n_conn, representation="sparse"))
    run = lambda: model.run(steps)
    sweep = lambda: model.sweep_gscale("exc", list(values), sweep_steps)
    run()
    sweep()
    us, cps = [], []
    for r in range(args.reps):
        for what in (("run", "sweep") if r % 2 == 0 else ("sweep", "run")):
            if what == "run":
                us.append(_timed(torch, run) / steps * 1e6)
            else:
                cps.append(len(values) / _timed(torch, sweep))
    blocks = {"forced": args.block or None}
    from repro_torch.kernels import ell_spmv, izhikevich_step, threefry
    for name, fn in (
            ("ell_spmv exc->exc", lambda: ell_spmv.launch_plan(
                1, 80_000, 800, 80_000)["block"]),
            ("izhikevich_step exc", lambda: izhikevich_step.launch_plan(
                1, 80_000)["block"]),
            ("threefry_draw exc", lambda: threefry.launch_plan(
                "threefry_draw", 1, 80_000)["block"])):
        try:
            blocks[name] = fn()
        except AttributeError:        # a tree whose wrapper has no plan
            blocks[name] = None
    forced.close()
    print(json.dumps({"label": args.label, "root": args.root,
                      "nvidia_smi": smi,
                      "us_per_step": statistics.median(us),
                      "candidates_per_s": statistics.median(cps),
                      "us_per_step_all": us, "candidates_per_s_all": cps,
                      "blocks": blocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
