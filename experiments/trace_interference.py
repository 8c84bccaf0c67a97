"""Whether ``chip_smoke.py``'s dry-run trace processes slow the timed
training phases beside them: phases 8b (mamba2-2.7b, 2 x 2048) and 14e
(granite-moe, 4 x 2048) run in turns without and with phase 20's three
trace processes started just before them (rounds without, with, with,
without), on one card:

    python3 experiments/trace_interference.py [--rounds 4]

Phase 1 (the card and the kernel build) and 2d (the SSD scan, whose times
8b reads) run first.  Each round prints both phases' step times and
ms/step (the mean after the warm-up step); the rows go to
``chiprun_out/trace_interference.json``.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = (("mamba2-2.7b", "8b"), ("granite-moe-1b-a400m", "14e"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    import torch
    if not torch.cuda.is_available():
        print("trace_interference: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    report: dict = {}
    CS.card_and_build(torch, report)
    CS.compare_ssd(torch, report)
    rows = []
    for r in range(args.rounds):
        beside = r % 4 in (1, 2)          # without, with, with, without
        traces = CS.start_dryrun_traces() if beside else None
        t0 = time.perf_counter()
        try:
            for name, label in PHASES:
                CS.train_full(torch, report, name, label)
                res = report[f"train_{name}"]
                rows.append({"round": r, "traces_beside": beside,
                             "phase": label,
                             "ms_per_step": res["ms_per_step"],
                             "step_ms": [s["ms"] for s in res["steps"]]})
                print(f"round {r} ({'with' if beside else 'without'} the "
                      f"traces): {label} {res['ms_per_step']:.1f} ms/step, "
                      f"steps {[round(s['ms'], 1) for s in res['steps']]}",
                      flush=True)
                torch.cuda.empty_cache()
        finally:
            if traces is not None:
                traces.stop()
        print(f"round {r}: {time.perf_counter() - t0:.1f} s", flush=True)
    for label in ("8b", "14e"):
        for beside in (False, True):
            ms = [x["ms_per_step"] for x in rows
                  if x["phase"] == label and x["traces_beside"] == beside]
            print(f"{label} {'with' if beside else 'without'} the traces: "
                  f"{ms} ms/step")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "trace_interference.json").write_text(json.dumps(
        {"card": report.get("nvidia_smi"), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
