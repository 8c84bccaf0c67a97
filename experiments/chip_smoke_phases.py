"""Run some of ``chip_smoke.py``'s phases on the card, by their labels:

    python3 experiments/chip_smoke_phases.py [LABEL ...]

Labels: 2 (the ELL kernels and the ring fold), 2b (the neuron kernels), 2f
(threefry), 9a (the spike bitmask), 3 (the main path), 5 (the delay path),
9b (main observed; reads phase 3's profile, so list 3 first), 6a (the
NaN-guard table), 9c (the mushroom body observed; reads 6a's KC rate, so
list 6a first), 10 (the occupancy model against the runtime, and the
paper's experiment at full width), 11 (SNN serving at full width) and 12
(on-device construction and the SNN benchmark scripts; reads phases 3's
and 5's host builds and phase 3's us/step when they ran before it) and 13
(the sharded engine at one NCCL rank; holds its runs to phases 12c's, 5's
and 6a's when they ran before it, else to its model's Simulator).
Default:
``9a 3 9b 6a 9c``, in that order.  Phase 1 (the card and the kernel build)
always runs first.  The phases print what ``chip_smoke.py`` prints; the
report goes to ``chiprun_out/chip_smoke_phases.json``.  Needs one card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(labels) -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke_phases: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    report: dict = {}
    t0 = time.perf_counter()
    CS.card_and_build(torch, report)
    for label in labels or ["9a", "3", "9b", "6a", "9c"]:
        if label == "2":
            CS.compare_kernels(torch, report)
        elif label == "2b":
            CS.compare_neuron_kernels(torch, report)
        elif label == "2f":
            CS.compare_threefry(torch, report)
        elif label == "10":
            CS.paper_experiment(torch, report)
        elif label == "9a":
            report["kernel_entries"] = CS.compare_bitmask(torch, report)
        elif label == "3":
            CS.main_path(torch, report)
        elif label == "5":
            CS.delay_path(torch, report)
        elif label == "11":
            CS.serve_snn(torch, report)
        elif label == "12":
            CS.device_construction(torch, report)
        elif label == "13":
            CS.sharded_engine(torch, report)
        elif label == "9b":
            CS.main_observed(torch, report)
        elif label == "6a":
            CS.gscale_table(torch, report)
        elif label == "9c":
            CS.mb_observed(torch, report)
        else:
            raise SystemExit(f"unknown phase label {label!r}")
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_phases.json").write_text(
        json.dumps(report, indent=1, default=str))
    print(f"phases {labels} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
