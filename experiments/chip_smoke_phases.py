"""Run some of ``chip_smoke.py``'s phases on the card, by their labels:

    python3 experiments/chip_smoke_phases.py [LABEL ...]

Labels: 2 (the ELL kernels and the ring fold), 2b (the neuron kernels), 2c
(flash attention), 2d (the SSD scan, its prefill form with the final state
included), 2f (threefry), 9a (the spike bitmask), 14 (the MoE, SSM and
hybrid families: 14a-14d served, 14e and 14f trained; each also alone),
15 (whisper-tiny: 15a served, 15b trained, 15c the float32 step; each
also alone), 16 (the paper's harness, run_torch.py, and the determinism
smoke at one NCCL rank), 17 (paligemma-3b: 17a served, 17b trained, 17c
the float32 step; each also alone), 18 (the trainer's checkpoints:
restart and rollback), 19 (LM model parallelism on a one-rank NCCL
mesh: qwen2-0.5b served, granite-moe trained, a placed checkpoint, the
gradient compression), 2e (the flash backward), 3 (the main path), 5
(the delay path),
9b (main observed; reads phase 3's profile, so list 3 first), 6a (the
NaN-guard table), 9c (the mushroom body observed; reads 6a's KC rate, so
list 6a first), 10 (the occupancy model against the runtime, and the
paper's experiment at full width), 11 (SNN serving at full width) and 12
(on-device construction and the SNN benchmark scripts; reads phases 3's
and 5's host builds and phase 3's us/step when they ran before it) and 13
(the sharded engine at one NCCL rank; holds its runs to phases 12c's, 5's
and 6a's when they ran before it, else to its model's Simulator), 7 (LM
serving at full width), 8a (qwen2-0.5b trained at full width), 8b
(mamba2-2.7b trained at full width) and 20 (the
dry run and the LM scaling law; reads phases 7's and 8a's steps, so list
``7 8a 20``; its traces start after phase 1).
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
    traces = CS.start_dryrun_traces() if "20" in labels else None
    try:
        _run(CS, torch, report, labels, traces)
    finally:
        if traces is not None:
            traces.stop()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_phases.json").write_text(
        json.dumps(report, indent=1, default=str))
    print(f"phases {labels} in {time.perf_counter() - t0:.1f} s")
    return 0


def _run(CS, torch, report, labels, traces=None) -> None:
    for label in labels or ["9a", "3", "9b", "6a", "9c"]:
        if label == "2":
            CS.compare_kernels(torch, report)
        elif label == "2c":
            CS.compare_flash(torch, report)
        elif label == "2d":
            CS.compare_ssd(torch, report)
        elif label == "14":
            CS.families(torch, report)
        elif label in ("14a", "14b", "14c", "14d"):
            fam = next(f for f in CS.FAMILIES if f[0] == label)
            CS.serve_family(torch, report, *fam)
        elif label == "14e":
            CS.train_full(torch, report, "granite-moe-1b-a400m", "14e")
        elif label == "14f":
            CS.train_full(torch, report, "zamba2-7b@15", "14f")
            CS.train_hybrid_check(torch, report)
        elif label == "15":
            CS.whisper(torch, report)
        elif label == "15a":
            CS.serve_family(torch, report, "15a", CS.WHISPER["arch"], None,
                            False, fs=CS.WHISPER)
        elif label == "15b":
            CS.train_full(torch, report, CS.WHISPER["arch"], "15b")
        elif label == "15c":
            CS.whisper_check(torch, report)
        elif label == "16":
            CS.paper_harness(torch, report)
        elif label == "17":
            CS.paligemma(torch, report)
        elif label == "17a":
            CS.serve_family(torch, report, "17a", CS.PALIGEMMA["arch"], None,
                            True, fs=CS.PALIGEMMA)
        elif label == "17b":
            CS.train_full(torch, report, CS.PALIGEMMA["arch"], "17b")
        elif label == "17c":
            CS.paligemma_check(torch, report)
        elif label == "18":
            CS.checkpoints(torch, report)
        elif label == "19":
            CS.lm_mesh(torch, report)
        elif label == "2e":
            CS.compare_flash_bwd(torch, report)
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
        elif label == "7":
            CS.serve_full(torch, report)
        elif label == "8a":
            CS.train_full(torch, report, "qwen2-0.5b", "8a")
        elif label == "8b":
            CS.train_full(torch, report, "mamba2-2.7b", "8b")
        elif label == "20":
            CS.dryrun_and_scaling(torch, report, traces)
        else:
            raise SystemExit(f"unknown phase label {label!r}")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
