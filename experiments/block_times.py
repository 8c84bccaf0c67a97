"""Device time of each kernel whose block the occupancy model chooses
(``repro_torch.kernels.autotune``), at every block it is compiled for, at
the paths' shapes (``chip_smoke.py`` phase 10's cases: the ELL scatters at
80,000 x 1000 slots, 1% spiking; the ring fold at [1, 21, 80000];
``izhikevich_step`` at [1, 80000]; ``hh_step`` at [1, 100000]; threefry's
split of 5 keys and normal draw of 80,000; the bitmask at [1, 80000]),
each block's result bit-equal to the chosen block's.  Each time is the
median of ``--rounds`` torch.profiler windows, each of 20 calls at every
block in turn (ascending, then descending), with the spread:

    python3 experiments/block_times.py [--rounds N]

Needs one card; the rows go to ``chiprun_out/block_times.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    import torch
    if not torch.cuda.is_available():
        print("block_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import autotune as AT
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    _build.build()
    rows = CS._blocks_at_path_shapes(torch, AT, rounds=args.rounds)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "block_times.json").write_text(json.dumps(
        {"nvidia_smi": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
