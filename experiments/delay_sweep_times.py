"""Time one tree's delayed gScale sweep on the card: chip_smoke.py's phase
5b, phase 4's grid of 8 gScales on phase 5's net (100k neurons x 1000
synapses, per-synapse delays 0..20 steps on the excitatory groups) as one
batch of 500 steps, so that two versions (for example this tree's and an
earlier commit's) are held side by side by the same yardstick.

    python3 experiments/delay_sweep_times.py [--src DIR] [--repeats N]

``DIR`` holds the ``repro_torch`` package to time (default: this tree's
``src``); an earlier commit's comes from ``git archive <commit> src | tar
-x -C <dir>`` into a directory that ``.gitignore`` lists.  It prints one
JSON line for the build, one for each of ``N`` (default 2) timed sweeps
(host clock around a synchronised ``sweep_gscale``: seconds, us/step,
candidates/s, rates, finite flags), then one from a torch.profiler trace
of 50 steps of the same batched run (``chip_smoke._device_profile``):
device us, device ops and wall us a step, the busy share, and device us a
step by kernel name.  Needs one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--src", "--repeats"}:
        print(__doc__, file=sys.stderr)
        return 2
    src = Path(opts.get("--src", ROOT / "src"))
    sys.path[:0] = [str(src.resolve()), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("delay_sweep_times: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as C
    import repro_torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    model, build_s = C.build_delay_model(torch)
    values, steps = list(C.SWEEP["values"]), C.DELAY["sweep_steps"]
    print(json.dumps({"package": repro_torch.__file__, "card": card,
                      "build_s": build_s, "values": values,
                      "steps": steps}), flush=True)
    model.sweep_gscale("exc", values, 5)
    for r in range(int(opts.get("--repeats", 2))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = model.sweep_gscale("exc", values, steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(json.dumps({
            "repeat": r, "seconds": secs, "us_per_step": secs / steps * 1e6,
            "candidates_per_s": len(values) / secs,
            "rates_hz": {k: v.tolist() for k, v in s.rates_hz.items()},
            "finite": s.finite.tolist()}), flush=True)
    n = C.DELAY["profile_steps"]
    gscales = {"exc": torch.tensor(values, device="cuda")}
    state = model.init_state(len(values))

    def run():
        model.run(n, gscales=gscales, state=state)
        torch.cuda.synchronize()

    prof = C._device_profile(torch, run, warm=True)
    print(json.dumps({
        "profile_steps": n, "device_us_per_step": prof["device_busy_us"] / n,
        "device_ops_per_step": prof["device_ops"] / n,
        "wall_us_per_step": prof["wall_us"] / n,
        "busy_share": prof["busy_share"],
        "by_name_us_per_step": {k: [c / n, us / n] for k, (c, us)
                                in prof["by_name"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
