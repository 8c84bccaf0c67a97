"""Time one tree's ``ell_spmv`` on the card at chip_smoke.py's phase 2
shapes, with phase 2's own timers, so that two versions of the kernel (for
example this tree's and an earlier commit's) are held side by side by the
same yardstick: 80000 rows x 1000 slots -> 80000 posts, 80% of slots valid,
B = 1 and 8, 1% and 100% of rows spiking.

    python3 experiments/ell_device_times.py [--src DIR]

``DIR`` holds the ``repro_torch`` package to time (default: this tree's
``src``); an earlier commit's comes from ``git archive <commit> src | tar
-x -C <dir>`` into a directory that ``.gitignore`` lists.  For each case it
prints one JSON line:

- ``ms``: the wrapper's device time a call (every op it runs: the output's
  zero fill and the kernel), from torch.profiler (``chip_smoke._device_ms``);
- ``kernel_ms``: the ELL kernel's alone;
- ``wall_ms``: CUDA events around back-to-back calls
  (``chip_smoke._time_ms``);
- ``path_*``: the same for the call the simulator makes on its bool spikes:
  the bool tensor itself where the wrapper takes it, else a cast to float32
  and the call (what the simulator did before the wrapper took bool).

Each result is checked against the plain version (``ref.ell_spmv_ref``) at
chip_smoke.py's tolerance.  Needs one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    src = Path(argv[1]) if argv[:1] == ["--src"] and len(argv) == 2 else (
        ROOT / "src" if not argv else None)
    if src is None:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(src.resolve()), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("ell_device_times: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import ell_spmv as K
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = 0.5 * torch.rand(C.N_PRE, C.N_CONN, device=dev, generator=gen)
    idx = torch.randint(0, C.N_POST, (C.N_PRE, C.N_CONN), device=dev,
                        generator=gen, dtype=torch.int32)
    valid = torch.rand(C.N_PRE, C.N_CONN, device=dev, generator=gen) < 0.8
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"package": K.__file__, "card": card}))
    for b in (1, 8):
        for p in (0.01, 1.0):
            spikes = [torch.rand(b, C.N_PRE, device=dev, generator=gen) < p
                      for _ in range(8)]
            floats = [s.float() for s in spikes]
            call = lambda i: K.ell_spmv(g, idx, valid, floats[i % 8], C.N_POST)
            try:
                K.ell_spmv(g, idx, valid, spikes[0], C.N_POST)
                takes_bool = True
            except (TypeError, ValueError, RuntimeError):
                takes_bool = False
            if takes_bool:
                path = lambda i: K.ell_spmv(g, idx, valid, spikes[i % 8],
                                            C.N_POST)
            else:
                path = lambda i: K.ell_spmv(g, idx, valid,
                                            spikes[i % 8].float(), C.N_POST)
            ref = R.ell_spmv_ref(g, idx, valid, floats[0], C.N_POST)
            for fn in (call, path):
                out = fn(0)
                torch.cuda.synchronize()
                C.check(bool(torch.allclose(out, ref, rtol=C.TOL, atol=C.TOL)),
                        f"B={b} p={p}: max abs err "
                        f"{float((out - ref).abs().max())}")
            reps = 20 if p < 0.5 else 5
            ms, kernel_ms = C._device_ms(torch, call, reps, "ell_spmv")
            path_ms, path_kernel_ms = C._device_ms(torch, path, reps,
                                                   "ell_spmv")
            print(json.dumps({
                "B": b, "spiking": p, "takes_bool": takes_bool,
                "ms": ms, "kernel_ms": kernel_ms,
                "wall_ms": C._time_ms(torch, call, reps),
                "path_ms": path_ms, "path_kernel_ms": path_kernel_ms,
                "path_wall_ms": C._time_ms(torch, path, reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
