"""Device times of one tree's Izhikevich kernel at chip_smoke.py's phase
2b shapes, by phase 2b's own timer, so that two versions (this tree's and
an earlier commit's) stand side by side:

    python3 experiments/izh_kernel_times.py [--src DIR]

``DIR`` holds the ``repro_torch`` package to time (default: this tree's
``src``; an earlier commit's from ``git archive <commit> src | tar -x -C
<dir>`` into a directory that ``.gitignore`` lists).  For [1, 80000] and
[8, 80000] it prints one JSON line a form: ``isyn`` (one summed input,
the kernel every tree has) and, where the tree's wrapper takes them,
``drive`` (two current operands and the thalamic drive over every lane,
main's form) and ``drive_stim`` (the same with a [B, n] stim, the served
form): device ms a call of the kernel (``chip_smoke._device_ms``, 50
calls), the block the tree's plan chose, and the card's ``nvidia-smi``
name and power limit.  Run trees in turns (parent, change, change,
parent), each in its own process.  Needs one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--src"}:
        print(__doc__, file=sys.stderr)
        return 2
    src = Path(opts.get("--src", ROOT / "src")).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("izh_kernel_times: no CUDA device is available",
              file=sys.stderr)
        return 2
    # the tree's package first, so that chip_smoke's own path does not
    # shadow it
    from repro_torch.kernels import izhikevich_step as IZ
    if not str(Path(IZ.__file__).resolve()).startswith(str(src)):
        raise RuntimeError(f"imported {IZ.__file__}, not {src}'s")
    sys.path.insert(1, str(ROOT))
    import chip_smoke as C
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    drives = "currents" in IZ.izhikevich_step.__code__.co_varnames
    for b, n in C.IZH_SHAPES:
        r = torch.rand(n, device=dev, generator=gen)
        params = (0.02 + 0.08 * r, 0.25 - 0.05 * r, -65.0 + 15.0 * r * r,
                  8.0 - 6.0 * r * r)
        v = -80.0 + 105.0 * torch.rand((b, n), device=dev, generator=gen)
        u = -20.0 + 25.0 * torch.rand((b, n), device=dev, generator=gen)
        currents = [3.0 * torch.randn((b, n), device=dev, generator=gen)
                    for _ in range(2)]
        stim = 4.0 * torch.randn((b, n), device=dev, generator=gen)
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, 2), device=dev,
                             generator=gen, dtype=torch.int32)
        forms = {"isyn": lambda i: IZ.izhikevich_step(v, u, currents[0],
                                                      *params, 1.0)}
        if drives:
            for name, st in (("drive", None), ("drive_stim", stim)):
                forms[name] = (lambda i, st=st: IZ.izhikevich_step(
                    v, u, None, *params, 1.0, currents=currents,
                    drive=(keys, 5.0, 0, n), stim=st))
        for name, fn in forms.items():
            ms = C._device_ms(torch, fn, 50, "izhikevich_step_kernel")[1]
            plan = (IZ.launch_plan(b, n, name != "isyn") if drives
                    else IZ.launch_plan(b, n))
            print(json.dumps({"src": str(src), "form": name, "B": b, "n": n,
                              "ms": ms, "block": plan["block"],
                              "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
