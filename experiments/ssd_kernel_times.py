"""Times of one tree's SSD scan kernel at chip_smoke.py's phase 2d shapes,
by phase 2d's own timer, so that two versions (this tree's and an earlier
commit's) stand side by side:

    python3 experiments/ssd_kernel_times.py [--src DIR] [--kernel FILE]
        [--heads N] [--reps R]

``DIR`` holds the ``repro_torch`` package to time (default: this tree's
``src``; an earlier commit's from ``git archive <commit> src | tar -x -C
<dir>`` into a directory that ``.gitignore`` lists).  At 2d's training
shape (``SSD_CASES[0]``) and its two serving prefills
(``SSD_STATE_CASES[:2]``, mamba2's and zamba2's) it prints one JSON line a
form: ``ssd_scan`` (stateless) and ``ssd_scan.state`` (with the final
state), each its largest error against ``ssd_chunked`` (the state's too)
and its ms a call (``chip_smoke._time_ms``, CUDA events over ``R`` calls,
default 20, after one warm call), the plan's heads a CTA where the tree has
one, and the card's ``nvidia-smi`` name and power limit; first one line
with the registers and spills ``nvcc -Xptxas -v`` gave each of the
library's kernels.  The bound is phase 2d's, the same for every tree.
``--kernel FILE`` times a variant of this tree's ``csrc/ssd_scan.cu`` with
its C interface (a design of ``experiments/ssd_levers/``) through this
tree's wrapper in place of the tree's own kernel; ``--heads N`` forces N
heads a CTA (``_choose_heads`` patched) on a tree that chooses them.  Run
trees in turns (parent, change, change, parent), each in its own process.
Needs one card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ptxas(log: str) -> dict:
    """kernel -> (registers, spill stores + loads) from a -Xptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {})["spills"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["regs"] = int(m.group(1))
    return out


def main(argv) -> int:
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--src", "--kernel", "--heads",
                                     "--reps"}:
        print(__doc__, file=sys.stderr)
        return 2
    src = Path(opts.get("--src", ROOT / "src")).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("ssd_kernel_times: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    # the tree's package first, so that chip_smoke's own path does not
    # shadow it
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.ssm import ssd_chunked
    if not str(Path(SSD.__file__).resolve()).startswith(str(src)):
        raise RuntimeError(f"imported {SSD.__file__}, not {src}'s")
    sys.path.insert(1, str(ROOT))
    import chip_smoke as C
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if "--kernel" in opts:
        from experiments.ssd_ablation import build_variants
        kernel = Path(opts["--kernel"]).resolve()
        lib, log = build_variants(_build, {kernel.stem: kernel.read_text()}
                                  )[kernel.stem]
        SSD._lib = lambda: lib
        tree = f"{src}:{kernel.name}"
    else:
        log = _build.build(["ssd_scan"])["ssd_scan"]["log"]
        tree = str(src)
    print(json.dumps({"src": tree, "ptxas": _ptxas(log)}), flush=True)
    reps = int(opts.get("--reps", 20))
    if "--heads" in opts:
        SSD._choose_heads = lambda *_: int(opts["--heads"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = [C.SSD_CASES[0]] + list(C.SSD_STATE_CASES[:2])
    for name, (b, t, h, dh, ds) in shapes:
        x = torch.randn((b, t, h, dh), device=dev, generator=gen)
        dt = 0.001 + 0.1 * torch.rand((b, t, h), device=dev, generator=gen)
        A = -torch.exp(2.0 * torch.rand(h, device=dev, generator=gen))
        B, Cm = (torch.randn((b, t, 1, ds), device=dev, generator=gen)
                 for _ in range(2))
        D = torch.randn(h, device=dev, generator=gen)
        ref_y, ref_s = ssd_chunked(x, dt, A, B, Cm, D,
                                   return_final_state=True)
        y = SSD.ssd_scan(x, dt, A, B, Cm, D)
        ys, st = SSD.ssd_scan_state(x, dt, A, B, Cm, D)
        torch.cuda.synchronize()
        errs = {"ssd_scan": float((y - ref_y).abs().max()),
                "ssd_scan.state": max(float((ys - ref_y).abs().max()),
                                      float((st - ref_s).abs().max()))}
        del ref_y, ref_s, y, ys, st
        plan = SSD.launch_plan(b, t, h, dh, ds)
        forms = {"ssd_scan": lambda i: SSD.ssd_scan(x, dt, A, B, Cm, D),
                 "ssd_scan.state": lambda i: SSD.ssd_scan_state(
                     x, dt, A, B, Cm, D)}
        for form, fn in forms.items():
            ms = C._time_ms(torch, fn, reps)
            print(json.dumps({
                "src": tree, "form": form, "case": name,
                "shape": [b, t, h, dh, ds], "ms": ms,
                "max_abs_err": errs[form], "tol": C.SSD_TOL,
                "heads": plan["scan"].get("heads"), "nvidia_smi": smi}),
                flush=True)
        del x, dt, A, B, Cm, D
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
