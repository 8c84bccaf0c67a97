"""Count the SASS instructions of hand-written kernels, as chip_smoke.py's
phases 2 and 2b do, for any CUDA source of the port: build it with the
port's nvcc flags (``repro_torch.kernels._build.NVCC_FLAGS``) into a
temporary directory and print, for each kernel named, its instructions
(NOPs left out), those of its innermost loop (one substep of
``hh_step_kernel``) and its opcodes.  Needs the CUDA toolkit, not a card.
Run from the root of the repository:

    python3 experiments/sass_count.py SOURCE.cu KERNEL [KERNEL ...]

for example on this tree's ``src/repro_torch/kernels/csrc/neuron_step.cu``
and on an earlier commit's copy of it (``git archive <commit>
src/repro_torch/kernels/csrc/neuron_step.cu | tar -x -C <dir>``), with
``hh_step_kernel izhikevich_step_kernel``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import _build
    source, kernels = Path(argv[0]), argv[1:]
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp) / f"lib{source.stem}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(source)], check=True, capture_output=True)
        for kernel in kernels:
            counts = chip_smoke._sass_instructions(str(lib), kernel)
            print(json.dumps({"source": str(source), "kernel": kernel,
                              **counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
