"""How often, and how far, two runs of chip_smoke.py's main path part ways.

The main path (phase 3: the Izhikevich net, 100k neurons, 1000 synapses
each) is run for 50 steps from the same fresh state, ``--reps`` times
over, in four ways: through the kernels twice (K1, K2) and through the
plain versions on the card twice (P1, P2).  Both ELL routes add their
contributions with atomics in an order of the card's choosing.  Where
they add in float32 (an earlier commit's package), no two runs round a
neuron's input alike, and rounding alone can move a spike; since they add
in float64 and round once, every pair should read 1.0.  For each
repetition it prints one JSON line with the agreement
of the rasters (the share of neuron-steps that match, as chip_smoke.py
computes it) for K1/P1 (the pair that chip_smoke.py checks), K1/K2 and
P1/P2, and the neuron-steps that differ at each step for each pair.

    python3 experiments/raster_agreement.py [--src DIR] [--reps N]
                                            [--steps N]

``DIR`` holds the ``repro_torch`` package to run (default: this tree's
``src``); an earlier commit's comes from ``git archive <commit> src | tar
-x -C <dir>`` into a directory that ``.gitignore`` lists.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("raster_agreement: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.core.models import izhikevich_net as IZ
    from repro_torch.kernels import ell_spmv as K
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"package": K.__file__, "card": card,
                      "steps": args.steps}), flush=True)
    cfg = IZ.IzhikevichNetConfig(n_total=C.MAIN["n_total"],
                                 n_conn=C.MAIN["n_conn"],
                                 representation="sparse")
    model = IZ.compile_model(cfg)
    model.run(5)

    def kernel():
        return model.run(args.steps, record_raster=True).raster

    def plain():
        with C.plain_versions():
            return model.run(args.steps, record_raster=True).raster

    def per_step(a, b):
        return [int(sum(int((a[k][t] != b[k][t]).sum()) for k in a))
                for t in range(args.steps)]

    for rep in range(args.reps):
        k1, p1, k2, p2 = kernel(), plain(), kernel(), plain()
        spikes = sum(int(k1[k].sum()) for k in k1)
        line = {"rep": rep, "spikes_k1": spikes}
        for name, (a, b) in (("k1_p1", (k1, p1)), ("k1_k2", (k1, k2)),
                             ("p1_p2", (p1, p2))):
            line[name] = C._raster_agreement(torch, a, b)
            line[name + "_per_step"] = per_step(a, b)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
