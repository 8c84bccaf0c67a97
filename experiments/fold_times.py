"""Time one tree's dendritic-ring fold (``kernels.delay_ring``) on the card
at chip_smoke.py's phase 2 shapes ([1, 21, 80000] and [8, 21, 80000]),
with phase 2's timers, so that two versions (this tree's and an earlier
commit's) are held side by side by the same yardstick:

    python3 experiments/fold_times.py [--src DIR] [--rounds N]

``DIR`` holds the ``repro_torch`` package to time (default: this tree's
``src``); an earlier commit's comes from ``git archive <commit> src | tar
-x -C <dir>`` into a directory that ``.gitignore`` lists.  A tree whose
fold takes one 0-dim cursor (before the cursor a member) is timed with
that; one that takes a [B] cursor with every member's cursor equal (a run
or a sweep) and with all different (served streams).  Each case is held
to the plain version bit for bit, then timed ``--rounds`` times (default
5): one JSON line a shape with the device ms a call (``_device_ms``: the
kernel's device time from torch.profiler, median over rounds and the
spread), and the card's name and power limit.  Needs one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--src", "--rounds"}:
        print(__doc__, file=sys.stderr)
        return 2
    src = Path(opts.get("--src", ROOT / "src"))
    rounds = int(opts.get("--rounds", 5))
    sys.path[:0] = [str(src.resolve()), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("fold_times: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import delay_ring as DR
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"package": DR.__file__, "card": card}))
    for b, n_slots, n_post in C.FOLD_SHAPES:
        ring = torch.randn(b, n_slots, n_post, device=dev, generator=gen)
        acc0 = torch.randn(n_slots, n_post, b, device=dev, generator=gen,
                           dtype=torch.float64)
        gs = (torch.tensor(0.7) if b == 1
              else torch.rand(b, device=dev, generator=gen) + 0.5)
        try:
            DR.delay_ring_fold(ring, acc0.clone(),
                               torch.zeros(b, dtype=torch.int32,
                                           device=dev), 1.0, gs)
            per_member = True
        except ValueError:
            per_member = False
        if per_member:
            cases = {"equal": torch.full((b,), 11, dtype=torch.int32,
                                         device=dev)}
            if b > 1:
                cases["unequal"] = torch.tensor(
                    [(5 * m + 2) % n_slots for m in range(b)],
                    dtype=torch.int32, device=dev)
        else:
            cases = {"scalar": torch.tensor(11, dtype=torch.int32,
                                            device=dev)}
        row = {"shape": [b, n_slots, n_post], "per_member": per_member,
               "card": card}
        for name, cur in cases.items():
            got = DR.delay_ring_fold(ring, acc0.clone(), cur, -1.0, gs)
            want = R.delay_ring_fold_ref(ring, acc0.clone(), cur, -1.0, gs)
            for x, y in zip(got, want):
                C.check(bool(torch.equal(x, y)),
                        f"{name} {[b, n_slots, n_post]}: not bit-equal")
            accs = [acc0.clone() for _ in range(8)]
            fn = (lambda i, cur=cur: DR.delay_ring_fold(
                ring, accs[i % 8], cur, -1.0, gs))
            ms = sorted(C._device_ms(torch, fn, 20, "delay_ring_fold")[1]
                        for _ in range(rounds))
            row[name] = {"ms": ms[len(ms) // 2],
                         "spread": ms[-1] - ms[0]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
