"""Time one tree's ELL kernels on the card at chip_smoke.py's phase 2
shapes, with phase 2's own timers, so that two versions (for example this
tree's and an earlier commit's) are held side by side by the same
yardstick: 80000 rows x 1000 slots -> 80000 posts, 80% of slots valid, 21
delay slots, B = 1 and 8, 1% and 100% of rows spiking.

    python3 experiments/ell_device_times.py [--src DIR]

``DIR`` holds the ``repro_torch`` package to time (default: this tree's
``src``); an earlier commit's comes from ``git archive <commit> src | tar
-x -C <dir>`` into a directory that ``.gitignore`` lists.  For each case
it prints one JSON line:

- ``ms``: ``ell_spmv``'s device time a call (every op it runs: the
  output's zero fill and the kernel), from torch.profiler
  (``chip_smoke._device_ms``); ``kernel_ms``: the ELL kernel's alone;
  ``wall_ms``: CUDA events around back-to-back calls
  (``chip_smoke._time_ms``);
- ``path_*``: the same for the call the simulator makes on its bool spikes:
  the bool tensor itself where the wrapper takes it, else a cast to float32
  and the call (what the simulator did before the wrapper took bool);
- ``delay_ms`` / ``delay_kernel_ms`` / ``delay_wall_ms``: the same for
  ``ell_spmv_delay`` (float32 spikes, which every version takes);
- ``group_*``: one ``SynapseGroup.step`` of a group with those
  per-synapse delays (21 ring slots, the simulator's bool spikes, a 0-dim
  gScale at B = 1 and a [B] one at B = 8): what the delay path runs a step
  for one group, whatever the version (the scatter and the ring's update:
  eager ops, or the fold kernel).  ``group_ms`` is its device time,
  ``group_ops`` its device ops, ``group_by_name`` device us by kernel name,
  all a call.

Each result is checked against the plain version (``ref.ell_spmv_ref``,
``ref.ell_spmv_delay_ref``) at chip_smoke.py's tolerance.  Needs one card.
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
    src = Path(opts.get("--src", ROOT / "src"))
    sys.path[:0] = [str(src.resolve()), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("ell_device_times: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.core.snn import synapses as S
    from repro_torch.kernels import ell_spmv as K
    from repro_torch.kernels import ref as R
    from repro_torch.sparse import formats as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = 0.5 * torch.rand(C.N_PRE, C.N_CONN, device=dev, generator=gen)
    idx = torch.randint(0, C.N_POST, (C.N_PRE, C.N_CONN), device=dev,
                        generator=gen, dtype=torch.int32)
    valid = torch.rand(C.N_PRE, C.N_CONN, device=dev, generator=gen) < 0.8
    dly = torch.randint(0, C.N_SLOTS, (C.N_PRE, C.N_CONN), device=dev,
                        generator=gen, dtype=torch.int32)
    group = S.SynapseGroup("exc_exc", "exc", "exc", F.ELLSynapses(
        g=g, post_ind=idx, valid=valid, n_post=C.N_POST, delay=dly),
        representation="sparse")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"package": K.__file__, "card": card}))
    for b, p in ((1, 0.01), (1, 1.0), (8, 0.01), (8, 1.0)):
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
        dcall = lambda i: K.ell_spmv_delay(g, idx, valid, dly,
                                           floats[i % 8], C.N_POST,
                                           C.N_SLOTS)
        out = dcall(0)
        dref = R.ell_spmv_delay_ref(g, idx, valid, dly, floats[0],
                                    C.N_POST, C.N_SLOTS)
        torch.cuda.synchronize()
        C.check(bool(torch.allclose(out, dref, rtol=C.TOL, atol=C.TOL)),
                f"delay B={b} p={p}: max abs err "
                f"{float((out - dref).abs().max())}")
        del out, dref
        reps = 20 if p < 0.5 else 5
        state = group.init_state(b)
        gscale = (torch.tensor(1.0) if b == 1 else
                  torch.ones(b, device=dev))
        gstep = lambda i: group.step(state, spikes[i % 8], gscale, 1.0)

        def gsteps():
            for i in range(reps):
                gstep(i)
            torch.cuda.synchronize()

        ms, kernel_ms = C._device_ms(torch, call, reps, "ell_spmv")
        path_ms, path_kernel_ms = C._device_ms(torch, path, reps,
                                               "ell_spmv")
        delay_ms, delay_kernel_ms = C._device_ms(torch, dcall, reps,
                                                 "ell_spmv_delay")
        prof = C._device_profile(torch, gsteps, warm=True)
        print(json.dumps({
            "B": b, "spiking": p,
            "takes_bool": takes_bool,
            "ms": ms, "kernel_ms": kernel_ms,
            "wall_ms": C._time_ms(torch, call, reps),
            "path_ms": path_ms, "path_kernel_ms": path_kernel_ms,
            "path_wall_ms": C._time_ms(torch, path, reps),
            "delay_ms": delay_ms, "delay_kernel_ms": delay_kernel_ms,
            "delay_wall_ms": C._time_ms(torch, dcall, reps),
            "group_ms": prof["device_busy_us"] / reps / 1e3,
            "group_ops": prof["device_ops"] / reps,
            "group_wall_ms": C._time_ms(torch, gstep, reps),
            "group_by_name": {n: us / reps for n, (_, us)
                              in prof["by_name"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
