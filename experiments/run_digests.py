"""Digests of one tree's results on the card, so that two versions (this
tree's and an earlier commit's) can be shown to compute the same bits:

    python3 experiments/run_digests.py [--src DIR]

``DIR`` holds the ``repro_torch`` package (default: this tree's ``src``);
an earlier commit's comes from ``git archive <commit> src | tar -x -C
<dir>`` into a directory that ``.gitignore`` lists.  On chip_smoke.py's
main net (100k x 1000) it runs ``CompiledModel.run`` (200 steps, with a
raster), ``Simulator.run_jit`` (200 steps), ``sweep_gscale`` over phase
4's grid (100 steps), and on phase 5's delayed net ``CompiledModel.run``
(200 steps), and prints one JSON line a result: the sha256 of every spike
count, raster, rate and state tensor's bytes (``t`` and the ring cursors
as one value a member, so a 0-dim and a [1] tensor digest alike).  Needs
one card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _leaves(x, prefix=""):
    import torch
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{prefix}.{k}")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{prefix}.{f.name}")


def _digest(t) -> str:
    a = t.detach().contiguous().cpu()
    if a.dim() == 0:
        a = a.reshape(1)
    return hashlib.sha256(a.numpy().tobytes()).hexdigest()[:16]


def _result(name: str, res) -> dict:
    out = {"result": name}
    for k in ("spike_counts", "rates_hz", "raster"):
        v = getattr(res, k, None)
        if v is not None:
            out.update({f"{k}.{p}": _digest(t) for p, t in v.items()})
    state = getattr(res, "state", None)
    if state is not None:
        out.update({f"state{n}": _digest(t) for n, t in _leaves(state)})
    if hasattr(res, "finite"):
        out["finite"] = _digest(res.finite)
    return out


def main(argv) -> int:
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--src"}:
        print(__doc__, file=sys.stderr)
        return 2
    src = Path(opts.get("--src", ROOT / "src"))
    sys.path[:0] = [str(src.resolve()), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("run_digests: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.core.models import izhikevich_net as IZ
    print(json.dumps({"package": IZ.__file__}), flush=True)
    cfg = IZ.IzhikevichNetConfig(n_total=C.MAIN["n_total"],
                                 n_conn=C.MAIN["n_conn"],
                                 representation="sparse")
    model = IZ.compile_model(cfg)
    print(json.dumps(_result("run", model.run(200, record_raster=True))),
          flush=True)
    sim = model.simulator
    print(json.dumps(_result("run_jit", sim.run_jit(200)(
        sim.init_state()))), flush=True)
    print(json.dumps(_result("sweep", model.sweep_gscale(
        "exc", list(C.SWEEP["values"]), 100))), flush=True)
    del model, sim
    torch.cuda.empty_cache()
    model, _ = C.build_delay_model(torch)
    print(json.dumps(_result("delay_run", model.run(200))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
