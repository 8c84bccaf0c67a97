"""One gloo rank of a multi-rank test (``_torch_dist.py``) -- not a test.

Usage: python _torch_dist_worker.py CASES_FILE STORE RANK WORLD OUT_DIR

Joins the group over ``file://STORE``, builds the CPU mesh, runs every
``case_*`` function of CASES_FILE in definition order with the mesh, and
saves {case name: {"ok": result} or {"error": traceback}} to
OUT_DIR/rank{RANK}.pt after each case.  A case that raises ends the
process at once (exit 1): the other ranks then fail at their next
collective instead of waiting for this one.
"""

import importlib.util
import os
import sys
import traceback


def _save(results, out_dir, rank):
    import torch
    tmp = os.path.join(out_dir, f"rank{rank}.pt.tmp")
    torch.save(results, tmp)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pt"))


def main():
    cases_file, store, rank, world, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed, make_snn_mesh
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{store}", timeout_s=120)
    mesh = make_snn_mesh(world, device="cpu")
    spec = importlib.util.spec_from_file_location("_cases", cases_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cases = sorted(((fn.__code__.co_firstlineno, name, fn)
                    for name, fn in vars(mod).items()
                    if name.startswith("case_") and callable(fn)))
    results = {}
    for _, name, fn in cases:
        try:
            results[name[len("case_"):]] = {"ok": fn(mesh)}
        except BaseException:
            results[name[len("case_"):]] = {"error": traceback.format_exc()}
            _save(results, out_dir, rank)
            sys.stdout.flush()
            os._exit(1)
        _save(results, out_dir, rank)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
