"""Multi-rank test harness for the port's sharded engine -- not a test module.

``run_ranks(cases_file, world, tmp)`` starts ``world`` worker processes
(``_torch_dist_worker.py``), one gloo rank each on the CPU, joined over a
``file://`` store under ``tmp`` (no TCP port to pick), and waits for them
under a wall-clock limit (every worker is killed past it).  Each worker
runs every ``case_*`` function of ``cases_file`` in order on its mesh and
saves what each returned; a case that raises ends its worker, which brings
the other ranks down at their next collective.  ``RankResults.case(name)``
is rank 0's result of one case, after checking that every rank finished
it and that its ``"global"`` part is the same on every rank (every rank
gets the same global results).  ``start_ranks`` starts a group and
returns at once; its ``wait()`` gives the ``RankResults``, so a test
module can run two groups, and its own reference, side by side.
``Groups`` starts one group a world size of a cases file, all at once,
and waits for each when a test first asks for it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORKER = TESTS / "_torch_dist_worker.py"

# environment a launcher sets; a worker takes its rank from argv instead
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT", "LOCAL_WORLD_SIZE")


def _equal(a, b, where: str) -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, (torch.Tensor, np.ndarray)):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        x, y = np.asarray(a), np.asarray(b)
        if x.dtype.kind == "f":
            # bits: NaN equals NaN, -0.0 differs from 0.0
            x, y = x.view(f"u{x.itemsize}"), y.view(f"u{y.itemsize}")
        assert np.array_equal(x, y), where
    else:
        assert a == b, where


class RankResults:
    def __init__(self, world: int, results, rcs, logs):
        self.world = world
        self.results = results
        self.rcs = rcs
        self.logs = logs

    def case(self, name: str):
        for r, res in enumerate(self.results):
            got = res.get(name)
            if got is None:
                raise AssertionError(
                    f"rank {r} of {self.world} did not finish case {name!r} "
                    f"(rc {self.rcs[r]}):\n{self.logs[r]}")
            if "error" in got:
                raise AssertionError(f"case {name!r} raised on rank {r} of "
                                     f"{self.world}:\n{got['error']}")
        first = self.results[0][name]["ok"]
        if isinstance(first, dict) and "global" in first:
            for r in range(1, self.world):
                _equal(first["global"], self.results[r][name]["ok"]["global"],
                       f"{name}: rank {r} vs rank 0")
        return first

    def local(self, name: str):
        """Every rank's result of one case, in rank order."""
        self.case(name)
        return [res[name]["ok"] for res in self.results]


def run_ranks(cases_file, world: int, tmp: Path,
              timeout_s: float = 300.0) -> RankResults:
    return start_ranks(cases_file, world, tmp, timeout_s).wait()


class _Started:
    """A group of workers started by ``start_ranks``; ``wait()`` collects
    them (under the group's wall-clock limit, counted from the start)."""

    def __init__(self, procs, world: int, tmp: Path, deadline: float):
        self.procs, self.world, self.tmp = procs, world, tmp
        self.deadline = deadline

    def wait(self) -> RankResults:
        procs, world, tmp = self.procs, self.world, self.tmp
        logs = [""] * world
        try:
            for r, p in enumerate(procs):
                logs[r] = p.communicate(
                    timeout=max(0.0, self.deadline - time.monotonic()))[0]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for r, p in enumerate(procs):
                out = p.communicate()[0]
                logs[r] = (logs[r] or out or "") + \
                    "\n[killed at the time limit]"
        results = []
        for r in range(world):
            path = tmp / f"rank{r}.pt"
            results.append(torch.load(path, weights_only=False)
                           if path.exists() else {})
        return RankResults(world, results, [p.returncode for p in procs],
                           [log[-4000:] for log in logs])


def start_ranks(cases_file, world: int, tmp: Path,
                timeout_s: float = 300.0) -> _Started:
    """``run_ranks`` without the wait: the workers run while the caller
    does other work, then ``.wait()``."""
    tmp = Path(tmp)
    store = tmp / "store"
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), str(TESTS), str(TESTS.parent)] + ([env["PYTHONPATH"]]
                                  if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(cases_file), str(store), str(r),
         str(world), str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    # one limit for the whole group, not one a rank
    return _Started(procs, world, tmp, time.monotonic() + timeout_s)


class Groups:
    """One group of ranks a world size of ``worlds``, each running every
    case of ``cases_file``, all started together (``start_ranks``; under
    ``tmp_factory``'s folders ``<prefix>_D<world>``); ``get(world)`` waits
    for one group, ``wait_all()`` for every one."""

    def __init__(self, cases_file, worlds, tmp_factory, prefix: str,
                 timeout_s: float = 300.0):
        self.started = {d: start_ranks(cases_file, d, tmp_factory.mktemp(
            f"{prefix}_D{d}"), timeout_s) for d in worlds}
        self.done = {}

    def get(self, world: int) -> RankResults:
        if world not in self.done:
            self.done[world] = self.started[world].wait()
        return self.done[world]

    def wait_all(self) -> None:
        for d in self.started:
            self.get(d)
