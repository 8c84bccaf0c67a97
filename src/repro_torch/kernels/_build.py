"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into
``_build/lib<name>-<digest>.so`` beside this module (a directory that
``.gitignore`` lists), at first use.  The digest covers the source, every
header in ``csrc/`` and the compiler flags, so an edited source builds anew
and an unchanged one is loaded from the earlier build.  The sources expose a
plain C interface, so no PyTorch header is compiled (seconds, not minutes).

``build()`` starts one ``nvcc`` per source at once and waits for all of
them; ``load(name)`` builds what is missing and returns the library.  A
failed build raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "library_path",
           "build", "load"]

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")

# sm_90a keeps wgmma/setmaxnreg available to later kernels; -Xptxas -v
# records registers, shared memory and spills in the build log.
# -fmad=false keeps a*b+c as two rounded operations, as PyTorch's eager ops
# compute it, so a fused kernel rounds like its plain version (no
# --use_fast_math either: expf and division stay IEEE).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(sources()[name])}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` each, all started together.  Returns name ->
    ``{"path", "seconds", "log", "cached"}``; raises if any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = set(names) - set(srcs)
    if unknown:
        raise ValueError(f"no kernel source for {sorted(unknown)} in {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, dict] = {}
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            log = out.with_suffix(".log")
            results[name] = {"path": str(out), "seconds": 0.0, "cached": True,
                             "log": log.read_text() if log.is_file() else ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        # the compiler's output goes to a file, so that each build's own
        # seconds can be read off as it ends (a pipe would have to be
        # drained in turn)
        log_file = tmp.with_suffix(".log")
        with open(log_file, "w") as f:
            procs[name] = (subprocess.Popen(cmd, stdout=f,
                                            stderr=subprocess.STDOUT),
                           tmp, out, log_file, time.perf_counter())
    ended: Dict[str, float] = {}
    while len(ended) < len(procs):
        for name, (proc, *_, t0) in procs.items():
            if name not in ended and proc.poll() is not None:
                ended[name] = time.perf_counter() - t0
        time.sleep(0.02)
    failed = []
    for name, (proc, tmp, out, log_file, _) in procs.items():
        log = log_file.read_text()
        log_file.unlink()
        secs = ended[name]
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        # rename is atomic: a concurrent process never loads a partial file
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        results[name] = {"path": str(out), "seconds": secs, "cached": False,
                         "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for kernel ``name`` (built first if missing)."""
    path = library_path(name)
    if not path.is_file():
        build([name])
    return ctypes.CDLL(str(path))
