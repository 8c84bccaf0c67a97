"""What every kernel wrapper does around its launch.

A wrapper routes by where its tensors lie (all on the CPU: the plain
version; all on one CUDA device: the kernel; anything else raises), checks
the operands the kernel takes, and raises when the launch returns a CUDA
error.  Nothing falls back from a failed build or launch to the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

__all__ = ["on_cpu", "check_operand", "raise_on", "GRID_Y_MAX", "INT_MAX"]

GRID_Y_MAX = 65535            # a launch's grid axis y (the batch rides it)
INT_MAX = 2 ** 31 - 1         # sizes the kernels take as int


def on_cpu(what: str, *tensors: Optional[torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU; False when every one lies on
    one CUDA device; anything else raises."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what} operands lie on {sorted(map(str, devs))}"
                         "; expected all on the CPU or all on one CUDA device")
    return False


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """The kernel reads ``t`` as a dense array of ``dtype``."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(rc: int, error_string: Callable[[int], bytes],
             what: str) -> None:
    """Raise if a launch returned a CUDA error; ``error_string`` is the
    library's own ``cudaGetErrorString``."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{error_string(rc).decode()} (cuda error {rc})")


# ctypes argument types of the kernels' plain C interfaces: pointers and
# the stream as void*, sizes as int / long long, scalars as float
P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
