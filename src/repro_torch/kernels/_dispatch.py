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

__all__ = ["on_cpu", "check_operand", "check_flag", "raise_on", "launch",
           "GRID_Y_MAX", "INT_MAX"]

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


def check_flag(finite: Optional[torch.Tensor], state: torch.Tensor) -> None:
    """``finite``, when given, is a NaN guard's flag for ``state`` [B, n]
    (or [n]): one bool per batch member, which the kernel clears where
    that member's outputs are not all finite."""
    if finite is None:
        return
    if (finite.dtype != torch.bool or finite.shape != state.shape[:-1]
            or not finite.is_contiguous()):
        raise ValueError(f"finite must be a contiguous bool tensor of shape "
                         f"{tuple(state.shape[:-1])}, got {finite.dtype} "
                         f"{tuple(finite.shape)}")


# the raw handle of PyTorch's current stream on a device, without making a
# Stream object (the public torch.cuda.current_stream(i).cuda_stream is the
# fallback)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(device: torch.device, fn: Callable[..., int], *args) -> int:
    """``fn(*args, stream)``: a kernel's C launch on PyTorch's current
    stream of ``device``, made the current device only when it is not
    already (entering ``torch.cuda.device`` costs the host more than the
    launch)."""
    if device.index == torch.cuda.current_device():
        return fn(*args, _stream(device.index))
    with torch.cuda.device(device):
        return fn(*args, _stream(device.index))


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
