"""Wrapper around the hand-written fused Izhikevich kernel.

``csrc/neuron_step.cu`` (``izhikevich_step_f32``) replaces the TPU kernel
``repro/kernels/izhikevich_step.py::izhikevich_step_pallas``; its header
says how, and what bounds it on the card.

Dispatch goes by where the tensors lie: on the CPU the plain version
``repro_torch.kernels.ref.izhikevich_step_ref``; on a CUDA device the kernel,
on the current stream, or an error.  ``launches`` counts kernel launches
(plain-version calls are not counted).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (GRID_Y_MAX, INT_MAX, F, I, P,
                                           check_flag, check_operand, launch,
                                           on_cpu, raise_on)

__all__ = ["izhikevich_step", "launches", "reset_launches"]

launches: Dict[str, int] = {"izhikevich_step": 0}


def reset_launches() -> None:
    launches["izhikevich_step"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("neuron_step")
    lib.izhikevich_step_f32.argtypes = [P] * 11 + [I, I, F, P]
    lib.izhikevich_step_f32.restype = I
    lib.neuron_step_error_string.argtypes = [I]
    lib.neuron_step_error_string.restype = ctypes.c_char_p
    return lib


def izhikevich_step(v: torch.Tensor, u: torch.Tensor, isyn: torch.Tensor,
                    a, b, c, d, dt: float,
                    finite: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Izhikevich step: returns (v', u', spiked), shaped like ``v``.

    v, u, isyn: [B, n] (or [n]) float32; a, b, c, d: [n] float32 tensors
    (scalars too, on the CPU); dt in ms.  ``finite``: the NaN guard's
    flag, a bool tensor [B] (0-dim for [n]), cleared in place for each
    member whose v' or u' is not all finite."""
    params = (a, b, c, d)
    if on_cpu("izhikevich_step", v, u, isyn, finite,
              *(p for p in params if isinstance(p, torch.Tensor))):
        return _ref.izhikevich_step_ref(v, u, isyn, a, b, c, d, dt,
                                        finite=finite)
    if v.dim() not in (1, 2):
        raise ValueError(f"v must be [B, n] or [n], got {tuple(v.shape)}")
    n = v.shape[-1]
    batch = v.shape[0] if v.dim() == 2 else 1
    for name, t in (("v", v), ("u", u), ("isyn", isyn)):
        if t.shape != v.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != v {tuple(v.shape)}")
        check_operand(name, t, torch.float32)
    for name, p in zip("abcd", params):
        if not isinstance(p, torch.Tensor) or tuple(p.shape) != (n,):
            raise ValueError(f"param {name} must be a [{n}] tensor on the "
                             f"card (kernels.ops.izhikevich_step broadcasts "
                             f"scalars)")
        check_operand(name, p, torch.float32)
    check_flag(finite, v)
    if batch > GRID_Y_MAX or n > INT_MAX:
        raise ValueError(f"[{batch}, {n}] exceeds the kernel's grid")
    v_out, u_out = torch.empty((2,) + v.shape, dtype=torch.float32,
                               device=v.device).unbind(0)
    spiked = torch.empty(v.shape, dtype=torch.bool, device=v.device)
    rc = launch(v.device, _lib().izhikevich_step_f32, v.data_ptr(),
                u.data_ptr(), isyn.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), d.data_ptr(), v_out.data_ptr(),
                u_out.data_ptr(), spiked.data_ptr(),
                0 if finite is None else finite.data_ptr(), batch, n,
                float(dt))
    launches["izhikevich_step"] += 1
    raise_on(rc, _lib().neuron_step_error_string, "izhikevich_step")
    return v_out, u_out, spiked
