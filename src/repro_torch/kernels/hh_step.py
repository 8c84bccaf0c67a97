"""Wrapper around the hand-written fused Traub-Miles HH kernel.

``csrc/neuron_step.cu`` (``hh_step_f32``) replaces the TPU kernel
``repro/kernels/hh_step.py::hh_step_pallas``; its header says how, and what
bounds it on the card.

Dispatch goes by where the tensors lie: on the CPU the plain version
``repro_torch.kernels.ref.hh_step_ref``; on a CUDA device the kernel, on the
current stream, or an error.  ``launches`` counts kernel launches
(plain-version calls are not counted).
"""

from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (F, I, LL, P, check_operand,
                                           on_cpu, raise_on)

__all__ = ["hh_step", "launches", "reset_launches"]

launches: Dict[str, int] = {"hh_step": 0}


def reset_launches() -> None:
    launches["hh_step"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("neuron_step")
    lib.hh_step_f32.argtypes = [P] * 9 + [LL, F, I] + [F] * 7 + [P]
    lib.hh_step_f32.restype = I
    lib.neuron_step_error_string.argtypes = [I]
    lib.neuron_step_error_string.restype = ctypes.c_char_p
    return lib


def hh_step(v: torch.Tensor, m: torch.Tensor, h: torch.Tensor,
            n: torch.Tensor, isyn: torch.Tensor, dt: float,
            substeps: int = 5, gNa=7.15, ENa=50.0, gK=1.43, EK=-95.0,
            gl=0.02672, El=-63.563, C=0.143
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """One Traub-Miles HH step of ``substeps`` Euler substeps: returns
    (v, m, h, n), shaped like ``v``.

    v, m, h, n, isyn: float32 tensors of one shape ([B, n] or [n]); dt in
    ms; the seven parameters are scalars, as the TPU kernel's are static."""
    state = (v, m, h, n, isyn)
    params = (gNa, ENa, gK, EK, gl, El, C)
    if on_cpu("hh_step", *state):
        return _ref.hh_step_ref(v, m, h, n, isyn, dt, substeps, *params)
    for name, t in zip(("v", "m", "h", "n", "isyn"), state):
        if t.shape != v.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != v {tuple(v.shape)}")
        check_operand(name, t, torch.float32)
    if not all(isinstance(p, numbers.Real) for p in params):
        raise TypeError("hh_step's parameters must be scalars (per-neuron "
                        "arrays are not the kernel's function)")
    if not isinstance(substeps, int) or substeps < 1:
        raise ValueError(f"substeps must be a positive int, got {substeps!r}")
    outs = [torch.empty_like(v) for _ in range(4)]
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().hh_step_f32(
            *(t.data_ptr() for t in state), *(o.data_ptr() for o in outs),
            v.numel(), float(dt), substeps, *map(float, params), stream)
    launches["hh_step"] += 1
    raise_on(rc, _lib().neuron_step_error_string, "hh_step")
    return tuple(outs)
