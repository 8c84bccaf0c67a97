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
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (GRID_Y_MAX, INT_MAX, F, I, P,
                                           check_flag, check_operand, launch,
                                           on_cpu, raise_on)

__all__ = ["hh_step", "launch_plan", "launches", "reset_launches"]

launches: Dict[str, int] = {"hh_step": 0}

GRID_STRIDE_MAX = 4096    # CTAs along x; the threads loop beyond


def reset_launches() -> None:
    launches["hh_step"] = 0


@functools.lru_cache(maxsize=256)
def launch_plan(batch: int, n: int) -> dict:
    """The block and grid of a launch over [batch, n], from the occupancy
    model (``kernels.autotune.choose_block_elementwise``) with the
    registers the card reports for each compiled block: made once a shape
    (at a configuration's first step, before any capture) and cached.  A
    thread an element up to ``GRID_STRIDE_MAX`` CTAs along x, a
    grid-stride loop beyond."""
    return AT.choose_block_elementwise(n, "hh_step", batch,
                                       grid_x_max=GRID_STRIDE_MAX,
                                       tag="launch_plan")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("neuron_step")
    lib.hh_step_f32.argtypes = [P] * 11 + [I, I, F, I] + [F] * 7 + [I, I, P]
    lib.hh_step_f32.restype = I
    lib.neuron_step_error_string.argtypes = [I]
    lib.neuron_step_error_string.restype = ctypes.c_char_p
    return lib


def hh_step(v: torch.Tensor, m: torch.Tensor, h: torch.Tensor,
            n: torch.Tensor, isyn: torch.Tensor, dt: float,
            substeps: int = 5, gNa=7.15, ENa=50.0, gK=1.43, EK=-95.0,
            gl=0.02672, El=-63.563, C=0.143,
            finite: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
    """One Traub-Miles HH step of ``substeps`` Euler substeps: returns
    (v, m, h, n, above), shaped like ``v``, above = v >= 0 (bool).

    v, m, h, n, isyn: float32 tensors of one shape ([B, n] or [n]); dt in
    ms; the seven parameters are scalars, as the TPU kernel's are static.
    ``finite``: the NaN guard's flag, a bool tensor [B] (0-dim for [n]),
    cleared in place for each member whose v, m, h or n is not all
    finite."""
    state = (v, m, h, n, isyn)
    params = (gNa, ENa, gK, EK, gl, El, C)
    if on_cpu("hh_step", *state, finite):
        return _ref.hh_step_ref(v, m, h, n, isyn, dt, substeps, *params,
                                finite=finite)
    if v.dim() not in (1, 2):
        raise ValueError(f"v must be [B, n] or [n], got {tuple(v.shape)}")
    for name, t in zip(("v", "m", "h", "n", "isyn"), state):
        if t.shape != v.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != v {tuple(v.shape)}")
        check_operand(name, t, torch.float32)
    check_flag(finite, v)
    if not all(isinstance(p, numbers.Real) for p in params):
        raise TypeError("hh_step's parameters must be scalars (per-neuron "
                        "arrays are not the kernel's function)")
    if not isinstance(substeps, int) or substeps < 1:
        raise ValueError(f"substeps must be a positive int, got {substeps!r}")
    batch, n_neurons = (1, v.shape[0]) if v.dim() == 1 else v.shape
    if batch > GRID_Y_MAX or n_neurons > INT_MAX:
        raise ValueError(f"[{batch}, {n_neurons}] exceeds the kernel's grid")
    plan = launch_plan(batch, n_neurons)
    outs = torch.empty((4,) + v.shape, dtype=torch.float32,
                       device=v.device).unbind(0)
    above = torch.empty(v.shape, dtype=torch.bool, device=v.device)
    rc = launch(v.device, _lib().hh_step_f32,
                *(t.data_ptr() for t in state), *(o.data_ptr() for o in outs),
                above.data_ptr(), 0 if finite is None else finite.data_ptr(),
                batch, n_neurons, float(dt), substeps,
                # C as 1 / C rounded once from double: the plain version's
                # "/ C", as PyTorch divides by a Python float
                *map(float, params[:-1]), 1.0 / float(C),
                plan["block"], plan["grid"][0])
    launches["hh_step"] += 1
    raise_on(rc, _lib().neuron_step_error_string, "hh_step")
    return (*outs, above)
