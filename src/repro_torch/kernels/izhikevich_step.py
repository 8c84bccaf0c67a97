"""Wrapper around the hand-written fused Izhikevich kernel.

``csrc/neuron_step.cu`` (``izhikevich_step_f32``) replaces the TPU kernel
``repro/kernels/izhikevich_step.py::izhikevich_step_pallas`` and, in its
drawing instance, the XLA normal draw of the thalamic input
(``repro/core/models/izhikevich_net.py``); its header says how, and what
bounds it on the card.  One launch is a population's whole step: it sums
the synapse groups' ``currents`` (or takes one ``isyn``), hashes the
``drive``'s normals in registers, adds the ``stim`` and updates v and u.

Dispatch goes by where the tensors lie: on the CPU the plain version
``repro_torch.kernels.ref.izhikevich_step_ref`` (the simulator's unfused
sequence of ops, then the update); on a CUDA device the kernel, on the
current stream, or an error.  ``launches`` counts kernel launches under
``"izhikevich_step"``, and those that draw a drive under
``"izhikevich_step.drive"`` as well (plain-version calls are not
counted).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (GRID_Y_MAX, INT_MAX, LL, F, I,
                                           P, check_flag, check_operand,
                                           launch, on_cpu, raise_on)

__all__ = ["izhikevich_step", "launch_plan", "launches", "reset_launches",
           "MAX_CURRENTS"]

launches: Dict[str, int] = {"izhikevich_step": 0, "izhikevich_step.drive": 0}

GRID_STRIDE_MAX = 4096    # CTAs along x; the threads loop beyond
MAX_CURRENTS = 8          # current operands a launch sums (kMaxCurrents)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=256)
def launch_plan(batch: int, n: int, drive: bool = False) -> dict:
    """The block and grid of a launch over [batch, n], from the occupancy
    model (``kernels.autotune.choose_block_elementwise``) with the
    registers the card reports for each compiled block: made once a shape
    (at a configuration's first step, before any capture) and cached.  A
    thread an element up to ``GRID_STRIDE_MAX`` CTAs along x, a
    grid-stride loop beyond.  ``drive``: the drawing instance's plan, from
    its own registers."""
    return AT.choose_block_elementwise(
        n, "izhikevich_step.drive" if drive else "izhikevich_step", batch,
        grid_x_max=GRID_STRIDE_MAX, tag="launch_plan")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("neuron_step")
    lib.izhikevich_step_f32.argtypes = ([P, P, P, I, P, LL, F, I, I, P, LL]
                                        + [P] * 8 + [I, I, F, I, I, P])
    lib.izhikevich_step_f32.restype = I
    lib.neuron_step_error_string.argtypes = [I]
    lib.neuron_step_error_string.restype = ctypes.c_char_p
    return lib


def _operand(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """A float32 [B, n] operand of the kernel, broadcast to ``shape`` and
    made dense where it is not."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    t = t.expand(shape)
    return t if t.is_contiguous() else t.contiguous()


def izhikevich_step(v: torch.Tensor, u: torch.Tensor,
                    isyn: Optional[torch.Tensor], a, b, c, d, dt: float,
                    finite: Optional[torch.Tensor] = None, *,
                    currents: Optional[Sequence[torch.Tensor]] = None,
                    drive: Optional[tuple] = None,
                    stim: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Izhikevich step: returns (v', u', spiked), shaped like ``v``.

    v, u: [B, n] (or [n]) float32; the input: ``isyn`` [B, n], or
    ``currents`` (at most ``MAX_CURRENTS`` [B, n] tensors, summed from 0.0
    in order), not both; ``drive``: ``(keys, scale, first, n_real)``, each
    member's normals of the lanes ``first + j`` (``j < n_real``; 0.0 past
    them) under its key (int32 [B, 2], rows may be strided) times the
    float32 ``scale``, added next; ``stim``: [B, n] or [n], added last.
    a, b, c, d: [n] float32 tensors (scalars too, on the CPU); dt in ms.
    ``finite``: the NaN guard's flag, a bool tensor [B] (0-dim for [n]),
    cleared in place for each member whose v' or u' is not all finite."""
    params = (a, b, c, d)
    keys = None if drive is None else drive[0]
    if on_cpu("izhikevich_step", v, u, isyn, finite, keys, stim,
              *(currents or ()),
              *(p for p in params if isinstance(p, torch.Tensor))):
        return _ref.izhikevich_step_ref(v, u, isyn, a, b, c, d, dt,
                                        finite=finite, currents=currents,
                                        drive=drive, stim=stim)
    if (isyn is None) == (currents is None):
        raise ValueError("give isyn or currents, not both")
    if v.dim() not in (1, 2):
        raise ValueError(f"v must be [B, n] or [n], got {tuple(v.shape)}")
    n = v.shape[-1]
    batch = v.shape[0] if v.dim() == 2 else 1
    for name, t in (("v", v), ("u", u)):
        if t.shape != v.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != v {tuple(v.shape)}")
        check_operand(name, t, torch.float32)
    if currents is None:
        if isyn.shape != v.shape:
            raise ValueError(f"isyn {tuple(isyn.shape)} != v "
                             f"{tuple(v.shape)}")
        check_operand("isyn", isyn, torch.float32)
        ops = [isyn]
    else:
        if len(currents) > MAX_CURRENTS:
            raise ValueError(f"{len(currents)} current operands; a launch "
                             f"sums at most {MAX_CURRENTS}")
        # each broadcast to v's shape, as the add it replaces broadcasts
        ops = [_operand(f"current {k}", t, v.shape)
               for k, t in enumerate(currents)]
    for name, p in zip("abcd", params):
        if not isinstance(p, torch.Tensor) or tuple(p.shape) != (n,):
            raise ValueError(f"param {name} must be a [{n}] tensor on the "
                             f"card (kernels.ops.izhikevich_step broadcasts "
                             f"scalars)")
        check_operand(name, p, torch.float32)
    check_flag(finite, v)
    if batch > GRID_Y_MAX or n > INT_MAX:
        raise ValueError(f"[{batch}, {n}] exceeds the kernel's grid")
    key_stride, scale, first, n_real = 0, 0.0, 0, 0
    if drive is not None:
        keys, scale, first, n_real = drive
        if (keys.dtype != torch.int32 or keys.dim() != 2
                or keys.shape != (batch, 2) or keys.stride(1) != 1):
            raise ValueError(f"drive keys must be int32 [{batch}, 2] with "
                             f"adjacent words, got {keys.dtype} "
                             f"{tuple(keys.shape)} strides {keys.stride()}")
        key_stride = keys.stride(0) if batch > 1 else 2
        if not (0 <= n_real <= n and 0 <= first
                and first + n_real <= INT_MAX):
            raise ValueError(f"drive lanes [{first}, {first} + {n_real}) "
                             f"for {n} neurons")
    stim_stride = 0
    if stim is not None:
        if stim.shape[-1:] != (n,) or stim.dim() > 2 or (
                stim.dim() == 2 and stim.shape[0] not in (1, batch)):
            raise ValueError(f"stim {tuple(stim.shape)} for v "
                             f"{tuple(v.shape)}")
        row = stim.reshape(-1, n)
        if row.shape[0] == 1:
            stim = _operand("stim", row[0], (n,))
        else:
            stim = _operand("stim", row, (batch, n))
            stim_stride = n
    plan = launch_plan(batch, n, drive is not None)
    ptrs = (ctypes.c_void_p * len(ops))(*(t.data_ptr() for t in ops))
    v_out, u_out = torch.empty((2,) + v.shape, dtype=torch.float32,
                               device=v.device).unbind(0)
    spiked = torch.empty(v.shape, dtype=torch.bool, device=v.device)
    rc = launch(v.device, _lib().izhikevich_step_f32, v.data_ptr(),
                u.data_ptr(), ctypes.addressof(ptrs), len(ops),
                None if drive is None else keys.data_ptr(), key_stride,
                float(scale), int(first), int(n_real),
                None if stim is None else stim.data_ptr(), stim_stride,
                a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                v_out.data_ptr(), u_out.data_ptr(), spiked.data_ptr(),
                0 if finite is None else finite.data_ptr(), batch, n,
                float(dt), plan["block"], plan["grid"][0])
    launches["izhikevich_step"] += 1
    if drive is not None:
        launches["izhikevich_step.drive"] += 1
    raise_on(rc, _lib().neuron_step_error_string, "izhikevich_step")
    return v_out, u_out, spiked
