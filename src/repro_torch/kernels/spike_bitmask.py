"""Wrapper around the hand-written spike-bitmask kernel.

``csrc/spike_bitmask.cu`` packs bool spikes [B, n] into GeNN's 32x bitmask
words [B, W] (int32 holding uint32's bits; neuron j is bit j % 32 of word
j // 32), which the JAX package computes with XLA ops
(``repro/core/snn/bitmask.py::pack_spikes``); the ``.cu`` header says how,
and what bounds it on the card.  ``spike_bitmask_into`` writes the words as
row ``slot`` of a ring [cap, B, W]; given as device tensors, the slot and
the ``active`` flag are read by the kernel, so a CUDA graph replays the
write at whatever row they name.

Dispatch goes by where the tensors lie: on the CPU the plain versions
``repro_torch.kernels.ref.spike_bitmask_ref`` / ``spike_bitmask_into_ref``;
on a CUDA device the kernel, on the current stream, or an error.
``launches`` counts kernel launches (plain-version calls are not counted).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (GRID_Y_MAX, LL, I, P,
                                           check_operand, launch, on_cpu,
                                           raise_on)

__all__ = ["spike_bitmask", "spike_bitmask_into", "words_for", "launch_plan",
           "launches", "reset_launches"]

launches: Dict[str, int] = {"spike_bitmask": 0}


def reset_launches() -> None:
    launches["spike_bitmask"] = 0


@functools.lru_cache(maxsize=256)
def launch_plan(batch: int, n: int) -> dict:
    """The block and grid of a launch packing [batch, n] bits (a warp a
    word: 32 threads a word), from the occupancy model
    (``kernels.autotune.choose_block_elementwise``) with the registers the
    card reports for each compiled block: made once a shape (at a
    configuration's first step, before any capture) and cached."""
    return AT.choose_block_elementwise(32 * words_for(n), "spike_bitmask",
                                       batch, tag="launch_plan")


def words_for(n: int) -> int:
    """Words needed for n spike bits (>= 1)."""
    return max(1, -(-int(n) // 32))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("spike_bitmask")
    lib.spike_bitmask.argtypes = [P, P, I, LL, LL, I, P, I, P, I, P]
    lib.spike_bitmask.restype = I
    lib.spike_bitmask_error_string.argtypes = [I]
    lib.spike_bitmask_error_string.restype = ctypes.c_char_p
    return lib


def _check_bits(bits: torch.Tensor) -> None:
    check_operand("bits", bits, torch.bool)
    if bits.dim() != 2:
        raise ValueError(f"bits must be [B, n], got {tuple(bits.shape)}")
    if bits.shape[0] > GRID_Y_MAX:
        raise ValueError(f"{bits.shape[0]} rows past grid axis y's "
                         f"{GRID_Y_MAX}")


def _launch(bits, out, cap, slot_ptr, slot, active_ptr) -> None:
    batch, n = bits.shape
    plan = launch_plan(batch, n)
    rc = launch(bits.device, _lib().spike_bitmask, bits.data_ptr(),
                out.data_ptr(), batch, n, words_for(n), cap, slot_ptr, slot,
                active_ptr, plan["block"])
    launches["spike_bitmask"] += 1
    raise_on(rc, _lib().spike_bitmask_error_string, "spike_bitmask")


def spike_bitmask(bits: torch.Tensor) -> torch.Tensor:
    """bool [B, n] -> int32 [B, words_for(n)], least significant bit
    first, trailing bits zero."""
    if on_cpu("spike_bitmask", bits):
        return _ref.spike_bitmask_ref(bits)
    _check_bits(bits)
    out = torch.empty((bits.shape[0], words_for(bits.shape[1])),
                      dtype=torch.int32, device=bits.device)
    _launch(bits, out, 1, None, 0, None)
    return out


def spike_bitmask_into(bits: torch.Tensor, ring: torch.Tensor,
                       slot: Union[int, torch.Tensor],
                       active: Optional[torch.Tensor] = None) -> None:
    """Row ``slot`` of ``ring`` [cap, B, W] int32 set to the words of
    ``bits`` [B, n].  ``slot``: a Python int, or an int32 0-dim tensor on
    the ring's device that the kernel reads; ``active``: None (always
    write) or a bool 0-dim tensor there (write only when True).  On the
    card a slot outside [0, cap) writes nothing."""
    dev_slot = isinstance(slot, torch.Tensor)
    if active is not None and not dev_slot:
        raise ValueError("a host slot takes no active flag")
    if on_cpu("spike_bitmask_into", bits, ring,
              slot if dev_slot else None, active):
        if dev_slot:
            _ref.spike_bitmask_into_ref(bits, ring, slot, active)
        else:
            ring[slot].copy_(_ref.spike_bitmask_ref(bits))
        return
    _check_bits(bits)
    check_operand("ring", ring, torch.int32)
    batch, n = bits.shape
    if ring.dim() != 3 or tuple(ring.shape[1:]) != (batch, words_for(n)):
        raise ValueError(f"ring must be [cap, {batch}, {words_for(n)}], got "
                         f"{tuple(ring.shape)}")
    if dev_slot:
        if slot.dtype != torch.int32 or slot.numel() != 1:
            raise ValueError("slot must be an int32 scalar tensor")
        slot_ptr, host_slot = slot.data_ptr(), 0
    else:
        if not 0 <= int(slot) < ring.shape[0]:
            raise ValueError(f"slot {slot} outside the ring's "
                             f"{ring.shape[0]} rows")
        slot_ptr, host_slot = None, int(slot)
    if active is not None and (active.dtype != torch.bool
                               or active.numel() != 1):
        raise ValueError("active must be a bool scalar tensor")
    _launch(bits, ring, ring.shape[0], slot_ptr, host_slot,
            None if active is None else active.data_ptr())
