"""Wrapper around the hand-written dendritic-ring fold.

``csrc/ell_spmv.cu`` (``delay_ring_fold_f32``) folds the delay scatter's
float64 scratch into a synapse group's dendritic-delay ring in one pass,
where the JAX package runs ``ring + roll(contrib)``, reads the cursor's
slot and clears it inside its jitted step
(``repro/core/snn/synapses.py``); the ``.cu`` header says how.  It has no
TPU kernel of its own: it fuses the eager ops around the delay scatter
(``ell_spmv_delay_pallas``'s counterpart).

Dispatch goes by where the tensors lie: on the CPU the plain version
``repro_torch.kernels.ref.delay_ring_fold_ref``; on a CUDA device the
kernel, on the current stream, or an error.  ``launches`` counts kernel
launches (plain-version calls are not counted).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (INT_MAX, F, I, P,
                                           check_operand, launch, on_cpu,
                                           raise_on)

__all__ = ["delay_ring_fold", "launch_plan", "launches", "reset_launches"]

launches: Dict[str, int] = {"delay_ring_fold": 0}


def reset_launches() -> None:
    launches["delay_ring_fold"] = 0


@functools.lru_cache(maxsize=256)
def launch_plan(batch: int, n_slots: int, n_post: int,
                aligned: bool = True) -> dict:
    """What the fold launches for a ring [batch, n_slots, n_post]: a thread
    for each ``vec`` posts and member of a ring row (``vec`` 4 when n_post
    is a multiple of 4 and the operands are ``aligned`` to 16 bytes, else
    1), members fastest, ``block`` threads a CTA (grid x), one ring row a
    grid row (grid y).  The block comes from the occupancy model
    (``kernels.autotune.choose_block_elementwise``), with the registers the
    card reports for each compiled block (without a card, the shape
    alone); the wrapper makes the plan once a shape and it is cached.
    Raises where a grid axis or a size would overflow.  The
    returned dict is shared: do not change it."""
    for what, v in (("batch", batch), ("n_slots", n_slots),
                    ("n_post", n_post)):
        if not 0 <= v <= INT_MAX:
            raise ValueError(f"{what}={v} outside the kernel's int32 range")
    if n_slots < 1:
        raise ValueError("a ring has at least one slot")
    vec = 4 if n_post % 4 == 0 and aligned else 1
    cfg = AT.choose_block_elementwise(
        n_post // vec * batch, f"delay_ring_fold<{vec}>", n_slots,
        tag="launch_plan")
    return {"grid": cfg["grid"], "block": cfg["block"], "vec": vec,
            "occupancy": cfg["occupancy"],
            "resident_ctas": cfg["resident_ctas"],
            "limiter": cfg["limiter"]}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ell_spmv")
    lib.delay_ring_fold_f32.argtypes = [P, P, P, P, P, F, F,
                                        I, I, I, P, P, I, I, P]
    lib.delay_ring_fold_f32.restype = I
    lib.ell_spmv_error_string.argtypes = [I]
    lib.ell_spmv_error_string.restype = ctypes.c_char_p
    return lib


def delay_ring_fold(ring: torch.Tensor, acc: torch.Tensor,
                    cursor: torch.Tensor, sign: float,
                    gscale: Union[float, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance a dendritic ring one step: (new_ring, inj, new_cursor).

    ring: [B, S, n_post] float32, left as it is; acc: the delay scatter's
    [S, n_post, B] float64 scratch (slot d = currents due d steps from
    now), zeroed here; cursor: the ring's read row, an int32 0-dim tensor
    beside the ring (taken mod S; never read on the host, so a captured
    step reads the cursor of its replay); sign * gscale scales the scatter,
    gscale a Python number, a 0-dim tensor or a [B] tensor (on the card,
    for the kernel).  With c = cursor mod S:
    new_ring[b, r, j] = ring[b, r, j]
    + f32(sign * gscale_b) * f32(acc[(r - c) mod S, j, b]);
    inj = new_ring[:, c], then new_ring[:, c] = 0; new_cursor = (c + 1)
    mod S, a fresh int32 0-dim tensor."""
    per_member = isinstance(gscale, torch.Tensor) and gscale.dim() == 1
    if on_cpu("delay_ring_fold", ring, acc, cursor,
              gscale if per_member else None):
        return _ref.delay_ring_fold_ref(ring, acc, cursor, sign, gscale)
    if ring.dim() != 3 or tuple(acc.shape) != (ring.shape[1],
                                                ring.shape[2], ring.shape[0]):
        raise ValueError(f"ring {tuple(ring.shape)} must be [B, S, n_post] "
                         f"and acc {tuple(acc.shape)} [S, n_post, B]")
    check_operand("ring", ring, torch.float32)
    check_operand("acc", acc, torch.float64)
    if cursor.dtype != torch.int32 or cursor.dim() != 0:
        raise ValueError(f"cursor must be an int32 0-dim tensor, got "
                         f"{cursor.dtype} {tuple(cursor.shape)}")
    batch, n_slots, n_post = ring.shape
    if batch == 0 or n_post == 0:
        raise ValueError(f"an empty ring {tuple(ring.shape)}")
    if per_member:
        if tuple(gscale.shape) != (batch,):
            raise ValueError(f"gscale must be a scalar or [B={batch}], got "
                             f"{tuple(gscale.shape)}")
        check_operand("gscale", gscale, torch.float32)
        gs_ptr, scale = gscale.data_ptr(), 0.0
    else:
        # sign * gscale as _scale computes it (a 0-dim tensor's product is
        # float32; a Python number's is cast to float32 by the multiply)
        gs_ptr, scale = None, float(sign * gscale)
    new_ring = torch.empty_like(ring)
    inj = torch.empty((batch, n_post), dtype=torch.float32,
                      device=ring.device)
    new_cursor = torch.empty((), dtype=torch.int32, device=ring.device)
    ptrs = (ring.data_ptr(), acc.data_ptr(), new_ring.data_ptr(),
            inj.data_ptr())
    plan = launch_plan(batch, n_slots, n_post,
                       all(p % 16 == 0 for p in ptrs))
    rc = launch(ring.device, _lib().delay_ring_fold_f32, *ptrs, gs_ptr,
                scale, float(sign), batch, n_slots, n_post,
                cursor.data_ptr(), new_cursor.data_ptr(), plan["vec"],
                plan["block"])
    launches["delay_ring_fold"] += 1
    raise_on(rc, _lib().ell_spmv_error_string, "delay_ring_fold")
    return new_ring, inj, new_cursor
