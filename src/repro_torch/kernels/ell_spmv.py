"""Wrappers around the hand-written ELL spike-propagation kernels.

``csrc/ell_spmv.cu`` replaces the TPU kernels
``repro/kernels/ell_spmv.py::ell_spmv_pallas`` and ``::ell_spmv_delay_pallas``
(its header says how, and what bounds it on the card).  ``launch_plan``
computes on the host what a call of either scatter needs (grid, block,
shared memory, the slots an item); the kernel refuses a plan whose shared
memory differs from its own layout.  Both sum in float64: ``ell_spmv`` and
``ell_spmv_delay`` round the sum to float32 once; ``ell_spmv_delay_into``
adds into a float64 scratch [n_slots, n_post, B] that the simulator keeps
between steps and folds into its dendritic ring (``kernels.delay_ring``).

Dispatch goes by where the tensors lie.  Tensors on the CPU take the plain
PyTorch version in ``repro_torch.kernels.ref``; CUDA tensors launch the
kernel on the current stream, or raise.  Nothing falls back from a failed
build or launch to the plain version.

``launches`` counts kernel launches per wrapper (plain-version calls are not
counted), so a run can show that its propagation went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (GRID_Y_MAX, INT_MAX, I, LL, P,
                                           check_operand, launch, on_cpu,
                                           raise_on)

__all__ = ["ell_spmv", "ell_spmv_delay", "ell_spmv_delay_into",
           "launch_plan", "launches", "reset_launches", "ROWS_PER_CTA",
           "MEMBERS_PER_CTA"]

# kernel name -> number of launches since the last reset_launches()
launches: Dict[str, int] = {"ell_spmv": 0, "ell_spmv_delay": 0}

ROWS_PER_CTA = 256        # presynaptic rows (and threads) of a CTA
MEMBERS_PER_CTA = 8       # batch members whose spikes a CTA reads
_ITEMS_PER_THREAD = 4     # items a thread loads before its first atomic
# the CTA's shared memory (``LiveSmem`` in the .cu): spike values
# [members][rows] float32, the live-row list uint16 [rows], live rows per
# warp int32 [rows / 32]
_SMEM_BYTES = (4 * MEMBERS_PER_CTA * ROWS_PER_CTA + 2 * ROWS_PER_CTA
               + 4 * (ROWS_PER_CTA // 32))
SMEM_MAX = 232_448        # shared memory one H100 CTA can use
GRID_X_MAX = INT_MAX
# the kernel counts a CTA's items (live rows x slots) in 32 bits
K_MAX = (INT_MAX - ROWS_PER_CTA * _ITEMS_PER_THREAD) // ROWS_PER_CTA
# the delay kernel's offsets into its scratch [n_slots, n_post, B] are
# 64-bit
INDEX_MAX = 2 ** 63 - 1


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=256)
def launch_plan(batch: int, n_pre: int, k: int, n_post: int,
                aligned: bool = True, n_slots: Optional[int] = None) -> dict:
    """What ``ell_spmv`` (or, with ``n_slots``, the delay scatter) launches
    for spikes [batch, n_pre], K slots a row and n_post targets (n_slots x
    n_post with a delay): a CTA of ``block`` threads for each
    ``ROWS_PER_CTA`` rows (grid x) and each ``MEMBERS_PER_CTA`` members
    (grid y), ``smem_bytes`` of static shared memory, ``vec`` slots an
    item (4 when K is a multiple of 4 and the operands are ``aligned``:
    16 bytes for post_ind, g and delay, 4 for valid; else 1).  Raises where
    a grid axis, a CTA's item count or an index would overflow.  The
    returned dict is shared: do not change it."""
    sizes = [("batch", batch), ("n_pre", n_pre), ("K", k), ("n_post", n_post)]
    if n_slots is not None:
        sizes.append(("n_slots", n_slots))
    for what, v in sizes:
        if not 0 <= v <= INT_MAX:
            raise ValueError(f"{what}={v} outside the kernel's int32 range")
    grid = (-(-n_pre // ROWS_PER_CTA), -(-batch // MEMBERS_PER_CTA), 1)
    if grid[1] > GRID_Y_MAX:
        raise ValueError(f"batch {batch} needs {grid[1]} CTAs on grid axis "
                         f"y, past its {GRID_Y_MAX}")
    if grid[0] > GRID_X_MAX:
        raise ValueError(f"n_pre {n_pre} needs {grid[0]} CTAs on grid axis "
                         f"x, past its {GRID_X_MAX}")
    if k > K_MAX:
        raise ValueError(f"K={k} past the kernel's {K_MAX} slots a row")
    if n_slots is not None and batch * n_slots * n_post > INDEX_MAX:
        raise ValueError(f"[{batch}, {n_slots}, {n_post}] past the "
                         "kernel's 64-bit index")
    if _SMEM_BYTES > SMEM_MAX:
        raise ValueError(f"{_SMEM_BYTES} B of shared memory past {SMEM_MAX}")
    return {"grid": grid, "block": ROWS_PER_CTA, "smem_bytes": _SMEM_BYTES,
            "vec": 4 if k % 4 == 0 and aligned else 1,
            "rows_per_cta": ROWS_PER_CTA,
            "members_per_cta": MEMBERS_PER_CTA,
            "items_per_thread": _ITEMS_PER_THREAD, "n_slots": n_slots}



@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ell_spmv")
    lib.ell_spmv_f32.argtypes = [P, LL, P, P, P, I, P, I, I, I, I, I, I, P]
    lib.ell_spmv_f32.restype = I
    lib.ell_spmv_delay_f32.argtypes = [P, LL, P, P, P, P, I, P,
                                       I, I, I, I, I, I, I, P]
    lib.ell_spmv_delay_f32.restype = I
    lib.ell_spmv_smem_bytes.argtypes = []
    lib.ell_spmv_smem_bytes.restype = I
    lib.ell_spmv_error_string.argtypes = [I]
    lib.ell_spmv_error_string.restype = ctypes.c_char_p
    return lib


def _check(g, post_ind, valid, delay, spikes) -> tuple:
    """Validate what the kernel takes; returns (batch, n_pre, k, g_stride)."""
    if spikes.dim() != 2:
        raise ValueError(f"spikes must be [B, n_pre], got {tuple(spikes.shape)}")
    batch, n_pre = spikes.shape
    if post_ind.dim() != 2 or post_ind.shape[0] != n_pre:
        raise ValueError(f"post_ind must be [n_pre={n_pre}, K], got "
                         f"{tuple(post_ind.shape)}")
    k = post_ind.shape[1]
    if valid.shape != post_ind.shape:
        raise ValueError(f"valid {tuple(valid.shape)} != post_ind {(n_pre, k)}")
    if delay is not None and delay.shape != post_ind.shape:
        raise ValueError(f"delay {tuple(delay.shape)} != post_ind {(n_pre, k)}")
    if g.shape == post_ind.shape:
        g_stride = 0
    elif g.dim() == 3 and tuple(g.shape) == (batch, n_pre, k):
        g_stride = n_pre * k
    else:
        raise ValueError(f"g must be [n_pre, K]={(n_pre, k)} or "
                         f"[B, n_pre, K]={(batch, n_pre, k)}, got "
                         f"{tuple(g.shape)}")
    check_operand("g", g, torch.float32)
    check_operand("post_ind", post_ind, torch.int32)
    check_operand("valid", valid, torch.bool)
    if delay is not None:
        check_operand("delay", delay, torch.int32)
    return batch, n_pre, k, g_stride


def _check_spikes(spikes: torch.Tensor) -> bool:
    """The kernels read float32 spikes or bool bytes; True for bool."""
    if spikes.dtype == torch.bool:
        if not spikes.is_contiguous():
            raise ValueError("spikes must be contiguous")
        return True
    check_operand("spikes", spikes, torch.float32)
    return False


def ell_spmv(g: torch.Tensor, post_ind: torch.Tensor, valid: torch.Tensor,
             spikes: torch.Tensor, n_post: int) -> torch.Tensor:
    """out[b, j] = sum_{i,k} spikes[b,i] * g[i,k] * valid[i,k]
    * (post_ind[i,k] == j).

    g: [n_pre, K] float32 (or [B, n_pre, K] for per-member weights);
    post_ind: [n_pre, K] int32; valid: [n_pre, K] bool;
    spikes: [B, n_pre] float32 or bool (a bool spike is 1.0)
    ->  [B, n_post] float32."""
    if on_cpu("ell_spmv", g, post_ind, valid, spikes):
        return _ref.ell_spmv_ref(g, post_ind, valid, spikes, n_post)
    batch, n_pre, k, g_stride = _check(g, post_ind, valid, None, spikes)
    spikes_bool = _check_spikes(spikes)
    g_ptr, ind_ptr, valid_ptr = (g.data_ptr(), post_ind.data_ptr(),
                                 valid.data_ptr())
    plan = launch_plan(batch, n_pre, k, n_post,
                       (g_ptr | ind_ptr) % 16 == 0 and valid_ptr % 4 == 0)
    # the kernel sums in float64, so its result does not depend on the
    # order of its atomics; rounded to float32 once here
    out = torch.zeros((batch, n_post), dtype=torch.float64,
                      device=spikes.device)
    rc = launch(spikes.device, _lib().ell_spmv_f32, g_ptr, g_stride, ind_ptr,
                valid_ptr, spikes.data_ptr(), int(spikes_bool),
                out.data_ptr(), batch, n_pre, k, n_post, plan["vec"],
                plan["smem_bytes"])
    launches["ell_spmv"] += 1
    raise_on(rc, _lib().ell_spmv_error_string, "ell_spmv")
    return out.to(torch.float32)


def _delay_scatter(g, post_ind, valid, delay, spikes, out) -> None:
    """Launch the delay scatter, adding into ``out`` [n_slots, n_post, B]
    float64 (CUDA tensors only)."""
    batch, n_pre, k, g_stride = _check(g, post_ind, valid, delay, spikes)
    spikes_bool = _check_spikes(spikes)
    check_operand("out", out, torch.float64)
    if out.dim() != 3 or out.shape[2] != batch:
        raise ValueError(f"out must be [n_slots, n_post, B={batch}], got "
                         f"{tuple(out.shape)}")
    n_slots, n_post = out.shape[0], out.shape[1]
    ptrs = (g.data_ptr(), post_ind.data_ptr(), valid.data_ptr(),
            delay.data_ptr())
    plan = launch_plan(batch, n_pre, k, n_post,
                       (ptrs[0] | ptrs[1] | ptrs[3]) % 16 == 0
                       and ptrs[2] % 4 == 0, n_slots)
    rc = launch(spikes.device, _lib().ell_spmv_delay_f32, ptrs[0], g_stride,
                ptrs[1], ptrs[2], ptrs[3], spikes.data_ptr(),
                int(spikes_bool), out.data_ptr(), batch, n_pre, k, n_post,
                n_slots, plan["vec"], plan["smem_bytes"])
    launches["ell_spmv_delay"] += 1
    raise_on(rc, _lib().ell_spmv_error_string, "ell_spmv_delay")


def ell_spmv_delay(g: torch.Tensor, post_ind: torch.Tensor,
                   valid: torch.Tensor, delay: torch.Tensor,
                   spikes: torch.Tensor, n_post: int,
                   n_slots: int) -> torch.Tensor:
    """Fused delay-scatter: out[b, d, j] = sum_{i,k} spikes[b,i] * g[i,k]
    * valid[i,k] * (delay[i,k] == d) * (post_ind[i,k] == j).

    As ``ell_spmv`` plus delay: [n_pre, K] int32  ->  [B, n_slots, n_post]
    float32 (summed in float64, rounded once)."""
    if on_cpu("ell_spmv_delay", g, post_ind, valid, delay, spikes):
        return _ref.ell_spmv_delay_ref(g, post_ind, valid, delay, spikes,
                                       n_post, n_slots)
    acc = torch.zeros((n_slots, n_post, spikes.shape[0]),
                      dtype=torch.float64, device=spikes.device)
    _delay_scatter(g, post_ind, valid, delay, spikes, acc)
    return _ref.delay_scratch_to_bsn(acc)


def ell_spmv_delay_into(g: torch.Tensor, post_ind: torch.Tensor,
                        valid: torch.Tensor, delay: torch.Tensor,
                        spikes: torch.Tensor, out: torch.Tensor) -> None:
    """The delay scatter added into ``out`` [n_slots, n_post, B] float64
    in place (float32 products, summed in float64; a cell's members side
    by side): the simulator's scratch, which
    ``kernels.delay_ring.delay_ring_fold`` rounds, folds into the ring and
    zeroes again."""
    if on_cpu("ell_spmv_delay", g, post_ind, valid, delay, spikes, out):
        _ref.ell_spmv_delay_into_ref(g, post_ind, valid, delay, spikes, out)
        return
    _delay_scatter(g, post_ind, valid, delay, spikes, out)
