"""Wrapper around the hand-written Mamba2 SSD-scan kernel.

``csrc/ssd_scan.cu`` replaces the TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan_pallas`` with two passes that run
the scan's four products on the tensor cores in 3xTF32 (float32
accuracy): C B^T once a chunk, then the scan itself; its header says how,
and what bounds it on the card.  ``launch_plan`` computes on the host
what a call needs (passes, grids, threads, shared memory, chunk,
scratch); the kernel refuses a plan whose shared memory differs from its
own layout.

``ssd_scan`` dispatches by where the tensors lie: on the CPU the plain
version ``repro_torch.models.ssm.ssd_chunked``; on a CUDA device the
kernel's two passes, on the current stream, or an error.
``ssd_scan_state`` is the same kernel for prefill: it also writes the
state each scan CTA carries after the last chunk, float32 [b, h, ds, dh]
(its plain version ``ssd_chunked(..., return_final_state=True)``); the
kernel starts from a zero state, so an ``initial_state`` is taken on the
CPU only.  ``launches`` counts kernel calls, one for the two passes,
``"ssd_scan"`` and ``"ssd_scan.state"`` apart (plain-version calls are not
counted).

``SSDScan`` is its ``torch.autograd.Function``.  Its backward recomputes
the plain ``ssd_chunked`` on the saved inputs and differentiates that by
autograd: the JAX package trains Mamba2 the same way (by autodiff of
``ssd_chunked``; its Pallas kernel has no VJP).  The forward on the card
is the kernel only; a hand-written backward is later work (ROADMAP).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import (INT_MAX, I, P, check_operand,
                                           on_cpu, raise_on)

__all__ = ["ssd_scan", "ssd_scan_state", "SSDScan", "launches",
           "reset_launches",
           "launch_plan", "MAX_HEAD_DIM", "MAX_STATE_DIM", "CHUNK", "COLS"]

launches: Dict[str, int] = {"ssd_scan": 0, "ssd_scan.state": 0}

MAX_HEAD_DIM = 64
MAX_STATE_DIM = 128
CHUNK = 32                # the kernel's chunk (rows), whatever t is
COLS = 32                 # head-dim columns of one scan CTA
_THREADS = 256
_MIN_CTAS = 3             # the scan's __launch_bounds__(256, 3)
_SMEM_SM = 233_472        # shared memory of one H100 SM
_SMEM_RESERVED = 1_024    # the runtime's share of every resident CTA


def launch_plan(b: int, t: int, h: int, dh: int, ds: int) -> dict:
    """What a call needs at x [b, t, h, dh], B/C [b, t, 1, ds]: two passes
    of 256 threads.  ``cb``: C B^T of each (batch, chunk) into a float32
    scratch of ``scratch_bytes``, its B and C tiles in static shared
    memory.  ``scan``: one CTA per (batch, head, block of ``COLS``
    head-dim columns) walking its ``chunks`` chunks of ``CHUNK`` rows;
    its dynamic shared memory holds one chunk's tiles in float32 (the
    ``Smem`` struct of ``csrc/ssd_scan.cu``, which checks it): x [32, 32 +
    4], w x split into (hi, lo) pairs [32, 32 + 2], B [32, 128 + 4], C [32,
    128 + 8], the state [128, 32 + 4], the scaled C B^T [32, 32 + 8] and
    the second half-sum of C S [32, 32 + 4] (the pitches keep the fragment
    loads free of bank conflicts).  The
    tiles always hold 32 columns of dh and 128 of ds, zero past dh and ds:
    multiples of the mma's 8."""
    q, nc = CHUNK, -(-t // CHUNK)
    floats = (q * (COLS + 4) + q * (MAX_STATE_DIM + 4)
              + q * (MAX_STATE_DIM + 8) + MAX_STATE_DIM * (COLS + 4)
              + q * (q + 8) + q * (COLS + 4))
    smem = 4 * floats + 8 * q * (COLS + 2)
    per_sm = min(_MIN_CTAS, _SMEM_SM // (smem + _SMEM_RESERVED))
    return {"passes": 2, "threads": _THREADS, "chunk": q, "chunks": nc,
            "cols": COLS,
            "cb": {"grid": (b * nc,), "smem": 2 * 4 * q * (MAX_STATE_DIM + 8)},
            "scan": {"grid": (b * h, -(-dh // COLS)), "smem": smem,
                     "ctas_per_sm": per_sm},
            "scratch_bytes": 4 * b * nc * q * q}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [P] * 9 + [I] * 6 + [P]
    lib.ssd_scan_fwd.restype = I
    lib.ssd_scan_error_string.argtypes = [I]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _plain(x, dt, A, B, C, D, **kw):
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, D, **kw)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` as float32, contiguous and starting on 16 bytes."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             D: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [b, t, h, dh], dt [b, t, h], A [h], B/C [b, t, 1, ds], D [h] or
    None -> y [b, t, h, dh] in x's dtype (the kernel computes in float32).
    No autograd: ``SSDScan.apply`` is the differentiable form."""
    if on_cpu("ssd_scan", x, dt, A, B, C, D):
        return _plain(x, dt, A, B, C, D)
    return _launch(x, dt, A, B, C, D, final_state=False)[0]


def ssd_scan_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None,
                   initial_state: Optional[torch.Tensor] = None):
    """``ssd_scan`` that also returns the state after the last chunk:
    (y [b, t, h, dh] in x's dtype, state [b, h, ds, dh] float32).  On a
    CUDA device the scan starts from zeros, and ``initial_state`` raises.
    No autograd (prefill)."""
    if on_cpu("ssd_scan", x, dt, A, B, C, D, initial_state):
        return _plain(x, dt, A, B, C, D, initial_state=initial_state,
                      return_final_state=True)
    if initial_state is not None:
        raise ValueError("the ssd_scan kernel starts from a zero state; "
                         "it takes no initial_state")
    return _launch(x, dt, A, B, C, D, final_state=True)


def _launch(x, dt, A, B, C, D, final_state: bool):
    """The kernel's two passes: (y, the final state, or None without
    ``final_state``), counted as ``"ssd_scan.state"`` or ``"ssd_scan"``."""
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 4 or C.dim() != 4:
        raise ValueError("x must be [b, t, h, dh], dt [b, t, h] and B, C "
                         "[b, t, g, ds]")
    b, t, h, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    if g != 1:
        raise NotImplementedError(
            f"the ssd_scan kernel takes n_groups == 1, got {g}")
    if tuple(dt.shape) != (b, t, h) or tuple(A.shape) != (h,) \
            or tuple(B.shape) != (b, t, 1, ds) \
            or tuple(C.shape) != tuple(B.shape) \
            or (D is not None and tuple(D.shape) != (h,)):
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)} do not fit together")
    if dh % 4 or not 0 < dh <= MAX_HEAD_DIM or ds % 4 \
            or not 0 < ds <= MAX_STATE_DIM:
        raise ValueError(f"head dim {dh}, state dim {ds}: the kernel takes "
                         f"dh <= {MAX_HEAD_DIM} and ds <= {MAX_STATE_DIM}, "
                         "both multiples of 4")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"x must be a float tensor, got {x.dtype}")
    if b * h > INT_MAX or b * -(-t // CHUNK) > INT_MAX \
            or b * t * h * dh > 2 ** 62:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid")
    ops = [_dense(a) for a in (x, dt, A, B, C)]
    d = None if D is None else _dense(D)
    for name, a in zip(("x", "dt", "A", "B", "C"), ops):
        check_operand(name, a, torch.float32)
    y = torch.empty_like(ops[0])
    fs = (torch.empty((b, h, ds, dh), dtype=torch.float32, device=x.device)
          if final_state else None)
    if y.numel() == 0:
        return y.to(x.dtype), None if fs is None else fs.zero_()
    plan = launch_plan(b, t, h, dh, ds)
    cb = torch.empty(plan["scratch_bytes"] // 4, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().ssd_scan_fwd(
            *(a.data_ptr() for a in ops), None if d is None else d.data_ptr(),
            y.data_ptr(), cb.data_ptr(), None if fs is None else fs.data_ptr(),
            b, t, h, dh, ds, plan["scan"]["smem"], stream)
    launches["ssd_scan.state" if final_state else "ssd_scan"] += 1
    raise_on(rc, _lib().ssd_scan_error_string, "ssd_scan")
    return y.to(x.dtype), fs


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with a gradient: the backward recomputes the plain
    ``ssd_chunked`` on the saved inputs under autograd and returns its
    gradients (JAX's way: autodiff of ``ssd_chunked``)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        ctx.save_for_backward(x, dt, A, B, C, D)
        return ssd_scan(x, dt, A, B, C, D)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        want = [i for i, t in enumerate(saved)
                if t is not None and ctx.needs_input_grad[i]]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(i in want)
                   if t is not None else None for i, t in enumerate(saved)]
            y = _plain(*ins)
            grads = torch.autograd.grad(y, [ins[i] for i in want], gy,
                                        allow_unused=True)
        out = [None] * len(saved)
        for i, gr in zip(want, grads):
            out[i] = gr
        return tuple(out)
