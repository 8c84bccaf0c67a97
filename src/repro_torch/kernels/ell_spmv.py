"""Wrappers around the hand-written ELL spike-propagation kernels.

``csrc/ell_spmv.cu`` replaces the TPU kernels
``repro/kernels/ell_spmv.py::ell_spmv_pallas`` and ``::ell_spmv_delay_pallas``
(its header says how, and what bounds it on the card).

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
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (GRID_Y_MAX, INT_MAX, I, LL, P,
                                           check_operand, on_cpu, raise_on)

__all__ = ["ell_spmv", "ell_spmv_delay", "launches", "reset_launches"]

# kernel name -> number of launches since the last reset_launches()
launches: Dict[str, int] = {"ell_spmv": 0, "ell_spmv_delay": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ell_spmv")
    lib.ell_spmv_f32.argtypes = [P, LL, P, P, P, P, I, I, I, I, P]
    lib.ell_spmv_f32.restype = I
    lib.ell_spmv_delay_f32.argtypes = [P, LL, P, P, P, P, P,
                                       I, I, I, I, I, P]
    lib.ell_spmv_delay_f32.restype = I
    lib.ell_spmv_error_string.argtypes = [I]
    lib.ell_spmv_error_string.restype = ctypes.c_char_p
    return lib


def _check(g, post_ind, valid, delay, spikes, n_post: int,
           n_slots: int) -> tuple:
    """Validate what the kernel takes; returns (batch, n_pre, k, g_stride)."""
    if spikes.dim() != 2:
        raise ValueError(f"spikes must be [B, n_pre], got {tuple(spikes.shape)}")
    batch, n_pre = spikes.shape
    if post_ind.dim() != 2 or post_ind.shape[0] != n_pre:
        raise ValueError(f"post_ind must be [n_pre={n_pre}, K], got "
                         f"{tuple(post_ind.shape)}")
    k = post_ind.shape[1]
    if tuple(valid.shape) != (n_pre, k):
        raise ValueError(f"valid {tuple(valid.shape)} != post_ind {(n_pre, k)}")
    if delay is not None and tuple(delay.shape) != (n_pre, k):
        raise ValueError(f"delay {tuple(delay.shape)} != post_ind {(n_pre, k)}")
    if g.dim() == 2 and tuple(g.shape) == (n_pre, k):
        g_stride = 0
    elif g.dim() == 3 and tuple(g.shape) == (batch, n_pre, k):
        g_stride = n_pre * k
    else:
        raise ValueError(f"g must be [n_pre, K]={(n_pre, k)} or "
                         f"[B, n_pre, K]={(batch, n_pre, k)}, got "
                         f"{tuple(g.shape)}")
    for name, t, dt in (("g", g, torch.float32), ("spikes", spikes,
                                                   torch.float32),
                        ("post_ind", post_ind, torch.int32),
                        ("valid", valid, torch.bool),
                        ("delay", delay, torch.int32)):
        if t is not None:
            check_operand(name, t, dt)
    if batch > GRID_Y_MAX:
        raise ValueError(f"batch {batch} exceeds the kernel's {GRID_Y_MAX}")
    for what, v in (("n_pre", n_pre), ("K", k), ("n_post", n_post),
                    ("n_slots * n_post", n_slots * n_post)):
        if not 0 <= v <= INT_MAX:
            raise ValueError(f"{what}={v} outside the kernel's int32 range")
    return batch, n_pre, k, g_stride


def ell_spmv(g: torch.Tensor, post_ind: torch.Tensor, valid: torch.Tensor,
             spikes: torch.Tensor, n_post: int) -> torch.Tensor:
    """out[b, j] = sum_{i,k} spikes[b,i] * g[i,k] * valid[i,k]
    * (post_ind[i,k] == j).

    g: [n_pre, K] float32 (or [B, n_pre, K] for per-member weights);
    post_ind: [n_pre, K] int32; valid: [n_pre, K] bool;
    spikes: [B, n_pre] float32  ->  [B, n_post] float32."""
    if on_cpu("ell_spmv", g, post_ind, valid, spikes):
        return _ref.ell_spmv_ref(g, post_ind, valid, spikes, n_post)
    batch, n_pre, k, g_stride = _check(g, post_ind, valid, None, spikes,
                                       n_post, 1)
    out = torch.zeros((batch, n_post), dtype=torch.float32,
                      device=spikes.device)
    with torch.cuda.device(spikes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().ell_spmv_f32(
            g.data_ptr(), g_stride, post_ind.data_ptr(), valid.data_ptr(),
            spikes.data_ptr(), out.data_ptr(), batch, n_pre, k, n_post,
            stream)
    launches["ell_spmv"] += 1
    raise_on(rc, _lib().ell_spmv_error_string, "ell_spmv")
    return out


def ell_spmv_delay(g: torch.Tensor, post_ind: torch.Tensor,
                   valid: torch.Tensor, delay: torch.Tensor,
                   spikes: torch.Tensor, n_post: int,
                   n_slots: int) -> torch.Tensor:
    """Fused delay-scatter: out[b, d, j] = sum_{i,k} spikes[b,i] * g[i,k]
    * valid[i,k] * (delay[i,k] == d) * (post_ind[i,k] == j).

    As ``ell_spmv`` plus delay: [n_pre, K] int32  ->  [B, n_slots, n_post]."""
    if on_cpu("ell_spmv_delay", g, post_ind, valid, delay,
              spikes):
        return _ref.ell_spmv_delay_ref(g, post_ind, valid, delay, spikes,
                                       n_post, n_slots)
    batch, n_pre, k, g_stride = _check(g, post_ind, valid, delay, spikes,
                                       n_post, n_slots)
    out = torch.zeros((batch, n_slots, n_post), dtype=torch.float32,
                      device=spikes.device)
    with torch.cuda.device(spikes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().ell_spmv_delay_f32(
            g.data_ptr(), g_stride, post_ind.data_ptr(), valid.data_ptr(),
            delay.data_ptr(), spikes.data_ptr(), out.data_ptr(), batch,
            n_pre, k, n_post, n_slots, stream)
    launches["ell_spmv_delay"] += 1
    raise_on(rc, _lib().ell_spmv_error_string, "ell_spmv_delay")
    return out
