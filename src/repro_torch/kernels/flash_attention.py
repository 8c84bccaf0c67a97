"""Wrapper around the hand-written flash-attention forward kernel.

``csrc/flash_attention.cu`` replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``; its header
says how, and what bounds it on the card.

Dispatch goes by where the tensors lie: on the CPU the plain version
``repro_torch.kernels.ref.flash_attention_ref``; on a CUDA device the kernel,
on the current stream, or an error.  The kernel reads dense row-major
``[B, H, T, D]`` operands: the wrapper makes q, k and v contiguous (a copy
when they are transposed views, as the model's ``[B, T, H, D]``
projections are) and returns a contiguous ``[B, Hq, Tq, D]`` output.
``launches`` counts kernel launches (plain-version calls are not counted).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (GRID_Y_MAX, INT_MAX, F, I, P,
                                           check_operand, on_cpu, raise_on)

__all__ = ["flash_attention", "launches", "reset_launches", "MAX_HEAD_DIM"]

launches: Dict[str, int] = {"flash_attention": 0}

MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    launches["flash_attention"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = ([P] * 4 + [I] * 7 + [F] + [I] * 4
                                        + [F, I, P])
    lib.flash_attention_fwd.restype = I
    lib.flash_attention_error_string.argtypes = [I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a dense row-major tensor whose data starts on 16 bytes
    (the kernel reads rows 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    softcap: Optional[float] = None,
                    prefix: Optional[int] = None) -> torch.Tensor:
    """q [B, Hq, Tq, D]; k, v [B, Hkv, Tk, D] -> [B, Hq, Tq, D] in q's dtype.

    Query position p (absolute: row index + ``q_offset``) attends key
    position s when s < Tk, s <= p under ``causal`` (or both lie below
    ``prefix``), and s > p - ``window`` when a window is given.  Logits are
    (q . k) * scale (default 1 / sqrt(D)), then ``softcap * tanh(x /
    softcap)``.  A query that sees no key gives 0."""
    if on_cpu("flash_attention", q, k, v):
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        scale=scale, q_offset=q_offset,
                                        softcap=softcap, prefix=prefix)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, H, T, D]")
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit together")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes D <= "
                         f"{MAX_HEAD_DIM} with D % 8 == 0")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if b * hq > GRID_Y_MAX or max(tq, tk) > INT_MAX:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} exceed "
                         "the kernel's grid")
    for name, t in (("window", window), ("prefix", prefix)):
        if t is not None and not 0 <= t <= INT_MAX:
            raise ValueError(f"{name} must be a non-negative int, got {t}")
    if abs(q_offset) > INT_MAX // 2:
        raise ValueError(f"q_offset {q_offset} does not fit the kernel")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, q.dtype)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, hq, hkv, tq, tk, d, float(s),
            int(bool(causal)), -1 if window is None else int(window),
            -1 if prefix is None else int(prefix), int(softcap is not None),
            0.0 if softcap is None else float(softcap), int(q_offset),
            stream)
    launches["flash_attention"] += 1
    raise_on(rc, _lib().flash_attention_error_string, "flash_attention")
    return out
