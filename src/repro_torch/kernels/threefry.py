"""Wrapper around the hand-written threefry2x32 kernels.

``csrc/threefry.cu`` computes JAX's threefry key schedule and draws, which
the JAX package leaves to XLA (``jax.random``; no Pallas kernel); the
``.cu`` header says how, and what bounds it on the card.  A simulation step
splits its key once (``threefry_split``) and draws each population's input
and ``rand`` from the subkeys (``threefry_draw``), all on the device, so a
CUDA graph captures the whole key schedule.  On-device construction
(``repro_torch.sparse.device_init``) folds a key into every row and round
(``threefry_fold_in``, any number of keys), draws its targets with
``threefry_draw``'s "randint" draw (``jax.random.randint``) and its weights
with its fused affine uniform (``lo + (hi - lo) * u``).

Keys are int32 tensors holding the uint32 words of ``jax.random.key_data``.
Dispatch goes by where the tensors lie: on the CPU the plain versions
``repro_torch.kernels.ref.threefry_split_ref`` / ``threefry_draw_ref``; on a
CUDA device the kernel, on the current stream, or an error.  ``launches``
counts kernel launches (plain-version calls are not counted); the randint
draw's launches count under ``"threefry_draw.randint"``, the other draws'
under ``"threefry_draw"``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (GRID_Y_MAX, INT_MAX, LL, F, I, P,
                                           launch, on_cpu, raise_on)

__all__ = ["threefry_split", "threefry_draw", "threefry_fold_in",
           "randint_span", "launch_plan", "launches", "reset_launches",
           "DRAWS"]

DRAWS = _ref.DRAWS                  # "bits", "uniform", "normal", "randint"

launches: Dict[str, int] = {"threefry_split": 0, "threefry_draw": 0,
                            "threefry_draw.randint": 0,
                            "threefry_fold_in": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=256)
def launch_plan(kernel: str, batch: int, n: int) -> dict:
    """The block and grid of ``kernel`` ("threefry_split",
    "threefry_draw", or with batch 1 "threefry_fold_in", whose rows share
    grid axis x) over [batch, n] (a thread a key or a draw), from the
    occupancy model (``kernels.autotune.choose_block_elementwise``) with
    the registers the card reports for each compiled block: made once a
    shape (at a configuration's first step, before any capture) and
    cached."""
    return AT.choose_block_elementwise(n, kernel, batch, tag="launch_plan")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("threefry")
    lib.threefry_split.argtypes = [P, LL, P, I, I, ctypes.c_uint, I, P]
    lib.threefry_split.restype = I
    lib.threefry_draw.argtypes = [P, LL, P, I, LL, I, F, F, I, I,
                                  ctypes.c_uint, I, P]
    lib.threefry_draw.restype = I
    lib.threefry_fold_in.argtypes = [P, LL, P, ctypes.c_uint, P, LL, I, P]
    lib.threefry_fold_in.restype = I
    lib.threefry_error_string.argtypes = [I]
    lib.threefry_error_string.restype = ctypes.c_char_p
    return lib


def _check_keys(keys: torch.Tensor, rows_max: int = GRID_Y_MAX) -> int:
    """keys [B, 2] int32 whose two words are adjacent (rows may be strided,
    as a column of split's [B, num, 2] is); returns the row stride."""
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32 (uint32 bits), got {keys.dtype}")
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.stride(1) != 1:
        raise ValueError(f"keys must be [B, 2] with adjacent words, got "
                         f"shape {tuple(keys.shape)} strides "
                         f"{keys.stride()}")
    if keys.shape[0] > rows_max:
        raise ValueError(f"{keys.shape[0]} keys past grid axis y's "
                         f"{GRID_Y_MAX}")
    return keys.stride(0) if keys.shape[0] > 1 else 2


def threefry_split(keys: torch.Tensor, num: int,
                   first: int = 0) -> torch.Tensor:
    """keys [B, 2] -> [B, num, 2] int32: key i of member b hashes the
    counter (0, first + i) under keys[b] (``jax.random.split(k, num)`` with
    first 0; ``fold_in(k, first)`` with num 1)."""
    if not 0 <= num <= INT_MAX or not 0 <= first + num <= 2 ** 32:
        raise ValueError(f"num={num}, first={first}: counters past 32 bits")
    if on_cpu("threefry_split", keys):
        return _ref.threefry_split_ref(keys, num, first)
    stride = _check_keys(keys)
    out = torch.empty((keys.shape[0], num, 2), dtype=torch.int32,
                      device=keys.device)
    plan = launch_plan("threefry_split", keys.shape[0], num)
    rc = launch(keys.device, _lib().threefry_split, keys.data_ptr(), stride,
                out.data_ptr(), keys.shape[0], num, first, plan["block"])
    launches["threefry_split"] += 1
    raise_on(rc, _lib().threefry_error_string, "threefry_split")
    return out


def threefry_draw(keys: torch.Tensor, n: int, dist: str,
                  scale: float = 1.0, offset: Optional[float] = None, *,
                  lo: int = 0, span: Optional[int] = None) -> torch.Tensor:
    """keys [B, 2] -> [B, n]: each member's ``jax.random.bits`` (int32
    holding the uint32 bits), ``uniform`` or ``normal`` draw of shape (n,)
    under its key, the float draws times the float32 ``scale``, or with an
    ``offset`` ``fma(draw, scale, offset)`` rounded once; or the "randint"
    draw, int32 ``jax.random.randint(key, (n,), lo, lo + span)`` for an
    int32 ``lo`` and a uint32 ``span`` (0 standing for 2^32; see
    ``randint_span``).  More than 65535 keys take a launch per 65535."""
    if dist not in DRAWS:
        raise ValueError(f"dist must be one of {DRAWS}, got {dist!r}")
    if not 0 <= n < 2 ** 63:
        raise ValueError(f"n={n} outside the counters' range")
    randint = dist == "randint"
    if randint and (span is None or not 0 <= span <= 0xFFFFFFFF
                    or not -2 ** 31 <= lo < 2 ** 31):
        raise ValueError(f"the randint draw takes an int32 lo and a uint32 "
                         f"span, got lo={lo}, span={span}")
    if on_cpu("threefry_draw", keys):
        return _ref.threefry_draw_ref(keys, n, dist, scale, offset, lo=lo,
                                      span=span)
    _check_keys(keys, rows_max=INT_MAX)
    out = torch.empty((keys.shape[0], n), device=keys.device,
                      dtype=(torch.int32 if dist in ("bits", "randint")
                             else torch.float32))
    counter = "threefry_draw.randint" if randint else "threefry_draw"
    for first in range(0, keys.shape[0], GRID_Y_MAX):
        part = keys[first:first + GRID_Y_MAX]
        stride = _check_keys(part)
        plan = launch_plan("threefry_draw", part.shape[0], n)
        rc = launch(keys.device, _lib().threefry_draw, part.data_ptr(),
                    stride, out[first:first + GRID_Y_MAX].data_ptr(),
                    part.shape[0], n, DRAWS.index(dist), float(scale),
                    0.0 if offset is None else float(offset),
                    int(offset is not None), int(lo),
                    int(span) if randint else 0, plan["block"])
        launches[counter] += 1
        raise_on(rc, _lib().threefry_error_string, "threefry_draw")
    return out


def threefry_fold_in(keys: torch.Tensor,
                     data: Union[int, torch.Tensor]) -> torch.Tensor:
    """keys [B, 2] (or [1, 2], one key for every row) folded with data
    (an int32 tensor [B] holding uint32 bits, or one uint32 for every row)
    -> [B, 2] int32: row b is ``jax.random.fold_in(keys[b], data[b])``."""
    tensor_data = isinstance(data, torch.Tensor)
    if tensor_data:
        if data.dtype != torch.int32 or data.dim() != 1:
            raise ValueError(f"data must be an int32 [B] tensor (uint32 "
                             f"bits), got {data.dtype} "
                             f"{tuple(data.shape)}")
        n = data.shape[0]
        if keys.shape[0] not in (1, n):
            raise ValueError(f"{keys.shape[0]} keys for {n} data words")
    else:
        if not 0 <= int(data) <= 0xFFFFFFFF:
            raise ValueError(f"data must be a uint32, got {data}")
        n = keys.shape[0]
    if on_cpu("threefry_fold_in", keys, data if tensor_data else None):
        return _ref.threefry_fold_in_ref(keys, data)
    stride = _check_keys(keys, rows_max=INT_MAX)
    if keys.shape[0] == 1:
        stride = 0                      # one key serves every row
    if tensor_data:
        data = data.contiguous()
    out = torch.empty((n, 2), dtype=torch.int32, device=keys.device)
    plan = launch_plan("threefry_fold_in", 1, n)
    rc = launch(keys.device, _lib().threefry_fold_in, keys.data_ptr(),
                stride, data.data_ptr() if tensor_data else None,
                0 if tensor_data else int(data), out.data_ptr(), n,
                plan["block"])
    launches["threefry_fold_in"] += 1
    raise_on(rc, _lib().threefry_error_string, "threefry_fold_in")
    return out


def randint_span(minval: int, maxval: int) -> tuple:
    """(lo, span) of ``jax.random.randint(k, s, minval, maxval, int32)``:
    the bounds clipped to int32, span = maxval - minval as uint32 (1 where
    maxval <= minval; one more where maxval passed int32's top, 0 standing
    for 2^32)."""
    lo = min(max(int(minval), -2 ** 31), 2 ** 31 - 1)
    hi = min(max(int(maxval), -2 ** 31), 2 ** 31 - 1)
    span = (hi - lo) & 0xFFFFFFFF if hi > lo else 1
    if int(maxval) > 2 ** 31 - 1 and hi > lo:
        span = (span + 1) & 0xFFFFFFFF
    return lo, span
