"""Wrapper around the hand-written threefry2x32 kernels.

``csrc/threefry.cu`` computes JAX's threefry key schedule and draws, which
the JAX package leaves to XLA (``jax.random``; no Pallas kernel); the
``.cu`` header says how, and what bounds it on the card.  A simulation step
splits its key once (``threefry_split``) and draws each population's input
and ``rand`` from the subkeys (``threefry_draw``), all on the device, so a
CUDA graph captures the whole key schedule.

Keys are int32 tensors holding the uint32 words of ``jax.random.key_data``.
Dispatch goes by where the tensors lie: on the CPU the plain versions
``repro_torch.kernels.ref.threefry_split_ref`` / ``threefry_draw_ref``; on a
CUDA device the kernel, on the current stream, or an error.  ``launches``
counts kernel launches (plain-version calls are not counted).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (GRID_Y_MAX, INT_MAX, LL, F, I, P,
                                           launch, on_cpu, raise_on)

__all__ = ["threefry_split", "threefry_draw", "launch_plan", "launches",
           "reset_launches", "DRAWS"]

DRAWS = _ref.DRAWS                  # "bits", "uniform", "normal"

launches: Dict[str, int] = {"threefry_split": 0, "threefry_draw": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=256)
def launch_plan(kernel: str, batch: int, n: int) -> dict:
    """The block and grid of ``kernel`` ("threefry_split" or
    "threefry_draw") over [batch, n] (a thread a key or a draw), from the
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
    lib.threefry_draw.argtypes = [P, LL, P, I, LL, I, F, I, P]
    lib.threefry_draw.restype = I
    lib.threefry_error_string.argtypes = [I]
    lib.threefry_error_string.restype = ctypes.c_char_p
    return lib


def _check_keys(keys: torch.Tensor) -> int:
    """keys [B, 2] int32 whose two words are adjacent (rows may be strided,
    as a column of split's [B, num, 2] is); returns the row stride."""
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32 (uint32 bits), got {keys.dtype}")
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.stride(1) != 1:
        raise ValueError(f"keys must be [B, 2] with adjacent words, got "
                         f"shape {tuple(keys.shape)} strides "
                         f"{keys.stride()}")
    if keys.shape[0] > GRID_Y_MAX:
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
                  scale: float = 1.0) -> torch.Tensor:
    """keys [B, 2] -> [B, n]: each member's ``jax.random.bits`` (int32
    holding the uint32 bits), ``uniform`` or ``normal`` draw of shape (n,)
    under its key, the float draws times the float32 ``scale``."""
    if dist not in DRAWS:
        raise ValueError(f"dist must be one of {DRAWS}, got {dist!r}")
    if not 0 <= n < 2 ** 63:
        raise ValueError(f"n={n} outside the counters' range")
    if on_cpu("threefry_draw", keys):
        return _ref.threefry_draw_ref(keys, n, dist, scale)
    stride = _check_keys(keys)
    out = torch.empty((keys.shape[0], n), device=keys.device,
                      dtype=torch.int32 if dist == "bits" else torch.float32)
    plan = launch_plan("threefry_draw", keys.shape[0], n)
    rc = launch(keys.device, _lib().threefry_draw, keys.data_ptr(), stride,
                out.data_ptr(), keys.shape[0], n, DRAWS.index(dist),
                float(scale), plan["block"])
    launches["threefry_draw"] += 1
    raise_on(rc, _lib().threefry_error_string, "threefry_draw")
    return out
