"""JAX's random numbers: threefry2x32 keys, split, fold_in and draws.

Counterpart of the part of ``jax.random`` that the spiking-network path
uses (``PRNGKey``, ``split``, ``fold_in``, ``bits``, ``uniform``,
``normal``), under JAX's partitionable threefry scheme
(``jax_threefry_partitionable``, the default).  A key is an int32 tensor
``[..., 2]`` holding the uint32 words of ``jax.random.key_data``; a leading
shape of keys draws one result per key, as ``vmap`` over keys does in JAX.

Keys, bits and uniforms equal ``jax.random``'s bit for bit; normals are
within 4 float32 ulp (XLA's ``erf_inv`` polynomial, whose ``log1p`` differs
between libraries in the last bits).  On a CUDA device the work runs in the
hand-written kernels of ``repro_torch.kernels.threefry``; on the CPU in
their plain versions.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from repro_torch.kernels import threefry as _tf

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform",
           "normal"]

Shape = Union[int, Sequence[int]]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` makes (32-bit JAX): words
    (0, seed mod 2^32), as an int32 [2] tensor on ``device`` (default the
    CPU)."""
    lo = int(seed) & 0xFFFFFFFF
    return torch.tensor([0, lo - (1 << 32) if lo > 0x7FFFFFFF else lo],
                        dtype=torch.int32, device=device)


def _flat(key: torch.Tensor) -> torch.Tensor:
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is [..., 2], got {tuple(key.shape)}")
    return key.reshape(-1, 2)


def _shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """key [..., 2] -> [..., num, 2], as ``jax.random.split(key, num)``."""
    out = _tf.threefry_split(_flat(key), num)
    return out.reshape(key.shape[:-1] + (num, 2))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """key [..., 2] -> [..., 2], as ``jax.random.fold_in(key, data)`` for
    0 <= data < 2^32."""
    if not 0 <= int(data) <= 0xFFFFFFFF:
        raise ValueError(f"data must be a uint32, got {data}")
    return _tf.threefry_split(_flat(key), 1, int(data)).reshape(key.shape)


def _draw(key: torch.Tensor, shape: Shape, dist: str,
          scale: float = 1.0) -> torch.Tensor:
    shape = _shape(shape)
    out = _tf.threefry_draw(_flat(key), math.prod(shape), dist, scale)
    return out.reshape(key.shape[:-1] + shape)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int32 with the same
    bits, [..., *shape] for keys [..., 2]."""
    return _draw(key, shape, "bits")


def uniform(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``, float32 in [0, 1): [..., *shape]
    for keys [..., 2]."""
    return _draw(key, shape, "uniform")


def normal(key: torch.Tensor, shape: Shape = (),
           scale: float = 1.0) -> torch.Tensor:
    """``scale * jax.random.normal(key, shape)`` with ``scale`` rounded to
    float32 first (as JAX rounds a Python number beside a float32 array):
    [..., *shape] for keys [..., 2]."""
    return _draw(key, shape, "normal", scale)
