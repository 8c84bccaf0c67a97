"""JAX's random numbers: threefry2x32 keys, split, fold_in and draws.

Counterpart of the part of ``jax.random`` that the spiking-network path
uses (``PRNGKey``, ``split``, ``fold_in`` (by a word or a tensor of
them), ``bits``, ``uniform``, ``normal``, ``randint``, ``binomial``),
under JAX's partitionable threefry scheme
(``jax_threefry_partitionable``, the default).  A key is an int32 tensor
``[..., 2]`` holding the uint32 words of ``jax.random.key_data``; a leading
shape of keys draws one result per key, as ``vmap`` over keys does in JAX.

Keys, bits, uniforms and randints equal ``jax.random``'s bit for bit;
normals are within 4 float32 ulp (XLA's ``erf_inv`` polynomial, whose
``log1p`` differs between libraries in the last bits).  On a CUDA device
the work runs in the hand-written kernels of
``repro_torch.kernels.threefry``; on the CPU in their plain versions.

``binomial`` is JAX's sampler (``jax/_src/random.py`` ``_binomial``:
inversion for count * q <= 10, else BTRS), written in plain torch in
float32 over a batch of keys: each key's loop runs until its own
condition fails, as a ``vmap``-ed ``while_loop`` updates only the rows
whose condition holds.  Its ``log`` and ``log1p`` are float64's rounded
to float32, where XLA's CPU polynomial differs in the last bit on ~20% of
inputs; that flips an acceptance or a ``ceil`` only where a value lies
within an ulp of its bound (ROADMAP Queue 3).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from repro_torch.kernels import threefry as _tf

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform",
           "normal", "randint", "binomial", "smallest_k"]

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


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: key [..., 2] -> [..., 2] for
    0 <= data < 2^32; or, for an integer tensor ``data`` [R] (values in
    [0, 2^32)), keys [R, 2] or one key [2] -> [R, 2], row r folded with
    data[r] (``vmap(fold_in)``; the on-device construction's row keys)."""
    if isinstance(data, torch.Tensor):
        d = data.to(key.device).to(torch.int64)
        d = torch.where(d > 0x7FFFFFFF, d - (1 << 32), d).to(torch.int32)
        return _tf.threefry_fold_in(_flat(key), d.reshape(-1))
    if not 0 <= int(data) <= 0xFFFFFFFF:
        raise ValueError(f"data must be a uint32, got {data}")
    return _tf.threefry_fold_in(_flat(key), int(data)).reshape(key.shape)


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


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``:
    int32 [..., *shape] for keys [..., 2]."""
    shape = _shape(shape)
    lo, span = _tf.randint_span(minval, maxval)
    out = _tf.threefry_draw(_flat(key), math.prod(shape), "randint", lo=lo,
                            span=span)
    return out.reshape(key.shape[:-1] + shape)


def smallest_k(u: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest of each row of ``u`` [R, n], the lower
    index first among equal values: ``lax.top_k(-u, k)``'s indices (a
    stable ascending sort's first k), int64 [R, k]."""
    return torch.sort(u, dim=-1, stable=True).indices[..., :k]


# -- binomial (jax/_src/random.py _binomial, _binomial_inversion, _btrs,
# _stirling_approx_tail), float32 ---------------------------------------------

_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
                  0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
                  0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
                  0.00833056343336287)


def _log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float()


def _stirling_approx_tail(k: torch.Tensor) -> torch.Tensor:
    tail = torch.tensor(_STIRLING_TAIL, dtype=torch.float32, device=k.device)
    use_tail = k <= 9
    k = torch.clamp(k, 0.0, 9.0)
    kp1sq = (k + 1) * (k + 1)
    approx = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (k + 1)
    return torch.where(use_tail, tail[torch.floor(k).long()], approx)


def _while_rows(active: torch.Tensor, body) -> None:
    """Run ``body(idx)`` on the rows ``idx`` whose condition holds until
    none does: ``body`` updates those rows' carry and returns their new
    condition.  One host read of the mask a round."""
    while True:
        idx = active.nonzero().squeeze(1)
        if idx.numel() == 0:
            return
        active[idx] = body(idx)


def _binomial_inversion(keys, count, prob) -> torch.Tensor:
    r = keys.shape[0]
    log1minusprob = torch.log1p(-prob.double()).float()
    num_geom = torch.zeros(r, dtype=torch.float32, device=keys.device)
    geom_sum = torch.zeros_like(num_geom)
    keys = keys.clone()

    def body(idx):
        sub = split(keys[idx])
        gs = geom_sum[idx]
        num_geom[idx] = torch.where(gs <= count, num_geom[idx] + 1,
                                    num_geom[idx])
        u = uniform(sub[:, 0])
        gs = gs + torch.ceil(_log(u) / log1minusprob)
        geom_sum[idx] = gs
        keys[idx] = sub[:, 1]
        return gs <= count

    _while_rows(geom_sum <= count, body)
    return num_geom - 1


def _btrs(keys, count, prob) -> torch.Tensor:
    r = keys.shape[0]
    stddev = torch.sqrt((count * prob * (1 - prob)).double()).float()
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * prob
    c = count * prob + 0.5
    v_r = 0.92 - 4.2 / b
    rr = prob / (1 - prob)
    alpha = (2.83 + 5.1 / b) * stddev
    m = torch.floor((count + 1) * prob)
    k_out = torch.full((r,), -1.0, dtype=torch.float32, device=keys.device)
    keys = keys.clone()

    def body(idx):
        sub = split(keys[idx], 3)
        u = uniform(sub[:, 1])
        v = uniform(sub[:, 2])
        u = u - 0.5
        us = 0.5 - torch.abs(u)
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor((2 * a / us + b) * u + c)
        reject = (k < 0) | (k > count)
        v = _log(v * alpha / (a / (us * us) + b))
        ub = ((m + 0.5) * _log((m + 1) / (rr * (count - m + 1)))
              + (count + 1) * _log((count - m + 1) / (count - k + 1))
              + (k + 0.5) * _log(rr * (count - k + 1) / (k + 1))
              + _stirling_approx_tail(m)
              + _stirling_approx_tail(count - m)
              - _stirling_approx_tail(k)
              - _stirling_approx_tail(count - k))
        accept = accept1 | (~reject & (v <= ub))
        k_out[idx] = torch.where(accept, k, k_out[idx])
        keys[idx] = sub[:, 0]
        return ~accept

    _while_rows(torch.ones(r, dtype=torch.bool, device=keys.device), body)
    return k_out


def binomial(key: torch.Tensor, n: int, p: float) -> torch.Tensor:
    """``jax.random.binomial(key, n, p)`` (float32) for each key of
    [..., 2] -> [...]: both of JAX's samplers run (inversion with count 0
    where BTRS is chosen, BTRS with count 1e4 and q 0.5 where inversion
    is) and the result is selected, as JAX selects it."""
    keys = _flat(key)
    dev = keys.device
    prob = torch.tensor(p, dtype=torch.float32, device=dev)
    count = torch.tensor(n, dtype=torch.float32, device=dev)
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    bad = (count < 0) | torch.isnan(count) | torch.isnan(q) | (q < 0)
    q = torch.where(torch.isnan(q) | (q < 0), torch.full_like(q, 0.01), q)
    use_inversion = (count < 0) | torch.isnan(count) | (count * q <= 10.0)
    count = torch.floor(count)
    zero = torch.zeros_like(count)
    inv = _binomial_inversion(keys, torch.where(use_inversion, count, zero),
                              q)
    btrs = _btrs(keys, torch.where(use_inversion, zero + 1e4, count),
                 torch.where(use_inversion, zero + 0.5, q))
    out = torch.where(use_inversion, inv, btrs)
    out = torch.where(bad, torch.full_like(out, float("nan")), out)
    out = torch.where(p_lt_half | bad, out, count - out)
    return out.reshape(key.shape[:-1])
