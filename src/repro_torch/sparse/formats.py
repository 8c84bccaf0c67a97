"""Sparse synapse representations (paper Section 3), for the port.

Counterpart of ``repro/sparse/formats.py``: the ELLPACK container (fixed
number of slots per presynaptic row) as torch tensors, the paper's
eq. (1)/(2) memory model that chooses between sparse and dense storage, and
numpy copies of the host initializers.  The initializers consume the numpy
generator in the same order as the JAX package's, so the same seed gives
bit-identical graphs in both packages.

The weight and delay initializers also carry the JAX package's
``device(key, shape)`` path, over the port's threefry keys (int32 [..., 2]
tensors, ``repro_torch.random``): one draw of ``shape`` per key, on the
key's device, bit-equal to JAX's (the normal within its 4 ulp).  The
connectivity initializers' on-device counterparts are in
``repro_torch.sparse.device_init``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import random as RND
from repro_torch.kernels import threefry as _tf

__all__ = [
    "ELLSynapses",
    "sparse_memory_elements", "dense_memory_elements", "memory_bytes",
    "ell_slot_bytes", "ell_memory_bytes", "choose_representation",
    "ell_to_dense", "triple_to_ell", "fixed_fanout_connectivity",
    "ConnectivityInit", "FixedFanout", "FixedProbability", "OneToOne",
    "DenseInit",
    "WeightSnippet", "ConstantWeight", "UniformWeight", "NormalWeight",
    "DelaySnippet", "ConstantDelay", "UniformIntDelay",
]


@dataclasses.dataclass
class ELLSynapses:
    """ELLPACK: fixed max_conn slots per pre-neuron row.

    g:        conductances, float32        [nPre, max_conn]
              (or [B, nPre, max_conn] for per-batch-member weights)
    post_ind: post indices, int32 (invalid slots -> 0) [nPre, max_conn]
    valid:    slot mask, bool               [nPre, max_conn]
    delay:    per-synapse dendritic delay in dt steps (int32, invalid
              slots -> 0), or None for delay-free / homogeneous groups
              [nPre, max_conn]
    """

    g: torch.Tensor
    post_ind: torch.Tensor
    valid: torch.Tensor
    n_post: int
    delay: Optional[torch.Tensor] = None

    @property
    def n_pre(self) -> int:
        return self.post_ind.shape[0]

    @property
    def max_conn(self) -> int:
        return self.post_ind.shape[1]

    @property
    def device(self) -> torch.device:
        return self.post_ind.device


# ---------------------------------------------------------------------------
# Memory model — paper eqs. (1) and (2), in array *elements*.
# ---------------------------------------------------------------------------

def sparse_memory_elements(n_nz: int, n_pre: int, n_post: int) -> int:
    """Paper eq. (1): 2*nNZ + row-start array (pre-population sized)."""
    del n_post
    return 2 * n_nz + (n_pre + 1)


def dense_memory_elements(n_pre: int, n_post: int) -> int:
    """Paper eq. (2): nPreSynN * nPostSynN."""
    return n_pre * n_post


def memory_bytes(elements: int, dtype: torch.dtype = torch.float32) -> int:
    return int(elements) * torch.empty((), dtype=dtype).element_size()


def ell_slot_bytes(has_delay: bool = False) -> int:
    """Bytes one ELL slot occupies across its parallel arrays: g (float32)
    + post_ind (int32) + valid (bool), plus the int32 dendritic-delay slot
    when the group declares per-synapse delays."""
    return 4 + 4 + 1 + (4 if has_delay else 0)


def ell_memory_bytes(n_pre: int, max_conn: int,
                     has_delay: bool = False) -> int:
    """Resident bytes of an [n_pre, max_conn] ELL (all parallel arrays)."""
    return int(n_pre) * int(max_conn) * ell_slot_bytes(has_delay)


def choose_representation(n_pre: int, n_post: int, n_nz: int) -> str:
    """Pick 'sparse' or 'dense' from the paper's memory model."""
    sparse_cost = sparse_memory_elements(n_nz, n_pre, n_post)
    dense_cost = dense_memory_elements(n_pre, n_post)
    return "sparse" if sparse_cost < dense_cost else "dense"


# ---------------------------------------------------------------------------
# Builders / converters
# ---------------------------------------------------------------------------

def ell_to_dense(s: ELLSynapses) -> torch.Tensor:
    """The dense [n_pre, n_post] matrix of an ELL (duplicate slots sum)."""
    w = torch.zeros((s.n_pre, s.n_post), dtype=s.g.dtype, device=s.device)
    rows = torch.arange(s.n_pre, device=s.device)[:, None].expand(
        s.n_pre, s.max_conn)
    vals = torch.where(s.valid, s.g, torch.zeros((), dtype=s.g.dtype,
                                                 device=s.device))
    w.index_put_((rows.reshape(-1), s.post_ind.reshape(-1).long()),
                 vals.reshape(-1), accumulate=True)
    return w


def triple_to_ell(post_ind, g, valid, n_post: int, delay=None,
                  device=None) -> ELLSynapses:
    """ELL container on ``device`` from a resolved connectivity triple
    (plus an optional per-synapse dendritic-delay slot): host numpy arrays
    (copied to ``device``, default the CPU), or tensors from on-device
    construction (kept where they lie when ``device`` is None or theirs;
    never copied through the host).

    The arrays index the propagation ops' outputs, so they are checked
    here, where they enter: every slot (invalid ones hold 0) must target
    ``[0, n_post)`` and valid delays must be non-negative.  On tensors the
    checks are reductions on their device, read once."""
    if isinstance(post_ind, torch.Tensor):
        return _tensor_triple_to_ell(post_ind, g, valid, n_post, delay,
                                     device)
    post_ind = np.asarray(post_ind, np.int32)
    valid = np.asarray(valid, bool)
    g = np.asarray(g, np.float32)
    if post_ind.ndim != 2 or valid.shape != post_ind.shape \
            or g.shape != post_ind.shape:
        raise ValueError(f"ELL triple shapes differ: post_ind "
                         f"{post_ind.shape}, g {g.shape}, valid {valid.shape}")
    if post_ind.size and (int(post_ind.min()) < 0
                          or int(post_ind.max()) >= n_post):
        raise ValueError(f"post_ind outside [0, {n_post})")
    if delay is not None:
        delay = np.asarray(delay, np.int32)
        if delay.shape != post_ind.shape:
            raise ValueError(f"delay shape {delay.shape} != synapse shape "
                             f"{post_ind.shape}")
        if delay.size and int(delay[valid].min(initial=0)) < 0:
            raise ValueError("negative per-synapse delay")
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return ELLSynapses(
        g=torch.tensor(g, device=dev),
        post_ind=torch.tensor(post_ind, device=dev),
        valid=torch.tensor(valid, device=dev),
        n_post=int(n_post),
        delay=None if delay is None else torch.tensor(delay, device=dev))


def _tensor_triple_to_ell(post_ind: torch.Tensor, g: torch.Tensor,
                          valid: torch.Tensor, n_post: int,
                          delay: Optional[torch.Tensor],
                          device) -> ELLSynapses:
    dev = post_ind.device if device is None else torch.device(device)
    post_ind = post_ind.to(dev, torch.int32)
    g = g.to(dev, torch.float32)
    valid = valid.to(dev, torch.bool)
    if post_ind.dim() != 2 or valid.shape != post_ind.shape \
            or g.shape != post_ind.shape:
        raise ValueError(f"ELL triple shapes differ: post_ind "
                         f"{tuple(post_ind.shape)}, g {tuple(g.shape)}, "
                         f"valid {tuple(valid.shape)}")
    bad = ((post_ind < 0) | (post_ind >= n_post)).any()
    if delay is not None:
        delay = delay.to(dev, torch.int32)
        if delay.shape != post_ind.shape:
            raise ValueError(f"delay shape {tuple(delay.shape)} != synapse "
                             f"shape {tuple(post_ind.shape)}")
        bad = torch.stack([bad, ((delay < 0) & valid).any()])
    bad = bad.reshape(-1).tolist()
    if bad[0]:
        raise ValueError(f"post_ind outside [0, {n_post})")
    if len(bad) > 1 and bad[1]:
        raise ValueError("negative per-synapse delay")
    return ELLSynapses(g=g, post_ind=post_ind, valid=valid,
                       n_post=int(n_post), delay=delay)


# ---------------------------------------------------------------------------
# Weight initializers (GeNN's InitVarSnippet): the host path ``(rng, shape)
# -> array`` and the device path ``device(key, shape)`` over threefry keys.
# ---------------------------------------------------------------------------

def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


class WeightSnippet:
    """Base class for weight initializers: ``(rng, shape) -> array`` on
    the host, ``device(key, shape)`` -> float32 [..., *shape] for keys
    [..., 2]."""

    def __call__(self, rng: np.random.Generator, shape) -> np.ndarray:
        raise NotImplementedError

    def device(self, key: torch.Tensor, shape) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantWeight(WeightSnippet):
    value: float = 1.0

    def __call__(self, rng, shape) -> np.ndarray:
        return np.full(shape, self.value, np.float32)

    def device(self, key, shape) -> torch.Tensor:
        return torch.full(key.shape[:-1] + _shape(shape), self.value,
                          dtype=torch.float32, device=key.device)


@dataclasses.dataclass(frozen=True)
class UniformWeight(WeightSnippet):
    """U(lo, hi) scaled draws: ``lo + (hi - lo) * rng.random`` on the
    host; on the device ``lo + (hi - lo) * u`` in float32 as XLA's CPU
    backend compiles the JAX package's draw: one fused multiply-add, and
    with lo = 0 the add dropped (so u = 0 times a negative hi is -0.0)."""

    lo: float = 0.0
    hi: float = 1.0

    def __call__(self, rng, shape) -> np.ndarray:
        return (self.lo + (self.hi - self.lo) * rng.random(shape)).astype(
            np.float32)

    def device(self, key, shape) -> torch.Tensor:
        return _affine(key, shape, "uniform", self.hi - self.lo, self.lo)


@dataclasses.dataclass(frozen=True)
class NormalWeight(WeightSnippet):
    mean: float = 0.0
    std: float = 1.0

    def __call__(self, rng, shape) -> np.ndarray:
        return (self.mean + self.std * rng.standard_normal(shape)).astype(
            np.float32)

    def device(self, key, shape) -> torch.Tensor:
        return _affine(key, shape, "normal", self.std, self.mean)


def _affine(key: torch.Tensor, shape, dist: str, scale: float,
            offset: float) -> torch.Tensor:
    """offset + scale * draw(key, shape) in float32, as one fused
    multiply-add (a zero offset dropped, as XLA drops it)."""
    shape = _shape(shape)
    keys = key.reshape(-1, 2)
    n = int(np.prod(shape, dtype=np.int64))
    out = (_tf.threefry_draw(keys, n, dist, scale)
           if np.float32(offset) == 0.0
           else _tf.threefry_draw(keys, n, dist, scale, offset))
    return out.reshape(key.shape[:-1] + shape)


# ---------------------------------------------------------------------------
# Per-synapse delay initializers (GeNN's dendritic-delay model), host path.
# `max_steps` is the static ring-sizing bound.
# ---------------------------------------------------------------------------

class DelaySnippet:
    """Base class for per-synapse delay initializers (in dt steps): host
    ``(rng, shape)``, device ``device(key, shape)`` -> int32 [..., *shape]
    for keys [..., 2]."""

    @property
    def max_steps(self) -> int:
        """Largest delay this snippet can emit (sizes the dendritic ring)."""
        raise NotImplementedError

    def __call__(self, rng: np.random.Generator, shape) -> np.ndarray:
        raise NotImplementedError

    def device(self, key: torch.Tensor, shape) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantDelay(DelaySnippet):
    """Every synapse delays its current by the same number of dt steps."""

    steps: int = 0

    def __post_init__(self) -> None:
        if not isinstance(self.steps, int) or self.steps < 0:
            raise ValueError(
                f"ConstantDelay steps must be a non-negative int, got "
                f"{self.steps!r}")

    @property
    def max_steps(self) -> int:
        return self.steps

    def __call__(self, rng, shape) -> np.ndarray:
        return np.full(shape, self.steps, np.int32)

    def device(self, key, shape) -> torch.Tensor:
        return torch.full(key.shape[:-1] + _shape(shape), self.steps,
                          dtype=torch.int32, device=key.device)


@dataclasses.dataclass(frozen=True)
class UniformIntDelay(DelaySnippet):
    """Per-synapse delay drawn uniformly from {lo, ..., hi} (inclusive)."""

    lo: int = 0
    hi: int = 0

    def __post_init__(self) -> None:
        if (not isinstance(self.lo, int) or not isinstance(self.hi, int)
                or self.lo < 0 or self.hi < self.lo):
            raise ValueError(
                f"UniformIntDelay requires 0 <= lo <= hi (ints), got "
                f"lo={self.lo!r} hi={self.hi!r}")

    @property
    def max_steps(self) -> int:
        return self.hi

    def __call__(self, rng, shape) -> np.ndarray:
        return rng.integers(self.lo, self.hi + 1, size=shape).astype(np.int32)

    def device(self, key, shape) -> torch.Tensor:
        return RND.randint(key, shape, self.lo, self.hi + 1)


# ---------------------------------------------------------------------------
# Connectivity initializers (GeNN's InitSparseConnectivitySnippet).
# `resolve` materializes an ELL triple (post_ind, g, valid) from the passed
# numpy generator; weight_fn has the signature (rng, shape) -> array.
# ---------------------------------------------------------------------------

_Triple = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _weights(rng: np.random.Generator, shape, weight_fn) -> np.ndarray:
    if weight_fn is None:
        return np.ones(shape, np.float32)
    return np.asarray(weight_fn(rng, shape)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ConnectivityInit:
    """Base class; subclasses fill a [n_pre, K] ELL triple."""

    def resolve(self, rng: np.random.Generator, n_pre: int, n_post: int,
                weight_fn=None) -> _Triple:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class FixedFanout(ConnectivityInit):
    """Exactly n_conn random targets per pre neuron (paper's construction)."""

    n_conn: int

    def resolve(self, rng, n_pre, n_post, weight_fn=None) -> _Triple:
        post, g = fixed_fanout_connectivity(rng, n_pre, n_post, self.n_conn,
                                            weight_fn)
        return post, g, np.ones_like(post, bool)

    def describe(self) -> str:
        return f"FixedFanout(n_conn={self.n_conn})"


@dataclasses.dataclass(frozen=True)
class FixedProbability(ConnectivityInit):
    """Each (pre, post) pair connected independently with probability p:
    per-row degree Binomial(n_post, p), members uniform without
    replacement (O(nnz + n_post) memory, never a dense mask)."""

    p: float

    def resolve(self, rng, n_pre, n_post, weight_fn=None) -> _Triple:
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"FixedProbability p={self.p} outside [0, 1]")
        counts = rng.binomial(n_post, self.p, size=n_pre)
        k = max(int(counts.max(initial=0)), 1)
        post = np.zeros((n_pre, k), np.int32)
        valid = np.arange(k)[None, :] < counts[:, None]
        for i in range(n_pre):
            cols = np.sort(rng.choice(n_post, size=counts[i],
                                      replace=False))
            post[i, : counts[i]] = cols
        g = np.where(valid, _weights(rng, (n_pre, k), weight_fn), 0.0)
        return post, g.astype(np.float32), valid

    def describe(self) -> str:
        return f"FixedProbability(p={self.p})"


@dataclasses.dataclass(frozen=True)
class OneToOne(ConnectivityInit):
    """Neuron i connects to neuron i; requires equal population sizes."""

    def resolve(self, rng, n_pre, n_post, weight_fn=None) -> _Triple:
        if n_pre != n_post:
            raise ValueError(
                f"OneToOne requires n_pre == n_post, got {n_pre} != {n_post}")
        post = np.arange(n_pre, dtype=np.int32)[:, None]
        g = _weights(rng, (n_pre, 1), weight_fn)
        return post, g, np.ones_like(post, bool)


@dataclasses.dataclass(frozen=True)
class DenseInit(ConnectivityInit):
    """All-to-all connectivity (the dense matrix, in ELL form)."""

    def resolve(self, rng, n_pre, n_post, weight_fn=None) -> _Triple:
        post = np.broadcast_to(np.arange(n_post, dtype=np.int32),
                               (n_pre, n_post)).copy()
        g = _weights(rng, (n_pre, n_post), weight_fn)
        return post, g, np.ones_like(post, bool)


def fixed_fanout_connectivity(
    rng: np.random.Generator, n_pre: int, n_post: int, n_conn: int,
    weight_fn=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random connectivity with exactly n_conn targets per pre neuron
    (sampled without replacement) — the paper's construction for both
    benchmark networks.  Returns (post_ind[n_pre, n_conn], g[n_pre, n_conn]).
    """
    if n_conn > n_post:
        raise ValueError(f"n_conn={n_conn} > n_post={n_post}")
    post = np.empty((n_pre, n_conn), np.int32)
    for i in range(n_pre):
        post[i] = rng.choice(n_post, size=n_conn, replace=False)
    if weight_fn is None:
        g = np.ones((n_pre, n_conn), np.float32)
    else:
        g = weight_fn(rng, (n_pre, n_conn)).astype(np.float32)
    return post, g
