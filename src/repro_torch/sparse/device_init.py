"""On-device connectivity construction (the build-time hot path).

Counterpart of ``repro/sparse/device_init.py``, after "Runtime Construction
of Large-Scale Spiking Neuronal Network Models on GPU Devices" (Golosio et
al., 2023): the synapse graph is generated on the device, in parallel, as
ELL triples in O(nnz) memory, from the same ``ConnectivityInit``
declarations the host path resolves.

* **Counter-based randomness.**  Every row draws from
  ``fold_in(base_key, global_row_index)`` (JAX's threefry,
  ``repro_torch.random``), a pure function of (seed, row): generating rows
  [0, n) in one call equals concatenating any partition of the rows
  (``rows=``), and every graph equals the JAX package's bit for bit
  (``FixedProbability``'s degrees where a float32 ``log`` agrees, ROADMAP
  Queue 3).
* **O(nnz) memory.**  Fixed-fanout sampling without replacement draws k
  values a row and redraws the duplicate slots with fresh counters until
  every row is distinct (``_distinct_redraw``: at most 64 rounds, one host
  read a round; a row stops once it has no duplicate, as JAX's ``vmap``-ed
  ``while_loop`` stops it).  Only when k > n_post / 2 does a row sort
  n_post uniforms (``_distinct_topk``).
* **Kernels.**  Row and round keys come from ``threefry_split`` /
  ``threefry_fold_in``, targets from ``threefry_draw``'s randint draw and
  weights from its fused affine uniform, all hand-written
  (``kernels/csrc/threefry.cu``); on the CPU their plain versions.  The
  sorts, the duplicate masks and the binomial are plain torch.

The device is the key's: a key on a CUDA device builds there (the kernels
or an error, never the CPU).  ``device_init_local`` and ``LocalInitPlan``
(the fused per-device path) need a mesh and wait for ROADMAP Queue 1 item
7; ``partition_ell_by_post`` repacks a built ELL into post-shard blocks.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch import random as RND
from repro_torch.kernels import threefry as _tf
from repro_torch.obs import trace
from repro_torch.sparse import formats as F

__all__ = [
    "device_resolve", "device_fixed_fanout", "device_fixed_probability",
    "device_one_to_one", "device_dense", "partition_ell_by_post",
    "as_device_weight", "as_device_delay", "device_delays",
    "construction_peak_model",
]

_Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # post, g, valid

_MAX_REDRAW_ROUNDS = 64  # residual-duplicate probability < 2**-64 per slot


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def as_device_weight(weight) -> F.WeightSnippet:
    """Normalize a ModelSpec weight declaration to a device-capable snippet.

    None -> ConstantWeight(1); scalars -> ConstantWeight(x); WeightSnippet
    passes through.  Raw numpy callables cannot run on the device — raise
    with the fix spelled out.
    """
    if weight is None:
        return F.ConstantWeight(1.0)
    if isinstance(weight, F.WeightSnippet):
        return weight
    if isinstance(weight, (int, float)):
        return F.ConstantWeight(float(weight))
    raise TypeError(
        f"device-side construction needs a dual-backend weight initializer "
        f"(ConstantWeight / UniformWeight / NormalWeight, or a scalar), got "
        f"{weight!r}; host-only numpy callables cannot run under jit — "
        "declare the weight as a WeightSnippet or build with init='host'")


def as_device_delay(delay) -> F.DelaySnippet:
    """Normalize a delay declaration to a device-capable snippet.

    Ints -> ConstantDelay(x); DelaySnippet passes through.  Raw numpy
    callables cannot run on the device — raise with the fix spelled out.
    """
    if isinstance(delay, F.DelaySnippet):
        return delay
    if isinstance(delay, int) and not isinstance(delay, bool):
        return F.ConstantDelay(delay)
    raise TypeError(
        f"device-side construction needs a dual-backend delay initializer "
        f"(ConstantDelay / UniformIntDelay, or an int), got {delay!r}; "
        "host-only numpy callables cannot run under jit — declare the delay "
        "as a DelaySnippet or build with init='host'")


def _rows_or_default(rows, n_pre: int, device) -> Optional[torch.Tensor]:
    """None (every row, 0..n_pre-1) or the rows as int32 on ``device``."""
    if rows is None:
        return None
    return torch.as_tensor(rows).to(device=device, dtype=torch.int32)


def _row_index(rows: Optional[torch.Tensor], n_pre: int,
               device) -> torch.Tensor:
    if rows is None:
        return torch.arange(n_pre, dtype=torch.int32, device=device)
    return rows


def _n_rows(rows: Optional[torch.Tensor], n_pre: int) -> int:
    return n_pre if rows is None else rows.shape[0]


def _row_keys(key: torch.Tensor, rows: Optional[torch.Tensor],
              n_pre: int) -> torch.Tensor:
    """[R, 2]: fold_in(key, r) for each row r; every row is one split of
    the key (split's key i hashes the counter (0, i), as fold_in does)."""
    if rows is None:
        return _tf.threefry_split(key.reshape(1, 2), n_pre)[0]
    return RND.fold_in(key, rows)


def _row_weights(weight: F.WeightSnippet, key: torch.Tensor,
                 rows: Optional[torch.Tensor], n_pre: int,
                 k: int) -> torch.Tensor:
    """Per-row keyed weight draws: w[r] depends only on (seed, global row)."""
    wkey = RND.fold_in(key, 0x5EED)
    return weight.device(_row_keys(wkey, rows, n_pre), (k,))


def device_delays(key: torch.Tensor, n_pre: int, k: int, delay,
                  rows=None) -> torch.Tensor:
    """[len(rows), k] int32 per-synapse dendritic delays, generated on the
    key's device with the same counter-based key schedule as connectivity
    and weights: row r draws from fold_in(fold_in(key, 0xDE1A), r), a pure
    function of (seed, global row)."""
    snip = as_device_delay(delay)
    rows = _rows_or_default(rows, n_pre, key.device)
    dkey = RND.fold_in(key, 0xDE1A)
    return snip.device(_row_keys(dkey, rows, n_pre), (k,)).to(torch.int32)


# ---------------------------------------------------------------------------
# distinct sampling: k targets per row, uniform without replacement
# ---------------------------------------------------------------------------

def _distinct_topk(rks: torch.Tensor, n_post: int, k: int) -> torch.Tensor:
    """Uniform k-subsets via the k smallest of n_post iid uniforms a row
    (``lax.top_k(-u, k)``: the lower index first among equal values), the
    indices sorted.  O(n_post) a row — used only when k > n_post/2."""
    u = RND.uniform(rks, (n_post,))
    idx = RND.smallest_k(u, k).to(torch.int32)
    return torch.sort(idx, dim=1).values


def _dup_mask(vals: torch.Tensor) -> torch.Tensor:
    """[R, k] bool: slot j of a sorted row equals slot j - 1."""
    out = torch.zeros_like(vals, dtype=torch.bool)
    out[:, 1:] = vals[:, 1:] == vals[:, :-1]
    return out


def _distinct_redraw(rks: torch.Tensor, n_post: int, k: int) -> torch.Tensor:
    """Uniform k-subsets in O(k) memory a row: draw k iid values, then in
    round i replace the duplicate slots of the sorted row with a fresh
    draw from fold_in(row key, i) and sort again, while the row has a
    duplicate (at most 64 rounds) — sequential sampling without
    replacement.  The rows of a round are those still holding a duplicate
    (one host read a round); the rounds run are reported as the
    ``device_init.redraw`` trace instant."""
    vals = torch.sort(RND.randint(RND.fold_in(rks, 0), (k,), 0, n_post),
                      dim=1).values
    dup = _dup_mask(vals)
    active = dup.any(dim=1)
    rounds = 0
    for i in range(1, _MAX_REDRAW_ROUNDS):
        idx = active.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        rounds = i
        fresh = RND.randint(RND.fold_in(rks[idx], i), (k,), 0, n_post)
        v = torch.sort(torch.where(dup[idx], fresh, vals[idx]), dim=1).values
        d = _dup_mask(v)
        vals[idx] = v
        dup[idx] = d
        active[idx] = d.any(dim=1)
    trace.instant("device_init.redraw", rows=rks.shape[0], n_post=n_post,
                  k=k, rounds=rounds)
    return vals


def _sample_distinct_rows(key: torch.Tensor, rows: Optional[torch.Tensor],
                          n_pre: int, n_post: int, k: int) -> torch.Tensor:
    """[len(rows), k] int32, each row a uniform k-subset of [0, n_post),
    sorted ascending, keyed by the *global* row index."""
    if k > n_post:
        raise ValueError(f"k={k} > n_post={n_post}")
    n_rows = _n_rows(rows, n_pre)
    if k == n_post:
        return torch.arange(n_post, dtype=torch.int32,
                            device=key.device).repeat(n_rows, 1)
    rks = _row_keys(key, rows, n_pre)
    one = _distinct_topk if k > n_post // 2 else _distinct_redraw
    return one(rks, n_post, k)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def device_fixed_fanout(key: torch.Tensor, n_pre: int, n_post: int,
                        n_conn: int, weight=None, rows=None) -> _Triple:
    """Exactly n_conn distinct random targets per pre row, on the key's
    device."""
    rows = _rows_or_default(rows, n_pre, key.device)
    post = _sample_distinct_rows(RND.fold_in(key, 0xC0), rows, n_pre,
                                 n_post, n_conn)
    g = _row_weights(as_device_weight(weight), key, rows, n_pre, n_conn)
    return post, g.to(torch.float32), torch.ones_like(post, dtype=torch.bool)


def _binomial_slots(n_post: int, p: float) -> int:
    """Static slot count covering Binomial(n_post, p) row degrees: mean plus
    six standard deviations (residual clamp probability < 1e-9 per row)."""
    mean = n_post * p
    std = math.sqrt(max(n_post * p * (1.0 - p), 0.0))
    return int(min(n_post, max(1, math.ceil(mean + 6.0 * std + 1.0))))


def _fixed_probability_rows(
    key: torch.Tensor, rows, n_post: int, p: float, k: int,
    n_pre: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(post [R, k], counts [R], overflow [R] bool): per-row
    Binomial(n_post, p) degrees, then a uniform degree-subset of targets (a
    k-subset randomly permuted, first `count` slots valid) — the per-pair
    Bernoulli model, marginalized.  A raw degree draw above the static slot
    padding `k` is clamped, and the row is flagged in `overflow`.  ``rows``
    None means 0..n_pre-1."""
    if rows is not None:
        rows = _rows_or_default(rows, 0, key.device)
    ckey = RND.fold_in(key, 0xDE)
    rks = _row_keys(ckey, rows, n_pre)
    raw = RND.binomial(RND.fold_in(rks, 1), n_post, p).to(torch.int32)
    cnt = torch.clamp(raw, 0, k)
    one = _distinct_topk if k > n_post // 2 else _distinct_redraw
    vals = one(RND.fold_in(rks, 2), n_post, k)
    u = RND.uniform(RND.fold_in(rks, 3), (k,))
    perm = torch.sort(u, dim=1, stable=True).indices
    return torch.gather(vals, 1, perm), cnt, raw > k


def _report_overflow(n_rows: int, *, n_pre: int, n_post: int, p: float,
                     k: int) -> None:
    """Surface clamped FixedProbability rows through the trace timeline."""
    n = int(n_rows)
    if n > 0:
        trace.instant("device_init.overflow", kind="fixed_probability",
                      rows_clamped=n, rows=n_pre, n_post=n_post, p=float(p),
                      max_k=k)


def device_fixed_probability(key: torch.Tensor, n_pre: int, n_post: int,
                             p: float, weight=None, rows=None) -> _Triple:
    """Each (pre, post) pair connected independently with probability p."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"FixedProbability p={p} outside [0, 1]")
    rows = _rows_or_default(rows, n_pre, key.device)
    k = _binomial_slots(n_post, p)
    post, counts, over = _fixed_probability_rows(key, rows, n_post, p, k,
                                                 n_pre=n_pre)
    _report_overflow(over.sum(), n_pre=n_pre, n_post=n_post, p=p, k=k)
    valid = (torch.arange(k, dtype=torch.int32, device=key.device)[None, :]
             < counts[:, None])
    g = _row_weights(as_device_weight(weight), key, rows, n_pre, k)
    g = torch.where(valid, g, torch.zeros((), dtype=torch.float32,
                                          device=key.device))
    post = torch.where(valid, post, torch.zeros((), dtype=torch.int32,
                                                device=key.device))
    return post.to(torch.int32), g.to(torch.float32), valid


def device_one_to_one(key: torch.Tensor, n_pre: int, n_post: int,
                      weight=None, rows=None) -> _Triple:
    if n_pre != n_post:
        raise ValueError(
            f"OneToOne requires n_pre == n_post, got {n_pre} != {n_post}")
    rows = _rows_or_default(rows, n_pre, key.device)
    post = _row_index(rows, n_pre, key.device)[:, None]
    g = _row_weights(as_device_weight(weight), key, rows, n_pre, 1)
    return post, g.to(torch.float32), torch.ones_like(post, dtype=torch.bool)


def device_dense(key: torch.Tensor, n_pre: int, n_post: int, weight=None,
                 rows=None) -> _Triple:
    rows = _rows_or_default(rows, n_pre, key.device)
    post = torch.arange(n_post, dtype=torch.int32, device=key.device).repeat(
        _n_rows(rows, n_pre), 1)
    g = _row_weights(as_device_weight(weight), key, rows, n_pre, n_post)
    return post, g.to(torch.float32), torch.ones_like(post, dtype=torch.bool)


def device_resolve(connect: F.ConnectivityInit, key: torch.Tensor,
                   n_pre: int, n_post: int, weight=None,
                   rows=None) -> _Triple:
    """Dispatch a ConnectivityInit declaration to its device initializer:
    (post_ind int32, g float32, valid bool), [len(rows), K] on the key's
    device."""
    if isinstance(connect, F.FixedFanout):
        return device_fixed_fanout(key, n_pre, n_post, connect.n_conn,
                                   weight, rows)
    if isinstance(connect, F.FixedProbability):
        return device_fixed_probability(key, n_pre, n_post, connect.p,
                                        weight, rows)
    if isinstance(connect, F.OneToOne):
        return device_one_to_one(key, n_pre, n_post, weight, rows)
    if isinstance(connect, F.DenseInit):
        return device_dense(key, n_pre, n_post, weight, rows)
    raise NotImplementedError(
        f"no device-side kernel for {connect.describe()}; build with "
        "init='host' or add a kernel to repro_torch.sparse.device_init")


# ---------------------------------------------------------------------------
# post-sharding: repack a built ELL into per-device blocks
# ---------------------------------------------------------------------------

def _sorted_shards(post_ind: torch.Tensor, valid: torch.Tensor,
                   n_shards: int, shard_size: int) -> torch.Tensor:
    """Each slot's shard (invalid slots: n_shards), int64."""
    shard = torch.div(post_ind.long(), shard_size, rounding_mode="floor")
    return torch.where(valid, shard, torch.full_like(shard, n_shards))


def _edges(shard_s: torch.Tensor, n_shards: int) -> torch.Tensor:
    bounds = torch.arange(n_shards + 1, dtype=shard_s.dtype,
                          device=shard_s.device).expand(shard_s.shape[0], -1)
    return torch.searchsorted(shard_s.contiguous(), bounds.contiguous(),
                              side="left")


def _shard_counts(post_ind: torch.Tensor, valid: torch.Tensor,
                  n_shards: int, shard_size: int) -> torch.Tensor:
    """[rows, n_shards] slot counts per (pre row, post shard), from the
    sorted shard ids' searchsorted boundaries (never an [rows, K, D]
    one-hot); every op is per-row independent."""
    shard_s = torch.sort(_sorted_shards(post_ind, valid, n_shards,
                                        shard_size), dim=1).values
    return torch.diff(_edges(shard_s, n_shards), dim=1)


def _partition_rows(
    g: torch.Tensor, post_ind: torch.Tensor, valid: torch.Tensor,
    delay: Optional[torch.Tensor], n_shards: int, shard_size: int,
    k_local: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Repack ELL rows into [n_shards, rows, k_local] post-shard blocks.

    Slot (i, k) goes to the shard owning post neuron post_ind[i, k],
    compacted left and re-indexed to shard-local post ids; the within-row
    slot order is preserved (a stable sort), so per-post-neuron scatter
    accumulation order matches the input slot order."""
    n_rows, k = g.shape
    dev = g.device
    shard = _sorted_shards(post_ind, valid, n_shards, shard_size)
    order = torch.sort(shard, dim=1, stable=True).indices
    shard_s = torch.gather(shard, 1, order)
    post_s = torch.gather(post_ind.long(), 1, order)
    g_s = torch.gather(torch.where(valid, g, torch.zeros_like(g)), 1, order)
    delay_s = (None if delay is None else torch.gather(
        torch.where(valid, delay, torch.zeros_like(delay)), 1, order))
    counts = torch.diff(_edges(shard_s, n_shards), dim=1)
    start = torch.cat([torch.zeros((n_rows, 1), dtype=counts.dtype,
                                   device=dev),
                       torch.cumsum(counts, dim=1)[:, :-1]], dim=1)
    slot = torch.arange(k, device=dev)[None, :] - torch.gather(
        start, 1, torch.clamp(shard_s, 0, n_shards - 1))
    row = torch.arange(n_rows, device=dev)[:, None].expand(n_rows, k)
    keep = shard_s < n_shards           # invalid slots are dropped
    at = (shard_s[keep], row[keep], slot[keep])
    shape = (n_shards, n_rows, k_local)
    g_out = torch.zeros(shape, dtype=torch.float32, device=dev)
    g_out[at] = g_s[keep].to(torch.float32)
    post_out = torch.zeros(shape, dtype=torch.int32, device=dev)
    post_out[at] = (post_s - shard_s * shard_size)[keep].to(torch.int32)
    valid_out = torch.zeros(shape, dtype=torch.bool, device=dev)
    valid_out[at] = True
    delay_out = None
    if delay_s is not None:
        delay_out = torch.zeros(shape, dtype=torch.int32, device=dev)
        delay_out[at] = delay_s[keep].to(torch.int32)
    return g_out, post_out, valid_out, delay_out


def partition_ell_by_post(ell: F.ELLSynapses, n_shards: int) -> tuple:
    """Split an ELL column-wise into ``n_shards`` post-neuron shards.

    Returns (g, post_local, valid, delay_local, shard_size, k_local) with
    the tensors shaped [n_shards, n_pre, k_local]: shard d holds, for every
    pre row, the slots whose post neuron lives in [d*shard_size,
    (d+1)*shard_size), compacted left (order kept) and re-indexed to
    shard-local post ids; delay_local is None for a delay-free ELL."""
    shard_size = -(-ell.n_post // n_shards)  # ceil
    counts = _shard_counts(ell.post_ind, ell.valid, n_shards, shard_size)
    k_local = max(1, int(counts.max()))           # build-time host read
    g_out, post_out, valid_out, delay_out = _partition_rows(
        ell.g, ell.post_ind, ell.valid, ell.delay, n_shards, shard_size,
        k_local)
    return g_out, post_out, valid_out, delay_out, shard_size, k_local


def construction_peak_model(n_pre: int, k: int, n_devices: int, k_local: int,
                            has_delay: bool = False) -> dict:
    """Analytic peak construction bytes per device for one synapse group:
    generate-then-partition (every device materializes the full [n_pre, k]
    ELL plus sort temporaries plus the full [D, n_pre, k_local] block stack)
    vs. the fused local path (only ceil(n_pre / D) rows resident, plus the
    partitioned blocks, their all_to_all receive buffer, and the final
    block)."""
    slot_b = F.ell_slot_bytes(has_delay)
    # argsort order (i4) + sorted shard ids (i4) + sorted copies of each slot
    # array: the transient working set of `_partition_rows` per source slot
    tmp_b = 8 + slot_b
    rows_local = -(-n_pre // n_devices)
    block_b = n_devices * k_local * slot_b       # [D, ., k_local] per row
    gen = n_pre * (k * (slot_b + tmp_b) + block_b)
    fused = rows_local * (k * (slot_b + tmp_b) + 3 * block_b)
    return {"generate_partition_bytes": int(gen),
            "fused_local_bytes": int(fused)}
