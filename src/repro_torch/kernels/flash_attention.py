"""Wrappers around the hand-written flash-attention kernels, and their
``torch.autograd.Function``.

Two routes replace the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (the forward)
and the recompute backward of ``repro/kernels/flash_xla.py`` (``_bwd``):
bf16 operands go to the tensor cores as bf16 (``csrc/flash_attention_sm90.cu``:
wgmma on bf16 tiles fed by TMA), float32 operands to the tensor cores as
3xTF32 (``csrc/flash_attention.cu``: mma.sync on operands split into two
TF32 parts, fed by cp.async, which holds float32's tolerances).  The
sources' headers say how, and what bounds them on the card.

``flash_attention_fwd`` and ``flash_attention_bwd`` are custom ops
(``torch.ops.repro_torch.flash_attention_fwd`` / ``_bwd``), dispatched by
where the tensors lie: on the CPU the plain versions
``repro_torch.kernels.ref.flash_attention_fwd_ref`` / ``_bwd_ref``; on a
CUDA device the kernels of the dtype's route, on the current stream, or an
error (a failed launch raises; nothing falls back to the other route).
Under ``FakeTensorMode`` (the dry run, ``launch/dryrun.py``), on either
fake device, the op checks the shapes and the ``launch_plan`` as a launch
would (and raises where a launch would) and returns the kernel's outputs
without computing anything; ``FlopCounterMode`` counts the kernels' own
products (``attention_flops``) on every route.
``launch_plan`` computes on the host what each launch needs (route, tiles,
ring stages, shared memory, TMA boxes, grids, scratch).  The kernels read dense
row-major ``[B, H, T, D]`` operands: the wrappers make q, k and v
contiguous (a copy when they are transposed views, as the model's
``[B, T, H, D]`` projections are) and return contiguous outputs.

``FlashAttention.apply`` is the differentiable attention of the port, on
both devices: its forward saves (q, k, v, out, lse) and its backward is
``flash_attention_bwd``.  ``launches`` counts kernel launches: one a
forward call and one a backward call (the backward runs three kernels,
the rowsum pre-pass, dK/dV and dQ, and on the float32 route a fourth that
sums the GQA partials where Hq > Hkv); plain-version calls are not
counted.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._dispatch import (GRID_Y_MAX, INT_MAX, F, I, P,
                                           check_operand, on_cpu, raise_on)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "FlashAttention", "launches", "reset_launches", "launch_plan",
           "visible_pairs", "attention_flops", "FWD_PRODUCTS",
           "BWD_PRODUCTS", "ROUTES", "MAX_HEAD_DIM", "SMEM_MAX"]

launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}

MAX_HEAD_DIM = 256
# the route of each dtype the kernels take, and its device kernels by name
# (as a profile shows them)
ROUTES = {
    torch.bfloat16: {"route": "tensor_cores",
                     "fwd": ("flash_fwd_wgmma_kernel",),
                     "bwd": ("flash_bwd_rowsum_kernel",
                             "flash_bwd_dkdv_wgmma_kernel",
                             "flash_bwd_dq_wgmma_kernel")},
    torch.float32: {"route": "tensor_cores_3xtf32",
                    "fwd": ("flash_tf32_fwd_kernel",),
                    "bwd": ("flash_tf32_bwd_delta_kernel",
                            "flash_tf32_bwd_dkdv_kernel",
                            "flash_tf32_bwd_gqa_sum_kernel",
                            "flash_tf32_bwd_dq_kernel")},
}
SMEM_MAX = 232_448        # dynamic shared memory one CTA may use (H100)
_SMEM_SM = 233_472        # shared memory of one SM
_SMEM_RESERVED = 1_024    # the runtime's share of every resident CTA
_PANEL = 64               # columns of a TMA box: 128 bytes of bf16
_ROW = 128                # bytes of one box row
_FWD_BQ = 128             # queries a forward CTA (two warpgroups of 64)
_BWD_TILE = 64            # keys (dK/dV) or queries (dQ) a backward CTA
# float32, by the tiles' column width kd: (forward queries x keys, dK/dV
# keys x queries, dQ queries x keys) a CTA and step
_F32_TILES = {64: ((64, 64), (64, 32), (64, 32)),
              128: ((64, 32), (64, 32), (64, 32)),
              256: ((32, 32), (32, 32), (32, 32))}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The float32 route (tensor cores, 3xTF32)."""
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = ([P] * 5 + [I] * 7 + [F] + [I] * 4
                                        + [F, I, I, P])
    lib.flash_attention_fwd.restype = I
    lib.flash_attention_bwd.argtypes = ([P] * 11 + [I] * 7 + [F] + [I] * 4
                                        + [F, I, I, I, P])
    lib.flash_attention_bwd.restype = I
    lib.flash_attention_error_string.argtypes = [I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_tc() -> ctypes.CDLL:
    """The bf16 route (tensor cores)."""
    lib = _build.load("flash_attention_sm90")
    lib.flash_attention_sm90_fwd.argtypes = ([P] * 5 + [I] * 6 + [F]
                                             + [I] * 4 + [F] + [I] * 3 + [P])
    lib.flash_attention_sm90_fwd.restype = I
    lib.flash_attention_sm90_bwd.argtypes = ([P] * 10 + [I] * 6 + [F]
                                             + [I] * 4 + [F] + [I] * 5 + [P])
    lib.flash_attention_sm90_bwd.restype = I
    lib.flash_attention_sm90_error_string.argtypes = [I]
    lib.flash_attention_sm90_error_string.restype = ctypes.c_char_p
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _stages(budget: int, fixed: int, stage: int, most: int = 3) -> int:
    """Ring stages (at most ``most``) whose tiles and two mbarriers each
    fit ``budget`` bytes beside ``fixed`` ones (+ 1024 of alignment slack
    and the resident tile's mbarrier)."""
    return min(most, (budget - 1024 - fixed - 8) // (stage + 16))


def _f32_plan(b: int, hq: int, hkv: int, tq: int, tk: int, d: int) -> dict:
    """The float32 route's launches (``csrc/flash_attention.cu``, which
    refuses a shared-memory size other than its layout's).

    Tiles are laid out for ``kd`` = 64, 128 or 256 columns (the smallest
    that holds D), rows ``kd + 4`` floats apart; the streamed tiles (K/V
    in the forward and dQ, Q/dO with lse and delta in dK/dV) land in two
    cp.async stages, the next in flight while this one multiplies.  The
    forward CTA (8 warps) holds 64 queries up to kd = 128, 32 at 256: two
    warps on each 16 rows, each with its own online softmax over half of
    every key tile of ``bk``, merged at the end (at 256 two such pairs on
    each 16 rows, half of O's columns each).  The dK/dV CTA
    (8 warps) holds ``bk`` keys of one query head and takes ``bq`` queries
    a step, the dQ CTA (8 warps) ``bq`` queries and ``bk`` keys a step: 64
    x 32 up to kd = 128, 32 x 32 at 256.  Every grid has its tiles on axis
    x and b·Hq on axis y.  Where Hq > Hkv the dK/dV CTAs write float32
    partials per query head, ``scratch_bytes`` of them ([2, B, Hq, Tk,
    D]), which ``gqa_sum`` adds up per KV head; ``delta_bytes`` is the
    rowsum pre-pass's [B, Hq, Tq]."""
    kd = 64 if d <= 64 else 128 if d <= 128 else 256
    ld = kd + 4
    (fbq, fbk), (kbk, kbq), (qbq, qbk) = _F32_TILES[kd]
    # Q, two stages of K and V
    fwd = {"threads": 256, "bq": fbq, "bk": fbk, "stages": 2,
           "smem": 4 * (fbq * ld + 2 * 2 * fbk * ld),
           "grid": (_cdiv(tq, fbq), b * hq)}
    # K and V, two stages of Q, dO, lse and delta, P^T and dS^T as (hi, lo)
    dkdv = {"threads": 256, "bk": kbk, "bq": kbq, "stages": 2,
            "smem": (4 * (2 * kbk * ld + 2 * 2 * kbq * ld + 2 * 2 * kbq)
                     + 8 * 2 * kbk * (kbq + 4)),
            "grid": (_cdiv(tk, kbk), b * hq)}
    # Q and dO, two stages of K and V, dS as (hi, lo)
    dq = {"threads": 256, "bq": qbq, "bk": qbk, "stages": 2,
          "smem": 4 * (2 * qbq * ld + 2 * 2 * qbk * ld) + 8 * qbq * (qbk + 4),
          "grid": (_cdiv(tq, qbq), b * hq)}
    gqa = hq != hkv
    plan = {"route": ROUTES[torch.float32]["route"], "kd": kd, "fwd": fwd,
            "delta": {"threads": 256, "grid": (_cdiv(b * hq * tq, 8),)},
            "dkdv": dkdv, "dq": dq,
            "gqa_sum": ({"threads": 256,
                         "grid": (_cdiv(b * hkv * tk * d // 4, 256), 2)}
                        if gqa else None),
            "scratch_bytes": 2 * b * hq * tk * d * 4 if gqa else 0,
            "delta_bytes": b * hq * tq * 4}
    if b * hq > GRID_Y_MAX:
        raise ValueError(f"b·Hq = {b * hq} exceeds the float32 kernels' "
                         f"grid axis y ({GRID_Y_MAX})")
    grids = [plan[k]["grid"] for k in ("fwd", "delta", "dkdv", "dq")]
    if gqa:
        grids.append(plan["gqa_sum"]["grid"])
    if max(gr[0] for gr in grids) > INT_MAX:
        raise ValueError(f"shapes {(b, hq, hkv, tq, tk, d)} exceed the "
                         f"float32 kernels' grid axis x ({INT_MAX})")
    for k in ("fwd", "dkdv", "dq"):
        if plan[k]["smem"] > SMEM_MAX:
            raise ValueError(f"the float32 {k} CTA needs {plan[k]['smem']} "
                             f"bytes of shared memory, past {SMEM_MAX}")
    return plan


@functools.lru_cache(maxsize=1024)
def launch_plan(dtype: torch.dtype, b: int, hq: int, hkv: int, tq: int,
                tk: int, d: int) -> dict:
    """What the launches of ``dtype``'s route need at these shapes (one
    dict a shape, cached: the caller reads it and never changes it).

    bf16 (the tensor cores): per kernel its threads, rows per tile, ring
    stages, dynamic shared memory (which ``csrc/flash_attention_sm90.cu``
    checks against its own layout), TMA boxes (columns, rows) and grid.
    D is loaded in ``panels`` boxes of 64 columns, the columns past D
    filled with zeros.  The forward CTA holds 128 queries (two consumer
    warpgroups) and takes K/V tiles of 128 keys up to D = 128, 64 above;
    the backward CTAs hold 64 keys (dK/dV, one 128-column block of them:
    grid axis z; up to D = 64 two consumer warpgroups take alternate
    (head, query tile) items from a 4-stage ring) or 64 queries (dQ, two
    CTAs to an SM at D <= 64).  Every grid has its tiles on axis y, the
    longest causal ones launched first.
    float32 (the tensor cores as 3xTF32): see ``_f32_plan``.

    Raises ValueError where a grid of the route would exceed what a launch
    takes: float32 b·Hq past axis y's 65535 or the tiles past axis x's
    2^31 - 1; bf16 b·Hq or b·Hkv past axis x's 2^31 - 1, or the tiles past
    axis y; or where a CTA's shared memory would exceed ``SMEM_MAX``."""
    route = ROUTES[dtype]["route"]
    if dtype == torch.float32:
        return _f32_plan(b, hq, hkv, tq, tk, d)
    panels = _cdiv(d, _PANEL)
    bk = 128 if panels <= 2 else 64
    q_bytes = panels * _FWD_BQ * _ROW
    kv_stage = 2 * panels * bk * _ROW
    st = _stages(SMEM_MAX, q_bytes, kv_stage)
    fwd = {"threads": 384, "bq": _FWD_BQ, "bk": bk, "stages": st,
           "smem": 1024 + q_bytes + st * kv_stage + 8 * (2 * st + 1),
           "boxes": {"q": (_PANEL, _FWD_BQ), "kv": (_PANEL, bk)},
           "grid": (b * hq, _cdiv(tq, _FWD_BQ)), "ctas_per_sm": 1}
    pair = 2 * panels * _BWD_TILE * _ROW           # K+V, Q+dO: one tile each
    side = 2 * _BWD_TILE * 4                       # lse and delta a stage

    def bwd(threads, ctas, most):
        budget = min(SMEM_MAX, _SMEM_SM // ctas - _SMEM_RESERVED)
        st = _stages(budget, pair, pair + side, most)
        return {"threads": threads, "tile": _BWD_TILE, "stages": st,
                "smem": 1024 + pair + st * (pair + side) + 8 * (2 * st + 1),
                "boxes": {"q": (_PANEL, _BWD_TILE),
                          "kv": (_PANEL, _BWD_TILE)},
                "ctas_per_sm": ctas}

    two_wg = panels == 1
    dkdv = bwd(384, 1, 4) if two_wg else bwd(160, 1, 3)
    plan = {"route": route, "panels": panels, "fwd": fwd,
            "dkdv": {**dkdv, "consumer_warpgroups": 2 if two_wg else 1,
                     "col_panels": min(panels, 2),
                     "grid": (b * hkv, _cdiv(tk, _BWD_TILE),
                              _cdiv(panels, 2))},
            "dq": {**bwd(160, 2 if panels == 1 else 1, 3),
                   "grid": (b * hq, _cdiv(tq, _BWD_TILE))}}
    grids = [plan[k]["grid"] for k in ("fwd", "dkdv", "dq")]
    if max(gr[0] for gr in grids) > INT_MAX:
        raise ValueError(f"b·Hq = {b * hq} exceeds the bf16 kernels' grid "
                         f"axis x ({INT_MAX})")
    if max(gr[1] for gr in grids) > GRID_Y_MAX:
        raise ValueError(f"sequence lengths {(tq, tk)} exceed the bf16 "
                         f"kernels' grid axis y ({GRID_Y_MAX})")
    return plan


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a dense row-major tensor whose data starts on 16 bytes
    (the kernel reads rows 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], prefix: Optional[int], q_offset: int):
    """Raise on what the kernels of q's dtype do not take (the grids by
    ``launch_plan``); return ((b, hq, hkv, tq, tk, d), the plan)."""
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
    if q.dtype not in ROUTES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if max(tq, tk) > INT_MAX:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} exceed "
                         "the kernel's sizes")
    for name, t in (("window", window), ("prefix", prefix)):
        if t is not None and not 0 <= t <= INT_MAX:
            raise ValueError(f"{name} must be a non-negative int, got {t}")
    if abs(q_offset) > INT_MAX // 2:
        raise ValueError(f"q_offset {q_offset} does not fit the kernel")
    shape = (b, hq, hkv, tq, tk, d)
    return shape, launch_plan(q.dtype, *shape)


def _masks(causal, window, scale, d, softcap, prefix):
    """The kernels' trailing scalar arguments."""
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    return (float(s), int(bool(causal)),
            -1 if window is None else int(window),
            -1 if prefix is None else int(prefix), int(softcap is not None),
            0.0 if softcap is None else float(softcap))


def visible_pairs(tq: int, tk: int, window: Optional[int] = None,
                  causal: bool = True) -> int:
    """The (query, key) pairs of a Tq x Tk rectangle that the kernels
    count as computed, by ``benchmarks/roofline.py::_visibility``'s share:
    Tq (Tq + 1) / 2 under a causal mask with Tq == Tk, the whole rectangle
    otherwise, and at most Tq min(window, Tk) under a window (exact for
    the causal and the full rectangle; JAX's min(window, Tk) / Tk share
    for a window).  A prefix-LM span counts as causal, as there."""
    pairs = tq * (tq + 1) // 2 if causal and tq == tk else tq * tk
    if window is not None:
        pairs = min(pairs, tq * min(window, tk))
    return pairs


# products of the [Tq, Tk] rectangle a call runs: the forward S = Q K^T
# and O = P V; the backward's dK/dV kernel S^T, dP^T, dV and dK, and its
# dQ kernel S, dP and dQ (csrc/flash_attention*.cu, both routes)
FWD_PRODUCTS, BWD_PRODUCTS = 2, 7


def attention_flops(q_shape, k_shape, causal: bool, window: Optional[int],
                    products: int) -> int:
    """Floating-point operations of ``products`` [Tq, Tk] x D products at
    these shapes: 2 B Hq D a visible pair each (``visible_pairs``)."""
    b, hq, tq, d = q_shape
    return products * 2 * b * hq * d * visible_pairs(tq, k_shape[2], window,
                                                     causal)


def _opts(causal, window, scale, q_offset, softcap, prefix) -> tuple:
    """The options as the ops' schema types them."""
    return (bool(causal), None if window is None else int(window),
            None if scale is None else float(scale), int(q_offset),
            None if softcap is None else float(softcap),
            None if prefix is None else int(prefix))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0,
                        softcap: Optional[float] = None,
                        prefix: Optional[int] = None):
    """(out, lse): ``flash_attention``'s output and each row's log-sum-exp
    ``[B, Hq, Tq]`` in float32 (``-inf`` where a row sees no key).  The
    op ``torch.ops.repro_torch.flash_attention_fwd``: the plain version on
    CPU tensors, the kernel on CUDA ones, and under ``FakeTensorMode`` the
    kernel's output shapes after its ``launch_plan``."""
    return torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, *_opts(causal, window, scale, q_offset, softcap, prefix))


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cpu")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], scale: Optional[float], q_offset: int,
            softcap: Optional[float], prefix: Optional[int]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _ref.flash_attention_fwd_ref(
        q, k, v, causal=causal, window=window, scale=scale,
        q_offset=q_offset, softcap=softcap, prefix=prefix)


@_fwd_op.register_kernel("cuda")
def _fwd_cuda(q, k, v, causal, window, scale, q_offset, softcap, prefix):
    on_cpu("flash_attention", q, k, v)        # raises unless one device
    shape, plan = _check(q, k, v, window, prefix, q_offset)
    b, hq, hkv, tq, tk, d = shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, q.dtype)
    out = torch.empty_like(q)
    # the kernel writes every row's lse
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    opts = (*_masks(causal, window, scale, d, softcap, prefix), int(q_offset))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if q.dtype == torch.bfloat16:
            fwd = plan["fwd"]
            lib = _lib_tc()
            rc = lib.flash_attention_sm90_fwd(*args, *shape, *opts,
                                              fwd["stages"], fwd["smem"],
                                              stream)
            err = lib.flash_attention_sm90_error_string
        else:
            rc = _lib().flash_attention_fwd(*args, 0, *shape, *opts,
                                            plan["fwd"]["smem"], stream)
            err = _lib().flash_attention_error_string
    launches["flash_attention"] += 1
    raise_on(rc, err, "flash_attention")
    return out, lse


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, window, scale, q_offset, softcap, prefix):
    (b, hq, _, tq, _, _), _ = _check(q, k, v, window, prefix, q_offset)
    return (q.new_empty(q.shape),
            q.new_empty((b, hq, tq), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, window, *_, **__) -> int:
    return attention_flops(q_shape, k_shape, causal, window, FWD_PRODUCTS)


def _check_bwd(q, k, v, o, lse, dout, window, prefix, q_offset):
    """``_check``, and that (o, dout, lse) fit q."""
    shape, plan = _check(q, k, v, window, prefix, q_offset)
    b, hq, _, tq, _, _ = shape
    if tuple(o.shape) != tuple(q.shape) \
            or tuple(dout.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (b, hq, tq):
        raise ValueError(f"out {tuple(o.shape)}, dout "
                         f"{tuple(dout.shape)} and lse {tuple(lse.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    return shape, plan


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0,
                        softcap: Optional[float] = None,
                        prefix: Optional[int] = None):
    """(dq, dk, dv) in the inputs' dtypes from the forward's saved (q, k,
    v, out, lse) and the output's gradient ``dout``; float32 sums.  The op
    ``torch.ops.repro_torch.flash_attention_bwd``, dispatched as
    ``flash_attention_fwd``'s."""
    return torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, lse, dout,
        *_opts(causal, window, scale, q_offset, softcap, prefix))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cpu")
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
            causal: bool, window: Optional[int], scale: Optional[float],
            q_offset: int, softcap: Optional[float], prefix: Optional[int]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _ref.flash_attention_bwd_ref(
        q, k, v, o, lse, dout, causal=causal, window=window, scale=scale,
        q_offset=q_offset, softcap=softcap, prefix=prefix)


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(q, k, v, o, lse, dout, causal, window, scale, q_offset,
              softcap, prefix):
    on_cpu("flash_attention_bwd", q, k, v, o, lse, dout)
    shape, plan = _check_bwd(q, k, v, o, lse, dout, window, prefix,
                             q_offset)
    b, hq, hkv, tq, tk, d = shape
    q, k, v, o = (_aligned(t) for t in (q, k, v, o))
    dout = _aligned(dout.to(q.dtype))
    lse = _aligned(lse)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", o),
                    ("dout", dout)):
        check_operand(name, t, q.dtype)
    check_operand("lse", lse, torch.float32)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    args = tuple(t.data_ptr() for t in (q, k, v, o, dout, lse, delta, dq,
                                        dk, dv))
    opts = (*_masks(causal, window, scale, d, softcap, prefix), int(q_offset))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if q.dtype == torch.bfloat16:
            lib = _lib_tc()
            rc = lib.flash_attention_sm90_bwd(
                *args, *shape, *opts, plan["dkdv"]["stages"],
                plan["dkdv"]["smem"], plan["dq"]["stages"],
                plan["dq"]["smem"], stream)
            err = lib.flash_attention_sm90_error_string
        else:
            # the query heads' dK/dV partials where Hq > Hkv
            part = (torch.empty(plan["scratch_bytes"] // 4,
                                dtype=torch.float32, device=q.device)
                    if plan["scratch_bytes"] else None)
            rc = _lib().flash_attention_bwd(
                *args, None if part is None else part.data_ptr(), 0, *shape,
                *opts, plan["dkdv"]["smem"], plan["dq"]["smem"], stream)
            err = _lib().flash_attention_error_string
    launches["flash_attention_bwd"] += 1
    raise_on(rc, err, "flash_attention_bwd")
    return dq, dk, dv


@_bwd_op.register_fake
def _bwd_fake(q, k, v, o, lse, dout, causal, window, scale, q_offset,
              softcap, prefix):
    _check_bwd(q, k, v, o, lse, dout, window, prefix, q_offset)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, dout_shape,
               causal, window, *_, **__) -> int:
    return attention_flops(q_shape, k_shape, causal, window, BWD_PRODUCTS)


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
    softcap)``.  A query that sees no key gives 0.  No autograd:
    ``FlashAttention.apply`` is the differentiable form."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale, q_offset=q_offset,
                               softcap=softcap, prefix=prefix)[0]


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: the forward kernel (saving its lse), and
    the backward kernels; on the CPU their plain versions.  ``apply(q, k,
    v, causal, window, scale, q_offset, softcap, prefix)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, scale=None,
                q_offset=0, softcap=None, prefix=None):
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        q_offset=q_offset, softcap=softcap, prefix=prefix)
        out, lse = flash_attention_fwd(q, k, v, **ctx.opts)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.opts)
        return (dq, dk, dv) + (None,) * 6
