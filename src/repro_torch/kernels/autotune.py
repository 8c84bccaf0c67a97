"""Occupancy-based block-size determination (paper §3), in its CUDA form.

Counterpart of ``repro/kernels/autotune.py``, which adapts the paper's model
to a TPU's VMEM tiles.  Here it is the paper's own: a kernel's *occupancy*
is the warps an SM keeps resident, limited by four bottlenecks (threads, CTAs
an SM, registers, shared memory), and a launch takes the smallest block that
still hides memory latency.

- :class:`H100Limits` holds the occupancy calculator's values for compute
  capability 9.0; ``device_limits()`` reads the card's own, and
  ``chip_smoke.py``'s phase 10 holds every value to them.
- :func:`occupancy` is the calculator: resident CTAs an SM at (threads,
  registers a thread, shared memory a CTA), and the limiter.
- :func:`kernel_attributes` reads a built kernel's registers and shared
  memory from ``cudaFuncGetAttributes`` (each ``csrc`` library exports
  ``<library>_kernel_info``); :func:`runtime_occupancy` asks
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for the same kernel.
  Off the card both raise.
- :func:`choose_block_elementwise` and :func:`choose_block_spmv` score each
  block a kernel is compiled for by occupancy times wave efficiency and
  take the best, the smallest among ties; :func:`choose_propagation` is the
  JAX package's dense-vs-event crossover with the card's feasibility.

Every spmv and propagation decision records a trace instant
(``repro_torch.obs.trace``) under the JAX package's names.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.obs import trace as _trace

__all__ = [
    "H100Limits", "H100", "H100Rates", "H100_RATES", "KERNELS", "ELEMENTWISE_BLOCKS", "SPMV_ROWS",
    "TIE_RTOL", "occupancy", "kernel_names", "kernel_attributes",
    "runtime_occupancy", "device_limits", "spmv_smem_bytes", "spmv_regs",
    "choose_block_elementwise", "choose_block_spmv", "choose_propagation",
    "occupancy_report",
]


@dataclasses.dataclass(frozen=True)
class H100Limits:
    """An SM's and a CTA's resources on an H100 (compute capability 9.0),
    as the CUDA occupancy calculator models them."""

    sms: int = 132
    warp_size: int = 32
    max_threads_per_sm: int = 2048
    max_warps_per_sm: int = 64
    max_ctas_per_sm: int = 32
    max_threads_per_cta: int = 1024
    regs_per_sm: int = 65536
    regs_per_cta: int = 65536
    max_regs_per_thread: int = 255
    reg_alloc_unit: int = 256          # registers go to a warp in these
    reg_sub_partitions: int = 4        # a warp's registers lie in one quarter
    smem_per_sm: int = 228 * 1024
    smem_per_cta: int = 227 * 1024     # opted in past the default 48 KB
    smem_reserved_per_cta: int = 1024  # the system's, on every CTA
    smem_alloc_unit: int = 128


H100 = H100Limits()


@dataclasses.dataclass(frozen=True)
class H100Rates:
    """The H100 SXM's data-sheet rates (NVIDIA H100 Tensor Core GPU data
    sheet; dense rates, without sparsity, at the full 700 W): what a
    bound or a roofline term divides by.  The link rates cannot be
    measured on one card."""

    bf16_flops: float = 989e12     # bf16 / fp16 on the tensor cores
    tf32_flops: float = 495e12     # TF32 on the tensor cores
    fp32_flops: float = 67e12      # float32 on the CUDA cores
    hbm_bytes_per_s: float = 3.35e12   # HBM3
    hbm_bytes: float = 80e9        # HBM3 capacity, 80 GB
    # NVLink 4: 900 GB/s a card in both directions (18 links of 50 GB/s),
    # 450 GB/s a direction, among a node's 8 cards (NVSwitch)
    nvlink_bytes_per_s: float = 450e9
    # between nodes: one 400 Gb/s NDR InfiniBand port a card (the DGX
    # H100's eight ConnectX-7 ports, one a card), 50 GB/s a direction
    internode_bytes_per_s: float = 50e9


H100_RATES = H100Rates()

# blocks an elementwise kernel is compiled for (kinfo::with_block in
# csrc/kernel_info.cuh) and rows a scatter CTA may cover (with_rows in
# csrc/ell_spmv.cu)
ELEMENTWISE_BLOCKS = (128, 256, 512, 1024)
SPMV_ROWS = (128, 256, 512)
# scores within this share of the best count as tied, and the smallest
# block of the tie wins: under one wave, occupancy times wave efficiency is
# the launch's threads over the card's and moves only by the rounding of
# a CTA between candidates, which is no reason to take a larger block
TIE_RTOL = 0.02

SPMV_MEMBERS = 8         # batch members a scatter CTA reads (kMembers)
SPMV_ITEMS = 4           # items a thread loads before its atomics
INT_MAX = 2 ** 31 - 1
GRID_Y_MAX = 65535
INDEX_MAX = 2 ** 63 - 1


@dataclasses.dataclass(frozen=True)
class KernelInfo:
    """Where a kernel's attributes come from: its library and the blocks
    it is compiled for.  Its number in ``<library>_kernel_info`` is the
    library's own, found by name (:func:`kernel_names`)."""

    library: str
    blocks: Tuple[int, ...]


def _family(library, names, blocks):
    return {n: KernelInfo(library, blocks) for n in names}


# kernel -> KernelInfo, under the names each library's KINFO_NAMES gives
KERNELS: Dict[str, KernelInfo] = {
    **_family("ell_spmv", [f"ell_spmv{d}_live<{s},{v}>"
                           for d in ("", "_delay")
                           for s in ("float", "bool") for v in (4, 1)],
              SPMV_ROWS),
    **_family("ell_spmv", ["delay_ring_fold<4>", "delay_ring_fold<1>"],
              ELEMENTWISE_BLOCKS),
    **_family("neuron_step", ["izhikevich_step", "hh_step",
                              "izhikevich_step.drive"],
              ELEMENTWISE_BLOCKS),
    **_family("threefry", ["threefry_split", "threefry_draw",
                           "threefry_fold_in"],
              ELEMENTWISE_BLOCKS),
    **_family("spike_bitmask", ["spike_bitmask"], ELEMENTWISE_BLOCKS),
    # designed tiles: the blocks the wgmma / mma shapes fix
    **_family("flash_attention", [f"flash_tf32_fwd<{d}>"
                                  for d in (64, 128, 256)]
              + ["flash_tf32_bwd_delta",
                                  "flash_tf32_bwd_gqa_sum"]
              + [f"flash_tf32_bwd_{k}<{d}>" for k in ("dkdv", "dq")
                 for d in (64, 128, 256)], (256,)),
    **_family("flash_attention_sm90", ["flash_bwd_rowsum"], (256,)),
    **_family("flash_attention_sm90", [f"flash_fwd_wgmma<{p}>"
                                       for p in (1, 2, 3, 4)]
              + ["flash_bwd_dkdv_wgmma<1>"], (384,)),
    **_family("flash_attention_sm90", [f"flash_bwd_dkdv_wgmma<{p}>"
                                       for p in (2, 3, 4)]
              + [f"flash_bwd_dq_wgmma<{p}>" for p in (1, 2, 3, 4)], (160,)),
    **_family("ssd_scan", ["ssd_scan_cb"], (256,)),
    # the scan at its most heads a CTA, 128 threads a head: 3 with the
    # 128-column state, 4 with the 64-column one (ds <= 64)
    **_family("ssd_scan", ["ssd_scan"], (384,)),
    **_family("ssd_scan", ["ssd_scan_ds64"], (512,)),
    **_family("device_limits", ["register_ceiling_probe"], (32,)),
}


def _round_up(x: int, unit: int) -> int:
    return -(-x // unit) * unit


def occupancy(threads: int, regs_per_thread: int, smem_per_cta: int,
              lim: H100Limits = H100) -> dict:
    """The paper's four-bottleneck calculation for one CTA shape.

    Returns ``ctas`` (resident CTAs an SM), ``warps`` (resident warps),
    ``occupancy`` (warps over ``max_warps_per_sm``), ``limiter`` (the
    bottleneck that sets ``ctas``: "threads", "CTAs", "registers" or
    "shared memory", the first in that order on a tie) and ``by`` (the CTAs
    each bottleneck allows).  Registers go to warps in units of
    ``reg_alloc_unit``, from one of ``reg_sub_partitions`` quarters of the
    register file; shared memory to CTAs in units of ``smem_alloc_unit``,
    each with ``smem_reserved_per_cta`` more.  0 registers leaves that
    bottleneck out.  A CTA that cannot launch gives ``ctas`` 0."""
    warps = -(-threads // lim.warp_size)
    if threads <= 0 or threads > lim.max_threads_per_cta:
        by_threads = 0
    else:
        by_threads = lim.max_warps_per_sm // warps
    by_ctas = lim.max_ctas_per_sm
    if regs_per_thread > lim.max_regs_per_thread:
        by_regs = 0
    elif regs_per_thread <= 0 or warps == 0:
        by_regs = by_ctas
    else:
        per_warp = _round_up(regs_per_thread * lim.warp_size,
                             lim.reg_alloc_unit)
        # a launch is checked as if its warps filled every quarter
        assumed = per_warp * _round_up(warps, lim.reg_sub_partitions)
        if max(per_warp * warps, assumed) > lim.regs_per_cta:
            by_regs = 0
        else:
            per_part = ((lim.regs_per_sm // lim.reg_sub_partitions)
                        // per_warp)
            by_regs = per_part * lim.reg_sub_partitions // warps
    alloc = _round_up(smem_per_cta + lim.smem_reserved_per_cta,
                      lim.smem_alloc_unit)
    if alloc > lim.smem_per_cta + lim.smem_reserved_per_cta:
        by_smem = 0
    elif alloc == 0:
        by_smem = by_ctas
    else:
        by_smem = lim.smem_per_sm // alloc
    by = {"threads": by_threads, "CTAs": by_ctas, "registers": by_regs,
          "shared memory": by_smem}
    limiter = min(by, key=by.get)       # the first of the smallest
    ctas = by[limiter]
    return {"ctas": ctas, "warps": ctas * warps,
            "occupancy": ctas * warps / lim.max_warps_per_sm,
            "limiter": limiter, "by": by}


# -- what the runtime says ----------------------------------------------------

_INFO_LEN = 7
_LIMIT_KEYS = ("sms", "max_threads_per_sm", "max_ctas_per_sm",
               "max_threads_per_cta", "regs_per_sm", "regs_per_cta",
               "smem_per_sm", "smem_per_cta", "smem_reserved_per_cta",
               "warp_size", "max_regs_per_thread")


def _require_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} reads a built kernel on a CUDA device, "
                           "and none is available")


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_kernel_info")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    fn = getattr(lib, f"{name}_kernel_name")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def kernel_names(library: str) -> Tuple[str, ...]:
    """The names of ``library``'s kernels in the numbering of its
    ``<library>_kernel_info`` (``KINFO_NAMES`` in its source), from the
    built library.  Raises off the card."""
    _require_card("kernel_names")
    name_of = getattr(_library(library), f"{library}_kernel_name")
    names = []
    while (n := name_of(len(names))) is not None:
        names.append(n.decode())
    return tuple(names)


def _default_dyn_smem(kernel: str) -> int:
    """The dynamic shared memory a kernel's own launch takes at its
    designed tile: the bf16 flash kernels' from their launch plan at D = 64
    panels; -1 lets the library use its launch's own (the float32 flash
    kernels' at their tiles' width, and the SSD kernels'); 0 for the
    rest."""
    if kernel.startswith(("flash_fwd_wgmma", "flash_bwd_dkdv_wgmma",
                          "flash_bwd_dq_wgmma")):
        from repro_torch.kernels import flash_attention as FA
        panels = int(kernel.rsplit("<", 1)[1].rstrip(">"))
        plan = FA.launch_plan(torch.bfloat16, 1, 1, 1, 128, 128, 64 * panels)
        part = {"flash_fwd_wgmma": "fwd", "flash_bwd_dkdv_wgmma": "dkdv",
                "flash_bwd_dq_wgmma": "dq"}[kernel.split("<")[0]]
        return int(plan[part]["smem"])
    if kernel.startswith(("flash_tf32_fwd<", "flash_tf32_bwd_dkdv<",
                          "flash_tf32_bwd_dq<", "ssd_scan")):
        return -1
    return 0


@functools.lru_cache(maxsize=None)
def _info(kernel: str, block: int, query_block: int,
          dyn_smem: int) -> Tuple[int, ...]:
    _require_card("kernel_attributes")
    spec = KERNELS[kernel]
    if block not in spec.blocks:
        raise ValueError(f"{kernel} is compiled for blocks {spec.blocks}, "
                         f"not {block}")
    names = kernel_names(spec.library)
    if kernel not in names:
        raise RuntimeError(f"{spec.library} exports no kernel {kernel!r}; "
                           f"its kernels are {names}")
    out = (ctypes.c_int * _INFO_LEN)()
    rc = getattr(_library(spec.library), f"{spec.library}_kernel_info")(
        names.index(kernel), block, query_block, dyn_smem, out)
    if rc != 0:
        msg = getattr(lib, f"{spec.library}_error_string")(rc).decode()
        raise RuntimeError(f"{spec.library}_kernel_info({kernel}, block "
                           f"{block}) failed: {msg} (cuda error {rc})")
    return tuple(out)


def kernel_attributes(name: str, block: Optional[int] = None) -> dict:
    """``numRegs``, ``sharedSizeBytes`` (static), ``maxThreadsPerBlock``,
    ``maxDynamicSharedSizeBytes`` and ``localSizeBytes`` of kernel ``name``
    compiled for ``block`` (default: its first), from
    ``cudaFuncGetAttributes`` on the current device, and
    ``launchDynamicSharedBytes``, the dynamic shared memory its own launch
    takes at its designed tile.  Builds the library
    if it is not built; raises without a card, for an unknown block, or
    when the query fails."""
    spec = KERNELS[name]
    block = spec.blocks[0] if block is None else block
    info = _info(name, block, 0, _default_dyn_smem(name))
    keys = ("numRegs", "sharedSizeBytes", "maxThreadsPerBlock",
            "maxDynamicSharedSizeBytes", "localSizeBytes")
    out = dict(zip(keys, info[:5]))
    out["launchDynamicSharedBytes"] = info[6]
    return out


def runtime_occupancy(name: str, block: Optional[int] = None,
                      query_block: Optional[int] = None,
                      dyn_smem: Optional[int] = None) -> int:
    """``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for kernel
    ``name`` compiled for ``block`` (default: its first), asked at
    ``query_block`` threads (default: ``block``) with ``dyn_smem`` bytes
    of dynamic shared memory (default: its own launch's)."""
    spec = KERNELS[name]
    block = spec.blocks[0] if block is None else block
    dyn = _default_dyn_smem(name) if dyn_smem is None else dyn_smem
    return _info(name, block, query_block or 0, dyn)[5]


@functools.lru_cache(maxsize=None)
def device_limits() -> Dict[str, int]:
    """The current card's values of :class:`H100Limits`' fields that the
    runtime reports (``csrc/device_limits.cu``), ``max_regs_per_thread``
    from the register-ceiling probe's registers.  Raises off the card."""
    _require_card("device_limits")
    lib = _library("device_limits")
    n = lib.device_limits_len()
    out = (ctypes.c_int * n)()
    lib.device_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    rc = lib.device_limits(out)
    if rc != 0:
        raise RuntimeError(f"device_limits failed: "
                           f"{lib.device_limits_error_string(rc).decode()}")
    vals = dict(zip(_LIMIT_KEYS, out))
    vals["max_warps_per_sm"] = vals["max_threads_per_sm"] // vals["warp_size"]
    return vals


# -- choosing a block ---------------------------------------------------------

def _attrs_of(kernel: str, block: int,
              attrs: Optional[Mapping[int, Mapping[str, int]]]
              ) -> Tuple[int, int]:
    """(registers a thread, static shared memory) of ``kernel`` at
    ``block``: from ``attrs`` when given (a block missing from it leaves
    its registers out), else from the card when there is one, else
    neither (the plan of the shape alone, as the CPU's plain versions
    need none)."""
    if attrs is not None:
        a = attrs.get(block, {})
    elif torch.cuda.is_available():
        a = kernel_attributes(kernel, block)
    else:
        a = {}
    return int(a.get("numRegs", 0)), int(a.get("sharedSizeBytes", 0))


def _score(ctas: int, occ: dict, lim: H100Limits,
           fill: float = 1.0) -> Tuple[float, int, float]:
    """occupancy x wave efficiency (CTAs launched over the slots of the
    waves they take) x ``fill``, the share of the launched threads that
    have work (below 1 only where a launch is smaller than its last CTA
    or a few CTAs: there a larger block would count its idle threads as
    resident).  Returns (score, waves, wave efficiency)."""
    slots = lim.sms * occ["ctas"]
    waves = -(-ctas // slots)
    eff = ctas / (waves * slots)
    return occ["occupancy"] * eff * fill, waves, eff


def _pick(cands: Sequence[dict]) -> dict:
    """The smallest block whose score is within TIE_RTOL of the best."""
    best = max(c["score"] for c in cands)
    return min((c for c in cands if c["score"] >= best * (1.0 - TIE_RTOL)),
               key=lambda c: c["block"])


def choose_block_elementwise(
    n: int, kernel: str, batch: int = 1, lim: H100Limits = H100,
    attrs: Optional[Mapping[int, Mapping[str, int]]] = None,
    grid_x_max: Optional[int] = None, tag: str = "",
) -> dict:
    """The block for ``kernel`` over ``n`` threads' work a batch row (a
    thread an element; grid x = ceil(n / block), at most ``grid_x_max``
    for a kernel with a grid-stride loop, else at most 2^31 - 1) and
    ``batch`` rows on grid y.

    Candidates are the blocks the kernel is compiled for; each scores its
    occupancy (registers and shared memory from ``attrs``, a mapping block
    -> attributes as ``kernel_attributes`` returns them, or when None from
    the card, or without a card from the shape alone) times its wave
    efficiency (times the share of its threads
    that have work), and the smallest block within
    ``TIE_RTOL`` of the best wins (the paper: the smallest block that still
    hides latency).  Returns ``block``, ``grid``, ``occupancy``,
    ``resident_ctas``, ``limiter``, ``waves``, ``wave_efficiency``,
    ``score`` and ``regs``; raises when no candidate can launch."""
    if n < 0 or batch < 0:
        raise ValueError(f"n={n}, batch={batch} must be non-negative")
    if batch > GRID_Y_MAX:
        raise ValueError(f"batch {batch} past grid axis y's {GRID_Y_MAX}")
    cands = []
    for block in KERNELS[kernel].blocks:
        regs, smem = _attrs_of(kernel, block, attrs)
        occ = occupancy(block, regs, smem, lim)
        gx = max(1, -(-n // block))
        if grid_x_max is not None:
            gx = min(gx, grid_x_max)
        if occ["ctas"] == 0 or gx > INT_MAX:
            continue
        fill = min(1.0, max(n, 1) / (gx * block))
        score, waves, eff = _score(gx * max(batch, 1), occ, lim, fill)
        cands.append({"block": block, "grid": (gx, batch, 1),
                      "occupancy": occ["occupancy"],
                      "resident_ctas": occ["ctas"],
                      "limiter": occ["limiter"], "waves": waves,
                      "wave_efficiency": eff, "score": score, "regs": regs,
                      "smem_bytes": smem})
    if not cands:
        raise ValueError(f"{kernel}: no compiled block can launch {n} x "
                         f"{batch} (grid axis x past {INT_MAX}, or no CTA "
                         "fits an SM)")
    cfg = _pick(cands)
    _trace.instant("choose_block_elementwise", tag=tag, kernel=kernel, n=n,
                   batch=batch, **cfg)
    return cfg


def spmv_smem_bytes(rows: int) -> int:
    """A scatter CTA's static shared memory (``LiveSmem<rows>`` in
    ``csrc/ell_spmv.cu``): spike values [8][rows] float32, the live-row
    list [rows] uint16, live rows per warp [rows / 32] int32."""
    return 4 * SPMV_MEMBERS * rows + 2 * rows + 4 * (rows // 32)


def spmv_k_max(rows: int) -> int:
    """The widest row a CTA of ``rows`` rows takes: it counts its items
    (live rows x slots) in 32 bits."""
    return (INT_MAX - rows * SPMV_ITEMS) // rows


def spmv_regs(delay: bool = False) -> Dict[int, Dict[str, int]]:
    """rows -> the attributes the model reads for the scatter kernel
    (``delay``: the delay variant): the most registers any of its four
    instantiations (float or bool spikes, 4 or 1 slots an item) takes at
    those rows, and their static shared memory.  From the card; empty
    (registers left out) when there is none."""
    kind = "ell_spmv_delay_live" if delay else "ell_spmv_live"
    out = {}
    if not torch.cuda.is_available():
        return out
    for rows in SPMV_ROWS:
        attrs = [kernel_attributes(f"{kind}<{s},{v}>", rows)
                 for s in ("float", "bool") for v in (4, 1)]
        out[rows] = {"numRegs": max(a["numRegs"] for a in attrs),
                     "sharedSizeBytes": max(a["sharedSizeBytes"]
                                            for a in attrs)}
    return out


def _spmv_reason(rows: int, n_pre: int, k: int, n_post: int, b: int,
                 n_slots: Optional[int], lim: H100Limits) -> Optional[str]:
    """Why a scatter of ``rows`` rows a CTA cannot launch, or None."""
    sizes = [("batch", b), ("n_pre", n_pre), ("K", k), ("n_post", n_post)]
    if n_slots is not None:
        sizes.append(("n_slots", n_slots))
    for what, v in sizes:
        if not 0 <= v <= INT_MAX:
            return f"{what}={v} outside the kernel's int32 range"
    gy = -(-b // SPMV_MEMBERS)
    if gy > GRID_Y_MAX:
        return (f"batch {b} needs {gy} CTAs on grid axis y, past its "
                f"{GRID_Y_MAX}")
    gx = -(-n_pre // rows)
    if gx > INT_MAX:
        return (f"n_pre {n_pre} needs {gx} CTAs on grid axis x, past its "
                f"{INT_MAX}")
    if k > spmv_k_max(rows):
        return f"K={k} past the kernel's {spmv_k_max(rows)} slots a row"
    if n_slots is not None and b * n_slots * n_post > INDEX_MAX:
        return (f"[{b}, {n_slots}, {n_post}] past the kernel's 64-bit "
                "index")
    if spmv_smem_bytes(rows) > lim.smem_per_cta:
        return (f"{spmv_smem_bytes(rows)} B of shared memory past "
                f"{lim.smem_per_cta}")
    return None


@functools.lru_cache(maxsize=4096)
def _spmv_plan(n_pre: int, k: int, n_post: int, b: int,
               n_slots: Optional[int], regs: Tuple[Tuple[int, int], ...],
               lim: H100Limits) -> dict:
    regs_at = dict(regs)
    cands, reasons = [], []
    for rows in SPMV_ROWS:
        reason = _spmv_reason(rows, n_pre, k, n_post, b, n_slots, lim)
        occ = occupancy(rows, regs_at.get(rows, 0), spmv_smem_bytes(rows),
                        lim)
        if reason is None and occ["ctas"] == 0:
            reason = f"no CTA of {rows} rows fits an SM"
        if reason is not None:
            reasons.append(reason)
            continue
        grid = (max(1, -(-n_pre // rows)), max(1, -(-b // SPMV_MEMBERS)), 1)
        fill = min(1.0, max(n_pre, 1) / (grid[0] * rows))
        score, waves, eff = _score(grid[0] * grid[1], occ, lim, fill)
        cands.append({"rows": rows, "block": rows,
                      "smem_bytes": spmv_smem_bytes(rows), "grid": grid,
                      "occupancy": occ["occupancy"],
                      "resident_ctas": occ["ctas"],
                      "limiter": occ["limiter"], "waves": waves,
                      "wave_efficiency": eff, "score": score,
                      "regs": regs_at.get(rows, 0), "feasible": True})
    if cands:
        return _pick(cands)
    rows = SPMV_ROWS[0]
    return {"rows": rows, "block": rows, "smem_bytes": spmv_smem_bytes(rows),
            "grid": (-(-n_pre // rows), -(-b // SPMV_MEMBERS), 1),
            "occupancy": 0.0, "resident_ctas": 0, "limiter": None,
            "waves": 0, "wave_efficiency": 0.0, "score": 0.0,
            "regs": regs_at.get(rows, 0), "feasible": False,
            "reason": reasons[0]}


def choose_block_spmv(
    n_pre: int, k: int, n_post: int, b: int, n_slots: Optional[int] = None,
    tag: str = "", attrs: Optional[Mapping[int, Mapping[str, int]]] = None,
    lim: H100Limits = H100,
) -> dict:
    """The rows a CTA of the live-row ELL scatter walks (``csrc/
    ell_spmv.cu``; with ``n_slots``, its delay variant) for spikes [b,
    n_pre], K = ``k`` slots a row and ``n_post`` targets.

    Candidates are the rows the source is compiled for (``SPMV_ROWS``, a
    thread a row); each CTA holds ``spmv_smem_bytes(rows)`` of shared
    memory and takes 8 batch members (grid y).  Registers come from
    ``attrs`` (rows -> attributes, as ``spmv_regs`` returns them; a row
    count missing from it leaves registers out) or, when None, from
    ``spmv_regs``: the card's, or none without a card.  Scored and picked as
    :func:`choose_block_elementwise`.  Returns ``rows``, ``block``,
    ``smem_bytes``, ``grid``, ``occupancy``, ``limiter`` and ``feasible``
    (false exactly where ``kernels.ell_spmv.launch_plan`` raises, with the
    ``reason``), and records a ``choose_block_spmv`` trace instant."""
    if attrs is None:
        attrs = spmv_regs(n_slots is not None)
    regs = tuple(sorted((r, int(a.get("numRegs", 0)))
                        for r, a in attrs.items()))
    cfg = dict(_spmv_plan(n_pre, k, n_post, b, n_slots, regs, lim))
    _trace.instant("choose_block_spmv", tag=tag, n_pre=n_pre, k=k,
                   n_post=n_post, b=b, n_slots=n_slots, **cfg)
    return cfg


def choose_propagation(
    n_pre: int, k: int, n_post: int, b: int = 1, activity: float = 0.1,
    capacity: Optional[int] = None, n_slots: int = 1, dtype_bytes: int = 4,
    lim: H100Limits = H100, tag: str = "",
    attrs: Optional[Mapping[int, Mapping[str, int]]] = None,
) -> Dict[str, object]:
    """The JAX package's dense-vs-event crossover for one synapse group.

    "event" when (a) the modelled event slot traffic (capacity rows of K
    slots plus an n_pre compaction sweep) is at most half the dense
    traffic (n_pre x K), (b) the matrix holds at least 32768 slots, and
    (c) the compacted problem is feasible on the card
    (``choose_block_spmv(capacity, ...)``).  The capacity is the activity
    with 2.5x headroom, rounded up to a quantum of 8 rows and clamped to
    [8, n_pre]: the quantum is the TPU's sublane, kept so that the two
    packages report the same plan.  ``n_slots`` > 1 models the delay
    scatter of a ring of that many slots; ``dtype_bytes`` is kept for the
    JAX signature (the card's plan does not depend on it).  Records a
    ``choose_propagation`` trace instant."""
    del dtype_bytes
    q = 8
    if capacity is None:
        cap = math.ceil(n_pre * activity * 2.5 / q) * q
        cap = int(min(n_pre, max(q, cap)))
    else:
        cap = int(min(n_pre, max(1, capacity)))
    slots = None if n_slots == 1 else n_slots
    dense_slots = n_pre * k
    event_slots = cap * k + n_pre
    dense_cfg = choose_block_spmv(n_pre, k, n_post, b, slots,
                                  tag=f"{tag}:dense", attrs=attrs, lim=lim)
    event_cfg = choose_block_spmv(cap, k, n_post, b, slots,
                                  tag=f"{tag}:event", attrs=attrs, lim=lim)
    worthwhile = (dense_slots >= 32768
                  and 2 * event_slots <= dense_slots
                  and event_cfg["feasible"])
    cfg = {"mode": "event" if worthwhile else "dense", "capacity": cap,
           "activity": activity, "dense_slots": dense_slots,
           "event_slots": event_slots,
           "dense_occupancy": dense_cfg["occupancy"],
           "event_occupancy": event_cfg["occupancy"]}
    _trace.instant("choose_propagation", tag=tag, n_pre=n_pre, k=k,
                   n_post=n_post, b=b, n_slots=n_slots, **cfg)
    return cfg


# the main path's shapes (phase 3: the Izhikevich net at 100k neurons,
# in-degree 1000, B = 1; the mushroom body's 100k KCs; phase 5's 21 ring
# slots; phase 9b's bitmask)
REPORT_SHAPES = (
    ("ell_spmv exc->exc", "spmv", (80_000, 800, 80_000, 1, None)),
    ("ell_spmv inh->exc", "spmv", (20_000, 200, 80_000, 1, None)),
    ("ell_spmv_delay exc->exc", "spmv", (80_000, 800, 80_000, 1, 21)),
    ("izhikevich_step exc", "izhikevich_step", (80_000, 1)),
    ("izhikevich_step.drive exc", "izhikevich_step.drive", (80_000, 1)),
    ("hh_step KC", "hh_step", (100_000, 1)),
    ("threefry_split", "threefry_split", (5, 1)),
    ("threefry_draw exc", "threefry_draw", (80_000, 1)),
    ("spike_bitmask exc", "spike_bitmask", (2500 * 32, 1)),
    ("delay_ring_fold [1, 21, 80000]", "delay_ring_fold<4>", (20_000, 21)),
)


def occupancy_report(lim: H100Limits = H100,
                     attrs: Optional[Mapping[str, Mapping[int, Mapping[
                         str, int]]]] = None) -> str:
    """The paper-style block-size table for the port's kernels at the main
    path's shapes: workload, block, grid, resident CTAs, occupancy and
    limiter; then each designed-tile kernel (flash, SSD) at its block.
    ``attrs``: kernel -> block -> attributes (an ``ell_spmv`` entry for the
    scatters); None reads the card."""
    lines = ["workload,block,grid,resident_ctas,occupancy,limiter"]
    for label, kernel, shape in REPORT_SHAPES:
        if kernel == "spmv":
            n_pre, k, n_post, b, n_slots = shape
            cfg = choose_block_spmv(
                n_pre, k, n_post, b, n_slots, tag="report",
                attrs=None if attrs is None else attrs.get("ell_spmv", {}),
                lim=lim)
        else:
            n, batch = shape
            cfg = choose_block_elementwise(
                n, kernel, batch, lim,
                attrs=None if attrs is None else attrs.get(kernel, {}),
                tag="report")
        lines.append(f"{label},{cfg['block']},{cfg['grid']},"
                     f"{cfg['resident_ctas']},{cfg['occupancy']:.3f},"
                     f"{cfg['limiter']}")
    for name, spec in KERNELS.items():
        if spec.library not in ("flash_attention", "flash_attention_sm90",
                                "ssd_scan"):
            continue
        block = spec.blocks[0]
        if attrs is None:
            a = kernel_attributes(name, block)
            smem = a["sharedSizeBytes"] + a["launchDynamicSharedBytes"]
            regs = a["numRegs"]
        else:
            a = attrs.get(name, {}).get(block, {})
            regs, smem = a.get("numRegs", 0), a.get("sharedSizeBytes", 0)
        occ = occupancy(block, regs, smem, lim)
        lines.append(f"{name},{block},designed,{occ['ctas']},"
                     f"{occ['occupancy']:.3f},{occ['limiter']}")
    return "\n".join(lines)
