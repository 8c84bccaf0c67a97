#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one card.  The kernels
build from ``src/repro_torch/kernels/csrc`` at first use.  Phases (any
failure ends the run with a non-zero exit):

  1. the card (name, power limit) and the kernel build (seconds and
     registers per source);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of its path, with times of the kernel and the plain version
     beside the bound:
     - the ELL kernels at 80000 rows x 1000 slots -> 80000 posts (80% of
       slots valid; B = 1 and 8; 1% and 100% of rows spiking; 21 delay
       slots): rtol=atol=1e-5, exact with integer-valued weights; beside
       them torch.sparse.mm on the same matrix as CSR (a yardstick only:
       the port never calls it);
     - izhikevich_step at [1, 80000] and [8, 80000] with per-neuron a..d,
       hh_step at [1, 100000] and [5, 100000] (dt 0.1, 5 substeps), inputs
       that straddle the threshold: rtol=atol=2e-4, spike decisions differ
       on < 0.2% of neurons; their ms is device time from torch.profiler
       (a launch of a few microseconds is shorter than the host's gap
       between launches), beside the CUDA-event wall time; no single
       PyTorch call computes either, so they have no library time;
  2c. flash_attention against its plain version on the card, with kernel,
     plain and library (torch's scaled_dot_product_attention on the same
     inputs, a yardstick only: the port never calls it) times beside the
     bound; bf16 runs on the tensor-core kernels, float32 on the CUDA-core
     ones: the serving prefill's shape, q [8, 14, 2048, 64] and k, v
     [8, 2, 2048, 64], bf16, causal (rtol=atol=1e-2 against the plain
     version in float32 on the same bf16 inputs); the same at B=1 in
     float32 (2e-5); gemma3's local layer, [1, 16, 2048, 256] /
     [1, 8, 2048, 256], window 1024, bf16; softcap 30, and prefix 100, at
     [1, 4, 256, 64] / [1, 2, 256, 64], in float32 and in bf16; non-causal
     ragged T=200 in both; in bf16 also q_offset 100, zamba2's D=112
     ([1, 32, 2048, 112]), D=40 (a contraction padded with zeros) and the
     prefill shape without the causal mask;
  3. the main path at full width: the Izhikevich net, 100k neurons, 1000
     synapses per neuron (4 split ELL groups, ~1.8 GB), 1000 steps; its
     launch counts (4 ell_spmv and 2 izhikevich_step per step); 50 steps
     through the plain versions on the card (no kernel launched), whose
     raster must agree with the kernel run's on >= 99.8% of neuron-steps;
  4. a gScale sweep of the excitatory groups: 8 candidates (0.3 .. 1.2,
     below saturation) x 500 steps as one batch, rates non-decreasing in
     gScale, then the conductance search;
  5. a delay path (10k neurons, 500 synapses each, per-synapse delays
     0..20 steps on the excitatory groups) through ``ell_spmv_delay``;
  6a. the paper's NaN-guard table on the mushroom body at the example's
     size (24 PN / 6 LHI / 150 KC / 12 DN, dt 0.1 ms): PN_KC gScale
     0.5 .. 50 as one batch of 5 x 2500 steps; finite at 0.5 and 1, not
     finite at 50, PN within 15 Hz of 50;
  6b. the mushroom body at full width (100 PN / 20 LHI / 100k KC / 100 DN)
     with every group's gScale scaled by fan-in from the example's, 2500
     steps (3 hh_step launches per step, finite); 200 steps through the
     plain versions, rasters agreeing on >= 99.8% of neuron-steps; then
     the conductance search for the PN_KC gScale that gives 6a's KC rate
     at gScale 1, 12 candidates as one batch;
  7. LM serving at full width: ``Server("qwen2-0.5b", use_reduced=False,
     max_batch=8, max_seq=4096)`` (494.1M bf16 weights from a seeded
     generator, a 402.7 MB bf16 KV cache) serves 16 greedy requests, prompt
     lengths 1024..2048 from numpy's default_rng(0), 32 new tokens each, in
     two waves of 8: every request gets 32 tokens below the vocab size,
     every logit row is finite, flash_attention launches 24 x 2 = 48 times;
     a float32 copy of the weights prefills 2 prompts of 512 tokens through
     the kernel and through the plain versions, whose last-token logits
     agree within rtol=atol=1e-3 with equal argmax.  It prints prefill
     tokens/s and time to first token per wave, decode ms/step and
     tokens/s, peak device memory, and from torch.profiler the kernel's
     share of one prefill wave's device time and the card's busy share
     over 20 decode steps;
  2d. ssd_scan against its plain version (``ssd_chunked``) on the card,
     torch's TF32 off: Mamba2-2.7B's training shape, x [2, 2048, 80, 64]
     and B/C [2, 2048, 1, 128] float32, and t = 96, t = 1000, 4 and 3
     heads, within rtol=atol=2e-4; kernel and plain times beside two
     bounds, float32 on the CUDA cores and the tensor cores' (3 x the
     operations at TF32's rate: the kernel splits every operand into two
     tf32 halves), with the time before the redesign and its prediction
     (no single PyTorch call computes the scan); the count of tensor-core
     (HMMA) instructions in the built kernel; and the time of
     ``SSDScan``'s backward (autograd of ``ssd_chunked``) at the training
     shape;
  2e. the flash-attention backward against its plain version
     (``flash_attention_bwd_ref``, on the same saved tensors) and against
     autograd through ``flash_attention_ref``: Qwen2-0.5B's training
     shape, q [4, 14, 2048, 64], k/v [4, 2, 2048, 64], bf16, causal; the
     same at B=1 in float32; gemma3's local layer; the other cases of 2c
     (tolerances at FLASH_BWD_TOL); beside the
     bound, the plain backward's time and SDPA's backward
     (``torch.autograd.grad`` through ``scaled_dot_product_attention``, a
     yardstick only) with the kernels it ran;
  8a. training Qwen2-0.5B at full width and depth (24 layers, bf16
     params, float32 master copies and moments, remat): batch 4 x 2048
     from ``TokenPipeline(seed=0)``, 4 steps (the first a warm-up); each
     step 48 ``flash_attention`` and 24 ``flash_attention_bwd`` launches
     and a finite loss (the first step's printed beside 12.07, its value
     on the CUDA-core flash kernels);
     ms/step, tokens/s, model TFLOP/s (6N), peak memory, and a
     torch.profiler trace of one more step, whose flash kernels must show
     by name;
  8b. the same for Mamba2-2.7B (64 layers): batch 2 x 2048, 3 steps, 128
     ``ssd_scan`` launches a step; beside ms/step, the calls of
     ``SSDScan``'s backward a step times its time from 2d;
  8c. one training step of each, 2 layers at full width in float32, with
     the kernels and with the plain versions: losses within 1e-4, every
     gradient within rtol=1e-3 plus 1e-4 of its largest entry, and
     ``wq``/``wk``/``wv`` gradients nonzero on the card.

Before the last line it prints the card's ``nvidia-smi`` name and power
limit and a ``{"kernels": [...]}`` JSON line; the last line is
``{"ok": true, "device": {...}}``.  The full results also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS = 67e12               # H100 SXM, float32 outside tensor cores
BF16_FLOPS = 989e12              # H100 SXM, bf16 dense on the tensor cores
TF32_FLOPS = 495e12              # H100 SXM, TF32 dense on the tensor cores
TOL = 1e-5
NEURON_TOL = 2e-4
SPIKE_DISAGREEMENT = 0.002
RASTER_AGREEMENT = 0.998

N_PRE, N_CONN, N_POST, N_SLOTS = 80_000, 1000, 80_000, 21
MAIN = dict(n_total=100_000, n_conn=1000, steps=1000, plain_steps=50)
# the grid a conductance search scans, below the saturated regime: above
# gScale ~1.25 this net bursts at ~100 Hz and the rate is no longer monotone
SWEEP = dict(values=(0.3, 0.45, 0.6, 0.75, 0.9, 1.0, 1.1, 1.2), steps=500)
DELAY = dict(n_total=10_000, n_conn=500, max_delay=20, steps=200)
IZH_SHAPES = ((1, 80_000), (8, 80_000))      # exc; B of phases 3 and 4
HH_SHAPES = ((1, 100_000), (5, 100_000))     # KC; B of phases 6b and 6a
# float operations per (member, neuron), counting expf and a division as
# one each (so the operation bound is a lower bound): the statements of
# csrc/neuron_step.cu
IZH_OPS = 28
HH_OPS_PER_SUBSTEP = 88
MB_EXAMPLE = dict(n_pn=24, n_lhi=6, n_kc=150, n_dn=12)
MB_FULL = dict(n_pn=100, n_lhi=20, n_kc=100_000, n_dn=100)
MB_TABLE = dict(values=(0.5, 1.0, 2.0, 8.0, 50.0), steps=2500)
MB_RUN = dict(steps=2500, plain_steps=200, search_steps=2500,
              # PN_KC candidates around its fan-in gScale (0.24)
              search=tuple(0.24 * 2.0 ** (i / 4 - 1) for i in range(12)))
# name, (B, Hq, Hkv, T, D), dtype, options, tolerance against the plain
# version (in float32, on the same inputs)
# (bf16 runs on the tensor cores, float32 on the CUDA cores)
FLASH_CASES = (
    ("prefill", (8, 14, 2, 2048, 64), "bfloat16", {"causal": True}, 1e-2),
    ("prefill_b1_f32", (1, 14, 2, 2048, 64), "float32", {"causal": True},
     2e-5),
    ("gemma3_local", (1, 16, 8, 2048, 256), "bfloat16",
     {"causal": True, "window": 1024}, 1e-2),
    ("softcap", (1, 4, 2, 256, 64), "float32",
     {"causal": True, "softcap": 30.0}, 2e-5),
    ("prefix", (1, 4, 2, 256, 64), "float32",
     {"causal": True, "prefix": 100}, 2e-5),
    ("noncausal_ragged", (2, 4, 4, 200, 64), "float32", {"causal": False},
     2e-5),
    ("softcap_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "softcap": 30.0}, 1e-2),
    ("prefix_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "prefix": 100}, 1e-2),
    ("noncausal_ragged_bf16", (2, 4, 4, 200, 64), "bfloat16",
     {"causal": False}, 1e-2),
    ("q_offset_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "q_offset": 100}, 1e-2),
    ("zamba2_d112", (1, 32, 32, 2048, 112), "bfloat16", {"causal": True},
     1e-2),
    ("d40_bf16", (1, 4, 2, 256, 40), "bfloat16", {"causal": True}, 1e-2),
    # the prefill shape without the causal mask: what the masks cost the
    # tensor-core kernel per visible pair
    ("prefill_noncausal", (8, 14, 2, 2048, 64), "bfloat16",
     {"causal": False}, 1e-2),
)
SERVE = dict(arch="qwen2-0.5b", max_batch=8, max_seq=4096, requests=16,
             prompt_len=(1024, 2048), max_new=32, check_prompts=2,
             check_len=512, tol=1e-3, decode_profile_steps=20)

# name, (b, t, h, dh, ds): the training shape of mamba2-2.7b (batch 2 x
# 2048 tokens, 80 heads of 64, state 128), t = 96 (one chunk of 96 in the
# plain version) and t = 1000 (chunks of 8 by the halving rule), and head
# counts that no head block of the TPU kernel divides evenly
SSD_CASES = (
    ("train", (2, 2048, 80, 64, 128)),
    ("t96", (2, 96, 80, 64, 128)),
    ("t1000", (1, 1000, 80, 64, 128)),
    ("h4", (2, 512, 4, 64, 128)),
    ("h3_small", (1, 300, 3, 16, 16)),
)
SSD_TOL = 2e-4
SSD_Q = 32                       # the kernel's chunk (csrc/ssd_scan.cu)
# the training shape's time on the CUDA-core kernel that the tensor-core
# one replaced (PERF.md) and what the redesign predicted, in ms; both
# printed beside this run's time
SSD_BEFORE_MS = 1.363
SSD_PREDICTED_MS = (0.25, 0.5)
# name, (B, Hq, Hkv, T, D), dtype, options: the training shape of
# qwen2-0.5b (batch 4 x 2048), the same at B=1 in float32, gemma3's local
# layer, and small float32 softcap, prefix and non-causal cases
FLASH_BWD_CASES = (
    ("train", (4, 14, 2, 2048, 64), "bfloat16", {"causal": True}),
    ("train_b1_f32", (1, 14, 2, 2048, 64), "float32", {"causal": True}),
    ("gemma3_local", (1, 16, 8, 2048, 256), "bfloat16",
     {"causal": True, "window": 1024}),
    ("softcap", (1, 4, 2, 256, 64), "float32",
     {"causal": True, "softcap": 30.0}),
    ("prefix", (1, 4, 2, 256, 64), "float32", {"causal": True, "prefix": 100}),
    ("noncausal_ragged", (2, 4, 4, 200, 64), "float32", {"causal": False}),
    ("softcap_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "softcap": 30.0}),
    ("prefix_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "prefix": 100}),
    ("noncausal_ragged_bf16", (2, 4, 4, 200, 64), "bfloat16",
     {"causal": False}),
    ("q_offset_bf16", (1, 4, 2, 256, 64), "bfloat16",
     {"causal": True, "q_offset": 100}),
    ("zamba2_d112", (1, 32, 32, 2048, 112), "bfloat16", {"causal": True}),
    ("d40_bf16", (1, 4, 2, 256, 40), "bfloat16", {"causal": True}),
    ("train_noncausal", (4, 14, 2, 2048, 64), "bfloat16", {"causal": False}),
)
# float32: tests/test_kernels.py's gradient tolerance.  bf16: against the
# plain backward on the same saved bf16 tensors, 1e-2 of each gradient's
# largest entry (each gradient is rounded to bf16 once, 2^-8 relative, and
# the float32 sums run in another order); against autograd through the
# plain float32 forward, 3e-2 (that forward keeps its output in float32,
# while the kernel's delta = rowsum(dO * O) reads the bf16-rounded output,
# as training does)
FLASH_BWD_TOL = {"float32": (5e-4, 5e-5), "bfloat16": (1e-2, 3e-2)}
# full width and depth; the trainer's schedule (launch/train.py run()):
# warmup_cosine(lr, warmup=min(20, steps // 5 + 1), total=steps)
TRAIN = {
    "qwen2-0.5b": dict(batch=4, seq=2048, steps=4, lr=3e-3,
                       per_step={"flash_attention": 48,
                                 "flash_attention_bwd": 24},
                       # the first step's loss on the CUDA-core flash
                       # kernels (same seed and data; PERF.md)
                       first_loss_cuda_cores=12.07),
    "mamba2-2.7b": dict(batch=2, seq=2048, steps=3, lr=3e-3,
                        per_step={"ssd_scan": 128}),
}
# 8c: one step at full width, 2 layers, float32, kernels vs plain versions:
# losses within 1e-4; each gradient within rtol=1e-3 plus 1e-4 of its
# largest entry (float32 on both sides; the kernels sum in another order)
STEP_CHECK = dict(layers=2, batch=2, seq=512, loss_tol=1e-4, grad_rtol=1e-3,
                  grad_atol_frac=1e-4)

class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"== {name}: FAILED", flush=True)
        raise
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {}
    kernels = card_and_build(torch, report)
    kernel_entries = compare_kernels(torch, report)
    kernel_entries += compare_neuron_kernels(torch, report)
    kernel_entries += compare_flash(torch, report)
    kernel_entries += compare_ssd(torch, report)
    kernel_entries += compare_flash_bwd(torch, report)
    launches_main, model = main_path(torch, report)
    sweep(torch, report, model)
    del model
    torch.cuda.empty_cache()
    launches_delay = delay_path(torch, report)
    kc_target = gscale_table(torch, report)
    launches_mb = mushroom_body_full(torch, report, kc_target)
    torch.cuda.empty_cache()
    launches_serve = serve_full(torch, report)
    torch.cuda.empty_cache()
    launches_qwen = train_full(torch, report, "qwen2-0.5b", "8a")
    launches_mamba = train_full(torch, report, "mamba2-2.7b", "8b")
    train_step_check(torch, report)
    # each kernel's launches come from the run of its own path
    path_of = {"ell_spmv": launches_main, "ell_spmv_delay": launches_delay,
               "izhikevich_step": launches_main, "hh_step": launches_mb,
               "flash_attention": launches_serve,
               "flash_attention_bwd": launches_qwen,
               "ssd_scan": launches_mamba}
    for e in kernel_entries:
        e["launches"] = path_of[e["name"]][e["name"]]
        check(e["launches"] > 0, f"{e['name']} never launched on its path")
    report["kernels"] = kernel_entries
    report["build"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(report["nvidia_smi"])
    print(json.dumps({"kernels": kernel_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
def card_and_build(torch, report) -> dict:
    from repro_torch.kernels import _build
    with phase("1. card and kernel build"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        report["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
        print(report["nvidia_smi"])
        t0 = time.perf_counter()
        built = _build.build()
        secs = time.perf_counter() - t0
        print(f"kernels built in {secs:.2f} s: {sorted(built)}")
        for name, b in built.items():
            regs = [ln.strip() for ln in b["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"  {name}.cu: {b['seconds']:.2f} s; " + " | ".join(regs))
        report["build_seconds"] = secs
        return {n: {"seconds": b["seconds"], "cached": b["cached"]}
                for n, b in built.items()}


def _time_ms(torch, fn, reps: int) -> float:
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i + 1)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(torch, fn, reps: int) -> float:
    """Device time per call: the summed duration of every device op that
    ``reps`` calls of ``fn`` run, from a torch.profiler trace.  Unlike
    ``_time_ms`` it leaves out the gaps between launches, which set the
    wall time of a kernel of a few microseconds."""
    fn(0)
    torch.cuda.synchronize()

    def calls():
        for i in range(reps):
            fn(i + 1)
        torch.cuda.synchronize()

    return _device_profile(torch, calls)["device_busy_us"] / reps / 1e3


def _csr(torch, post_ind, valid, g, rows_of, n_rows):
    """The ELL as a CSR matrix [n_rows, n_pre] (row = target coordinate)."""
    n_pre, k = post_ind.shape
    pre = torch.arange(n_pre, device=g.device)[:, None].expand(n_pre, k)
    sel = valid.reshape(-1)
    idx = torch.stack([rows_of.reshape(-1)[sel], pre.reshape(-1)[sel]])
    coo = torch.sparse_coo_tensor(idx, g.reshape(-1)[sel], (n_rows, n_pre))
    return coo.coalesce().to_sparse_csr()


def compare_kernels(torch, report) -> list:
    from repro_torch.kernels import ell_spmv as K
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    rows = []
    with phase("2. kernels against their plain versions"):
        gen = torch.Generator(device=dev).manual_seed(0)
        g = 0.5 * torch.rand(N_PRE, N_CONN, device=dev, generator=gen)
        idx = torch.randint(0, N_POST, (N_PRE, N_CONN), device=dev,
                            generator=gen, dtype=torch.int32)
        valid = torch.rand(N_PRE, N_CONN, device=dev, generator=gen) < 0.8
        dly = torch.randint(0, N_SLOTS, (N_PRE, N_CONN), device=dev,
                            generator=gen, dtype=torch.int32)
        g_int = torch.floor(8.0 * g)
        csr = _csr(torch, idx, valid, g, idx.long(), N_POST)
        csr_d = _csr(torch, idx, valid, g,
                     dly.long() * N_POST + idx.long(), N_SLOTS * N_POST)
        valid_per_row = valid.sum(dim=1)
        for b in (1, 8):
            for p in (0.01, 1.0):
                spikes = [(torch.rand(b, N_PRE, device=dev, generator=gen)
                           < p).float() for _ in range(8)]
                spk = spikes[0]
                live = spk.amax(dim=0) > 0
                n_live = int(live.sum())
                valid_live = int(valid_per_row[live].sum())
                syn_events = int((spk * valid_per_row).sum())
                for name in ("ell_spmv", "ell_spmv_delay"):
                    delay = name == "ell_spmv_delay"
                    slots = N_SLOTS if delay else 1
                    if delay:
                        kern = lambda s, gg=g: K.ell_spmv_delay(
                            gg, idx, valid, dly, s, N_POST, N_SLOTS)
                        plain = lambda s, gg=g: R.ell_spmv_delay_ref(
                            gg, idx, valid, dly, s, N_POST, N_SLOTS)
                        lib = lambda s: torch.sparse.mm(csr_d, s.t())
                    else:
                        kern = lambda s, gg=g: K.ell_spmv(
                            gg, idx, valid, s, N_POST)
                        plain = lambda s, gg=g: R.ell_spmv_ref(
                            gg, idx, valid, s, N_POST)
                        lib = lambda s: torch.sparse.mm(csr, s.t())
                    out, ref = kern(spk), plain(spk)
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    check(bool(torch.allclose(out, ref, rtol=TOL, atol=TOL)),
                          f"{name} B={b} p={p}: max abs err {err}")
                    check(bool(torch.equal(kern(spk, g_int),
                                           plain(spk, g_int))),
                          f"{name} B={b} p={p}: integer weights not exact")
                    lib_out = lib(spk).t().reshape(out.shape)
                    check(bool(torch.allclose(lib_out, ref, rtol=1e-4,
                                              atol=1e-4)),
                          f"{name}: the library yardstick computes another "
                          "function")
                    reps = 20 if p < 0.5 else 5
                    ms = _time_ms(torch, lambda i: kern(spikes[i % 8]), reps)
                    plain_ms = _time_ms(torch, lambda i: plain(spikes[i % 8]),
                                        reps)
                    lib_ms = _time_ms(torch, lambda i: lib(spikes[i % 8]),
                                      reps)
                    nbytes = (n_live * N_CONN                       # valid
                              + valid_live * (8 + (4 if delay else 0))
                              + b * N_PRE * 4                  # spikes
                              + b * slots * N_POST * 4)        # output
                    flops = 2.0 * syn_events
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = flops / FP32_FLOPS * 1e3
                    row = {"name": name, "B": b, "spiking": p,
                           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms,
                           "bound_ms": max(t_bytes, t_ops),
                           "bound_by": ("bytes" if t_bytes >= t_ops
                                        else "operations"),
                           "bytes": nbytes, "flops": flops}
                    rows.append(row)
                    print(json.dumps(row))
        del g, idx, valid, dly, g_int, csr, csr_d
        torch.cuda.empty_cache()
    report["kernel_table"] = rows
    entries = []
    for name, replaces in (("ell_spmv", "src/repro/kernels/ell_spmv.py:127"),
                           ("ell_spmv_delay",
                            "src/repro/kernels/ell_spmv.py:190")):
        # the main path's own regime: one simulation, ~1% of rows spiking
        r = next(x for x in rows if x["name"] == name and x["B"] == 1
                 and x["spiking"] < 0.5)
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ell_spmv.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return entries


def _bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _neuron_times(torch, kern, plain) -> dict:
    """ms / plain_ms: device time per call (the kernel, or all the plain
    version's ops); *_wall_ms: CUDA events around back-to-back calls, which
    the host's enqueue rate sets for kernels this short."""
    return {"ms": _device_ms(torch, kern, 50),
            "plain_ms": _device_ms(torch, plain, 20),
            "wall_ms": _time_ms(torch, kern, 50),
            "plain_wall_ms": _time_ms(torch, plain, 20)}


def compare_neuron_kernels(torch, report) -> list:
    from repro_torch.kernels import hh_step as HH
    from repro_torch.kernels import izhikevich_step as IZ
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    rows = []
    with phase("2b. neuron kernels against their plain versions"):
        gen = torch.Generator(device=dev).manual_seed(1)

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, device=dev,
                                               generator=gen)

        def normal(shape, scale):
            return scale * torch.randn(shape, device=dev, generator=gen)

        for b, n in IZH_SHAPES:
            r = torch.rand(n, device=dev, generator=gen)
            params = (0.02 + 0.08 * r, 0.25 - 0.05 * r, -65.0 + 15.0 * r * r,
                      8.0 - 6.0 * r * r)
            ins = [(uniform((b, n), -80, 25), uniform((b, n), -20, 5),
                    normal((b, n), 5.0)) for _ in range(4)]
            dt = 1.0                                   # the main path's dt
            kern = lambda i: IZ.izhikevich_step(*ins[i % 4], *params, dt)
            plain = lambda i: R.izhikevich_step_ref(*ins[i % 4], *params, dt)
            out, ref = kern(0), plain(0)
            torch.cuda.synchronize()
            agree = out[2] == ref[2]
            disagree = float((~agree).float().mean())
            spiking = float(ref[2].float().mean())
            err = max(float((o - e)[agree].abs().max())
                      for o, e in zip(out[:2], ref[:2]))
            check(0.01 < spiking < 0.99,
                  f"izhikevich_step inputs spike {spiking}: they do not "
                  "straddle the threshold")
            check(disagree < SPIKE_DISAGREEMENT,
                  f"izhikevich_step [{b}, {n}]: spike decisions differ on "
                  f"{disagree} of neurons")
            check(all(bool(torch.allclose(o[agree], e[agree], rtol=NEURON_TOL,
                                          atol=NEURON_TOL))
                      for o, e in zip(out[:2], ref[:2])),
                  f"izhikevich_step [{b}, {n}]: max abs err {err}")
            rows.append({"name": "izhikevich_step", "B": b, "n": n,
                         "max_abs_err": err, "spike_disagreement": disagree,
                         "spiking": spiking, **_neuron_times(torch, kern,
                                                             plain),
                         "library_ms": None,
                         **_bound(b * n * (12 + 9) + n * 16, b * n * IZH_OPS),
                         "bytes": b * n * (12 + 9) + n * 16,
                         "ops": b * n * IZH_OPS})
            print(json.dumps(rows[-1]))
        for b, n in HH_SHAPES:
            ins = [(uniform((b, n), -80, 30), uniform((b, n), 0, 1),
                    uniform((b, n), 0, 1), uniform((b, n), 0, 1),
                    normal((b, n), 2.0)) for _ in range(4)]
            kern = lambda i: HH.hh_step(*ins[i % 4], 0.1, 5)
            plain = lambda i: R.hh_step_ref(*ins[i % 4], 0.1, 5)
            out, ref = kern(0), plain(0)
            torch.cuda.synchronize()
            err = max(float((o - e).abs().max()) for o, e in zip(out, ref))
            check(all(bool(torch.allclose(o, e, rtol=NEURON_TOL,
                                          atol=NEURON_TOL))
                      for o, e in zip(out, ref)),
                  f"hh_step [{b}, {n}]: max abs err {err}")
            ops = b * n * 5 * HH_OPS_PER_SUBSTEP
            rows.append({"name": "hh_step", "B": b, "n": n,
                         "max_abs_err": err,
                         **_neuron_times(torch, kern, plain),
                         "library_ms": None, **_bound(b * n * 36, ops),
                         "bytes": b * n * 36, "ops": ops})
            print(json.dumps(rows[-1]))
    report["neuron_kernel_table"] = rows
    entries = []
    for name, replaces in (
            ("izhikevich_step", "src/repro/kernels/izhikevich_step.py:50"),
            ("hh_step", "src/repro/kernels/hh_step.py:71")):
        r = next(x for x in rows if x["name"] == name and x["B"] == 1)
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/neuron_step.cu",
            "replaces": replaces, "launches": 0,
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}})
    return entries


def _visible_pairs(torch, tq, tk, causal, window=None, prefix=None,
                   q_offset=0, **_):
    """The number of (query, key) pairs the masks leave visible in one
    (batch, head), and the mask [tq, tk]."""
    qpos = q_offset + torch.arange(tq, device="cuda")[:, None]
    kpos = torch.arange(tk, device="cuda")[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device="cuda")
    if causal:
        cm = kpos <= qpos
        if prefix is not None:
            cm = cm | ((kpos < prefix) & (qpos < prefix))
        mask &= cm
    if window is not None:
        mask &= kpos > qpos - window
    return int(mask.sum()), mask


def compare_flash(torch, report) -> list:
    import torch.nn.functional as TF
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    rows = []
    with phase("2c. flash_attention against its plain version"):
        gen = torch.Generator(device=dev).manual_seed(2)
        for name, (b, hq, hkv, t, d), dt, kw, tol in FLASH_CASES:
            dtype = getattr(torch, dt)
            q, k, v = (torch.randn(shape, device=dev, generator=gen
                                   ).to(dtype)
                       for shape in ((b, hq, t, d), (b, hkv, t, d),
                                     (b, hkv, t, d)))
            out = FA.flash_attention(q, k, v, **kw)
            ref = R.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            check(bool(torch.allclose(out.float(), ref, rtol=tol, atol=tol)),
                  f"flash_attention {name}: max abs err {err} > {tol}")
            pairs, mask = _visible_pairs(torch, t, t, **kw)
            lib = None
            if "softcap" not in kw:       # no PyTorch call soft-caps
                lib_kw = ({"is_causal": kw["causal"]} if set(kw) == {"causal"}
                          else {"attn_mask": mask})

                def lib(i, q=q, k=k, v=v, lib_kw=lib_kw):
                    return TF.scaled_dot_product_attention(
                        q, k, v, enable_gqa=True, **lib_kw)

                lib_err = float((lib(0).float() - ref).abs().max())
                check(lib_err < (2e-2 if dt == "bfloat16" else 1e-3),
                      f"flash_attention {name}: the library yardstick "
                      f"computes another function (max abs err {lib_err})")
            reps = 10 if b * hq * t * t * d > 1e9 else 50
            ms = _time_ms(torch, lambda i: FA.flash_attention(q, k, v, **kw),
                          reps)
            plain_ms = _time_ms(torch, lambda i: R.flash_attention_ref(
                q, k, v, **kw), max(3, reps // 5))
            lib_ms = None if lib is None else _time_ms(torch, lib, reps)
            es = q.element_size()
            nbytes = es * (2 * b * hq * t * d + 2 * b * hkv * t * d)
            flops = 4.0 * b * hq * d * pairs
            peak = BF16_FLOPS if dt == "bfloat16" else FP32_FLOPS
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            row = {"name": "flash_attention", "case": name,
                   "shape": [b, hq, hkv, t, d], "dtype": dt,
                   "options": kw, "tol": tol, "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "flops": flops,
                   "tflops": flops / ms / 1e9}
            rows.append(row)
            print(json.dumps(row))
            del q, k, v, out, ref, mask
            torch.cuda.empty_cache()
    report["flash_table"] = rows
    r = rows[0]                       # the serving prefill's own shape
    return [{"name": "flash_attention", "route": "cuda",
             # the bf16 route (tensor cores), which the path runs
             "source":
                 "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "replaces": "src/repro/kernels/flash_attention.py:112",
             "launches": 0,
             **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}]


def _ssd_work(b, t, h, dh, ds) -> tuple:
    """(bytes, float ops) of the SSD scan at the kernel's chunk: x, B, C
    and dt read once, y written once (float32); C B^T once a chunk (the
    heads share it), the lower triangles of it and of G x, and C S and the
    state update per head."""
    tri = sum(n * (n + 1) // 2 for n in
              (min(SSD_Q, t - c) for c in range(0, t, SSD_Q)))
    nbytes = 4 * (2 * b * t * h * dh + 2 * b * t * ds + b * t * h + 2 * h)
    ops = 2 * b * tri * ds + 2 * b * h * (tri * dh + 2 * t * ds * dh)
    return nbytes, ops


def _tc_bound(nbytes: float, ops: float, passes: int = 3) -> dict:
    """The tensor cores' bound: ``passes`` x the operations at TF32's rate
    (3xTF32 runs three products for each), or the bytes."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = passes * ops / TF32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _sass_count(lib_path: str, opcode: str) -> int:
    """Lines of ``opcode`` in the SASS of a built library (cuobjdump from
    the toolkit that built it)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    return sum(1 for ln in out.stdout.splitlines() if opcode in ln)


def compare_ssd(torch, report) -> list:
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.ssm import ssd_chunked
    dev = torch.device("cuda")
    rows = []
    with phase("2d. ssd_scan against its plain version (ssd_chunked)"):
        print(f"torch.backends.cuda.matmul.allow_tf32 = "
              f"{torch.backends.cuda.matmul.allow_tf32}")
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
        hmma = _sass_count(str(_build.library_path("ssd_scan")), "HMMA")
        print(f"ssd_scan.cu: {hmma} HMMA (tensor-core mma) instructions in "
              "its SASS")
        check(hmma > 0, "the ssd_scan kernel has no tensor-core instruction")
        report["ssd_hmma_instructions"] = hmma
        gen = torch.Generator(device=dev).manual_seed(3)
        for name, (b, t, h, dh, ds) in SSD_CASES:
            def rand(*shape):
                return torch.rand(shape, device=dev, generator=gen)

            def randn(*shape):
                return torch.randn(shape, device=dev, generator=gen)

            x, dt = randn(b, t, h, dh), 0.001 + 0.1 * rand(b, t, h)
            A = -torch.exp(2.0 * rand(h))
            B, C, D = randn(b, t, 1, ds), randn(b, t, 1, ds), randn(h)
            y = SSD.ssd_scan(x, dt, A, B, C, D)
            ref = ssd_chunked(x, dt, A, B, C, D)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            check(bool(torch.allclose(y, ref, rtol=SSD_TOL, atol=SSD_TOL)),
                  f"ssd_scan {name}: max abs err {err} > {SSD_TOL}")
            big = b * t * h > 1e5
            ms = _time_ms(torch, lambda i: SSD.ssd_scan(x, dt, A, B, C, D),
                          20 if big else 50)
            plain_ms = _time_ms(torch, lambda i: ssd_chunked(
                x, dt, A, B, C, D), 3 if big else 10)
            nbytes, ops = _ssd_work(b, t, h, dh, ds)
            f32 = _bound(nbytes, ops)
            row = {"name": "ssd_scan", "case": name,
                   "shape": [b, t, h, dh, ds], "max_abs_err": err,
                   "tol": SSD_TOL, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, **_tc_bound(nbytes, ops),
                   "f32_bound_ms": f32["bound_ms"],
                   "f32_bound_by": f32["bound_by"],
                   "bytes": nbytes, "ops": ops,
                   "tflops": ops / ms / 1e9,
                   "plan": SSD.launch_plan(b, t, h, dh, ds)}
            if name == "train":
                row["before_ms"] = SSD_BEFORE_MS
                row["predicted_ms"] = list(SSD_PREDICTED_MS)
                row["bwd_ms"] = _ssd_bwd_ms(torch, SSD, x, dt, A, B, C, D)
                lo, hi = SSD_PREDICTED_MS
                print(f"ssd_scan at the training shape: {ms:.4f} ms "
                      f"(before the tensor cores {SSD_BEFORE_MS}; predicted "
                      f"{lo}-{hi}: {'in' if lo <= ms <= hi else 'out'}); "
                      f"bounds: tensor cores {row['bound_ms']:.4f} "
                      f"({row['bound_by']}), float32 CUDA cores "
                      f"{row['f32_bound_ms']:.4f}; SSDScan backward "
                      f"{row['bwd_ms']:.3f} ms; {report['nvidia_smi']}")
            rows.append(row)
            print(json.dumps(row))
            del x, dt, A, B, C, D, y, ref
        torch.cuda.empty_cache()
    report["ssd_table"] = rows
    r = rows[0]                       # the training shape
    return [{"name": "ssd_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:76", "launches": 0,
             **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}]


def _ssd_bwd_ms(torch, SSD, *inputs) -> float:
    """CUDA-event time of one ``SSDScan`` backward (autograd of the plain
    ``ssd_chunked`` on the saved inputs), every input needing a gradient,
    as in training."""
    ins = [v.detach().clone().requires_grad_(True) for v in inputs]
    y = SSD.SSDScan.apply(*ins)
    gy = torch.randn_like(y)

    def bwd(i):
        torch.autograd.grad(y, ins, gy, retain_graph=True)

    ms = _time_ms(torch, bwd, 3)
    del ins, y, gy
    return ms


def _sdpa_backend(torch, grad_fn) -> str:
    """The device kernels one SDPA backward runs, by name."""
    prof = _device_profile(torch, grad_fn)
    return "; ".join(n for n, _, _ in prof["top"][:3])


def compare_flash_bwd(torch, report) -> list:
    import torch.nn.functional as TF
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R
    dev = torch.device("cuda")
    rows = []
    with phase("2e. flash_attention backward against its plain versions"):
        gen = torch.Generator(device=dev).manual_seed(4)
        for name, (b, hq, hkv, t, d), dt, kw in FLASH_BWD_CASES:
            dtype = getattr(torch, dt)
            q, k, v, g = (torch.randn(shape, device=dev, generator=gen
                                      ).to(dtype)
                          for shape in ((b, hq, t, d), (b, hkv, t, d),
                                        (b, hkv, t, d), (b, hq, t, d)))
            out, lse = FA.flash_attention_fwd(q, k, v, **kw)
            got = FA.flash_attention_bwd(q, k, v, out, lse, g, **kw)
            # the plain backward on the same saved tensors
            want = R.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                             out.float(), lse, g.float(),
                                             **kw)
            # autograd through the plain forward
            ins = [x.float().requires_grad_(True) for x in (q, k, v)]
            auto = torch.autograd.grad(R.flash_attention_ref(*ins, **kw),
                                       ins, g.float())
            torch.cuda.synchronize()
            tol_ref, tol_auto = FLASH_BWD_TOL[dt]
            errs, auto_errs = [], []
            for gname, a, w, au in zip("qkv", got, want, auto):
                a = a.float()
                errs.append(float((a - w).abs().max()))
                auto_errs.append(float((a - au).abs().max()))
                if dt == "float32":
                    ok = torch.allclose(a, w, rtol=tol_ref, atol=tol_auto) \
                        and torch.allclose(a, au, rtol=tol_ref,
                                           atol=tol_auto)
                else:
                    ok = torch.allclose(
                        a, w, rtol=tol_ref,
                        atol=tol_ref * float(w.abs().max())) \
                        and torch.allclose(
                            a, au, rtol=tol_auto,
                            atol=tol_auto * float(au.abs().max()))
                check(bool(ok), f"flash_attention_bwd {name} d{gname}: max "
                      f"abs err {errs[-1]} (plain bwd), {auto_errs[-1]} "
                      "(autograd)")
            del want, auto, ins
            torch.cuda.empty_cache()
            pairs, mask = _visible_pairs(torch, t, t, **kw)
            lib_ms = lib_backend = None
            if "softcap" not in kw:       # no PyTorch call soft-caps
                lib_kw = ({"is_causal": kw["causal"]} if set(kw) == {"causal"}
                          else {"attn_mask": mask})
                lq, lk, lv = (x.detach().requires_grad_(True)
                              for x in (q, k, v))
                lo = TF.scaled_dot_product_attention(lq, lk, lv,
                                                     enable_gqa=True,
                                                     **lib_kw)

                def lib(i):
                    return torch.autograd.grad(lo, (lq, lk, lv), g,
                                               retain_graph=True)

                lib_err = max(float((x.float() - w.float()).abs().max())
                              for x, w in zip(lib(0), got))
                check(lib_err < 0.05 * max(float(w.float().abs().max())
                                           for w in got),
                      f"flash_attention_bwd {name}: the library yardstick "
                      f"computes another gradient (max abs err {lib_err})")

                def lib_once():
                    lib(0)
                    torch.cuda.synchronize()

                lib_backend = _sdpa_backend(torch, lib_once)
            reps = 5 if b * hq * t * t * d > 1e9 else 20
            ms = _time_ms(torch, lambda i: FA.flash_attention_bwd(
                q, k, v, out, lse, g, **kw), reps)
            plain_ms = _time_ms(torch, lambda i: R.flash_attention_bwd_ref(
                q, k, v, out, lse, g, **kw), max(2, reps // 5))
            if lib_backend is not None:
                lib_ms = _time_ms(torch, lib, reps)
                del lo, lq, lk, lv
            es = q.element_size()
            nbytes = (es * (4 * b * hq * t * d + 4 * b * hkv * t * d)
                      + 4 * b * hq * t)
            flops = 10.0 * b * hq * d * pairs
            peak = BF16_FLOPS if dt == "bfloat16" else FP32_FLOPS
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            row = {"name": "flash_attention_bwd", "case": name,
                   "shape": [b, hq, hkv, t, d], "dtype": dt, "options": kw,
                   "tol": FLASH_BWD_TOL[dt], "max_abs_err": max(errs),
                   "max_abs_err_autograd": max(auto_errs), "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_kernels": lib_backend,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "flops": flops,
                   "tflops": flops / ms / 1e9}
            rows.append(row)
            print(json.dumps(row))
            del q, k, v, g, out, lse, got, mask
            torch.cuda.empty_cache()
    report["flash_bwd_table"] = rows
    r = rows[0]                       # the training shape
    return [{"name": "flash_attention_bwd", "route": "cuda",
             # the bf16 route (tensor cores), which the path runs
             "source":
                 "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "replaces": "src/repro/kernels/flash_xla.py:121",
             "launches": 0,
             **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}]


def _kernel_modules():
    from repro_torch.kernels import (ell_spmv, flash_attention, hh_step,
                                     izhikevich_step, ssd_scan)
    return ell_spmv, izhikevich_step, hh_step, flash_attention, ssd_scan


def reset_launches() -> None:
    for m in _kernel_modules():
        m.reset_launches()


def read_launches() -> dict:
    out: dict = {}
    for m in _kernel_modules():
        out.update(m.launches)
    return out


@contextlib.contextmanager
def plain_versions():
    """Route every kernel's wrapper to its plain version on the card, for
    the comparison runs only (the port itself never does this)."""
    from unittest import mock
    from repro_torch.kernels import ref as R
    K, IZ, HH, FA, SSD = _kernel_modules()
    with mock.patch.object(K, "ell_spmv", R.ell_spmv_ref), \
            mock.patch.object(K, "ell_spmv_delay", R.ell_spmv_delay_ref), \
            mock.patch.object(IZ, "izhikevich_step", R.izhikevich_step_ref), \
            mock.patch.object(HH, "hh_step", R.hh_step_ref), \
            mock.patch.object(FA, "flash_attention", R.flash_attention_ref), \
            mock.patch.object(FA, "flash_attention_fwd",
                              R.flash_attention_fwd_ref), \
            mock.patch.object(FA, "flash_attention_bwd",
                              R.flash_attention_bwd_ref), \
            mock.patch.object(SSD, "ssd_scan", SSD._plain):
        yield


def _raster_agreement(torch, a, b) -> float:
    num = sum(int((a[k] == b[k]).sum()) for k in a)
    den = sum(a[k].numel() for k in a)
    return num / den


def _flash_kernels(direction: str) -> tuple:
    """The device kernels of both flash routes, forward ("fwd") or
    backward ("bwd"), by the names a profile shows."""
    from repro_torch.kernels import flash_attention as FA
    return tuple(n for r in FA.ROUTES.values() for n in r[direction])


def _device_profile(torch, fn) -> dict:
    """Device time by kernel name and the wall time of ``fn()`` under
    torch.profiler (``fn`` ends in a synchronise)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:100]
            n, us = by_name.get(key, (0, 0.0))
            by_name[key] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    check(busy > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"wall_us": wall_us, "device_busy_us": busy,
            "busy_share": busy / wall_us,
            "device_ops": sum(n for n, _ in by_name.values()),
            "top": [[n[:80], c, us] for n, (c, us) in top[:8]],
            "by_name": {n: [c, us] for n, (c, us) in top}}


def _profile_window(torch, model, steps: int, **run_kw) -> dict:
    """Device busy share, device ops per step and the kernels that fill the
    busy time, from a torch.profiler trace of ``steps`` steps.  Profiling
    slows the host, so the idle share it shows is an upper bound."""
    model.run(2, **run_kw)
    torch.cuda.synchronize()

    def run():
        model.run(steps, **run_kw)
        torch.cuda.synchronize()

    prof = _device_profile(torch, run)
    # device time per launch of the port's own kernels, by kernel name
    ours = {n[:80]: {"launches": c, "us_per_launch": us / c}
            for n, (c, us) in prof["by_name"].items()
            if any(k in n for k in ("ell_spmv_kernel",
                                    "izhikevich_step_kernel",
                                    "hh_step_kernel",
                                    *_flash_kernels("fwd")))}
    busy_us, wall_us = prof["device_busy_us"], prof["wall_us"]
    top = [(n, us) for n, _, us in prof["top"][:6]]
    print(f"profiled {steps} steps: device busy {busy_us:.0f} of "
          f"{wall_us:.0f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{prof['device_ops'] / steps:.0f} device ops/step; top: "
          + "; ".join(f"{n[:40]} {us:.0f} us" for n, us in top))
    print(f"the port's kernels on the device: {ours}")
    return {"steps": steps, "wall_us": wall_us, "device_busy_us": busy_us,
            "busy_share": prof["busy_share"],
            "device_ops_per_step": prof["device_ops"] / steps,
            "top_us": [list(x) for x in top], "kernels": ours,
            "by_name": prof["by_name"]}


def _run_checked(torch, model, steps, what, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.run(steps, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rates = {k: float(v) for k, v in res.rates_hz.items()}
    finite = bool(res.finite)
    print(f"{what}: {steps} steps in {secs:.3f} s "
          f"({secs / steps * 1e6:.1f} us/step), rates Hz {rates}, "
          f"finite {finite}")
    check(finite, f"{what}: state went non-finite")
    check(all(0.0 < r < float("inf") for r in rates.values()),
          f"{what}: a population is silent or its rate is not finite: "
          f"{rates}")
    return res, secs, rates


def main_path(torch, report):
    from repro_torch.core.models import izhikevich_net as IZ
    with phase("3. main path: Izhikevich net, 100k neurons"):
        cfg = IZ.IzhikevichNetConfig(n_total=MAIN["n_total"],
                                     n_conn=MAIN["n_conn"],
                                     representation="sparse")
        t0 = time.perf_counter()
        model = IZ.compile_model(cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        groups = [(g.name, g.representation, g.ell.n_pre, g.ell.max_conn,
                   int(g.ell.valid.sum())) for g in model.network.synapses]
        print(f"built {model} in {build_s:.1f} s; groups {groups}")
        n_sparse = sum(1 for g in model.network.synapses
                       if g.representation == "sparse")
        check(n_sparse == 4, f"expected 4 sparse groups, got {groups}")
        check(model.simulator.routes == {"exc": "izhikevich_step",
                                         "inh": "izhikevich_step"},
              f"neuron routes {model.simulator.routes}")
        model.run(5)                            # warm-up: library, caches
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res, secs, rates = _run_checked(torch, model, MAIN["steps"],
                                        "kernel run")
        launches = read_launches()
        print(f"launches in the main-path run: {launches}")
        check(launches["ell_spmv"] >= n_sparse * MAIN["steps"],
              f"ell_spmv launched {launches['ell_spmv']} times for "
              f"{n_sparse} sparse groups x {MAIN['steps']} steps")
        check(launches["izhikevich_step"] == 2 * MAIN["steps"],
              f"izhikevich_step launched {launches['izhikevich_step']} "
              f"times for 2 populations x {MAIN['steps']} steps")
        report["main"] = {
            "config": MAIN, "build_s": build_s, "groups": groups,
            "seconds": secs, "us_per_step": secs / MAIN["steps"] * 1e6,
            "rates_hz": rates, "launches": launches,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}

        n = MAIN["plain_steps"]
        kr = model.run(n, record_raster=True).raster
        reset_launches()
        with plain_versions():
            pr = model.run(n, record_raster=True).raster
        check(not any(read_launches().values()),
              f"the plain run launched kernels: {read_launches()}")
        agree = _raster_agreement(torch, kr, pr)
        print(f"raster agreement kernel vs plain over {n} steps: {agree}")
        check(agree >= RASTER_AGREEMENT, f"rasters agree on only {agree}")
        report["main"]["plain_raster_agreement"] = agree
        report["main"]["profile"] = _profile_window(torch, model, 50)
        return launches, model


def sweep(torch, report, model) -> None:
    from repro_torch.core import conductance as C
    with phase("4. gScale sweep of the excitatory groups"):
        values = list(SWEEP["values"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = model.sweep_gscale("exc", values, SWEEP["steps"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rates = {k: v.tolist() for k, v in s.rates_hz.items()}
        finite = s.finite.tolist()
        print(f"{len(values)} candidates x {SWEEP['steps']} steps in "
              f"{secs:.3f} s: {len(values) / secs:.3f} candidates/s")
        for i, v in enumerate(values):
            print(f"  gScale {v}: " + ", ".join(
                f"{k} {rates[k][i]:.4f} Hz" for k in rates)
                + f", finite {finite[i]}")
        for k, r in rates.items():
            fin = [x for x, ok in zip(r, finite) if ok]
            check(all(b >= a for a, b in zip(fin, fin[1:])),
                  f"{k} rate falls as gScale grows: {r}")
        target = report["main"]["rates_hz"]["exc"]
        pick = C.search_sweep(lambda c: (s.rates_hz["exc"], s.finite),
                              values, target)
        print(f"search_sweep to the main run's exc rate {target:.4f} Hz: "
              f"{pick}")
        check(pick.finite and min(abs(pick.gscale - v) for v in values)
              < 1e-6, f"search_sweep picked {pick}")
        report["sweep"] = {"values": values, "steps": SWEEP["steps"],
                           "seconds": secs,
                           "candidates_per_s": len(values) / secs,
                           "rates_hz": rates, "finite": finite,
                           "pick": pick.__dict__}


def delay_path(torch, report) -> dict:
    from repro_torch.core.models import izhikevich_net as IZ
    from repro_torch.core.snn.spec import ModelSpec
    from repro_torch.sparse.formats import UniformIntDelay
    with phase("5. delay path: per-synapse delays 0..20 steps"):
        cfg = IZ.IzhikevichNetConfig(n_total=DELAY["n_total"],
                                     n_conn=DELAY["n_conn"],
                                     representation="sparse")
        base = IZ.spec(cfg)
        ms = ModelSpec(f"{base.name}_delayed")
        for pop in base.populations.values():
            ms.add_neuron_population(pop.name, pop.n, pop.model, pop.params,
                                     pop.input_fn)
        for sp in base.synapses:
            ms.add_synapse_population(
                sp.name, sp.pre, list(sp.post), sp.connect, sp.weight,
                representation="sparse",
                delay=(UniformIntDelay(0, DELAY["max_delay"])
                       if sp.name == "exc" else None))
        model = ms.build(dt=cfg.dt, seed=cfg.seed)
        rings = [(g.name, g.ring_slots if g.needs_ring else 0)
                 for g in model.network.synapses]
        print(f"built {model}; ring slots {rings}")
        model.run(5)
        reset_launches()
        _, secs, rates = _run_checked(torch, model, DELAY["steps"],
                                      "delay run")
        launches = read_launches()
        print(f"launches in the delay run: {launches}")
        check(launches["ell_spmv_delay"] >= 2 * DELAY["steps"],
              "ell_spmv_delay did not run for both delayed groups each step")
        n = MAIN["plain_steps"]
        kr = model.run(n, record_raster=True).raster
        reset_launches()
        with plain_versions():
            pr = model.run(n, record_raster=True).raster
        check(not any(read_launches().values()),
              f"the plain run launched kernels: {read_launches()}")
        agree = _raster_agreement(torch, kr, pr)
        print(f"raster agreement kernel vs plain over {n} steps: {agree}")
        check(agree >= RASTER_AGREEMENT, f"rasters agree on only {agree}")
        report["delay"] = {"config": DELAY, "seconds": secs,
                           "us_per_step": secs / DELAY["steps"] * 1e6,
                           "rates_hz": rates, "launches": launches,
                           "plain_raster_agreement": agree}
        return launches


def gscale_table(torch, report) -> float:
    """Phase 6a; returns the KC rate at gScale 1 (the search's target)."""
    from repro_torch.core.models import mushroom_body as MB
    with phase("6a. mushroom body: the NaN-guard table"):
        cfg = MB.MushroomBodyConfig(**MB_EXAMPLE)
        model = MB.compile_model(cfg)
        print(f"built {model}; routes {model.simulator.routes}")
        values, steps = list(MB_TABLE["values"]), MB_TABLE["steps"]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = model.sweep_gscale("PN_KC", values, steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        rates = {k: v.tolist() for k, v in s.rates_hz.items()}
        finite = s.finite.tolist()
        print(f"{len(values)} candidates x {steps} steps in {secs:.3f} s "
              f"({secs / steps * 1e6:.1f} us/step); launches {launches}")
        print(" gScale |  PN Hz |  KC Hz |  DN Hz | finite (NaN guard)")
        for i, g in enumerate(values):
            print(f" {g:6.1f} | {rates['PN'][i]:6.1f} | {rates['KC'][i]:6.1f} "
                  f"| {rates['DN'][i]:6.1f} | {finite[i]}")
        check(launches["hh_step"] == 3 * steps,
              f"hh_step launched {launches['hh_step']} times for 3 "
              f"populations x {steps} steps")
        check(finite[0] and finite[1], f"not finite at gScale 0.5 or 1: "
              f"{finite}")
        check(not finite[-1], "gScale 50 did not trip the NaN guard")
        check(all(abs(r - cfg.pn_rate_hz) < 15.0 for r in rates["PN"]),
              f"PN rates {rates['PN']} not within 15 Hz of "
              f"{cfg.pn_rate_hz}")
        report["mb_table"] = {"config": MB_EXAMPLE, "values": values,
                              "steps": steps, "seconds": secs,
                              "us_per_step": secs / steps * 1e6,
                              "rates_hz": rates, "finite": finite,
                              "launches": launches}
        return rates["KC"][1]


def mushroom_body_full(torch, report, kc_target: float) -> dict:
    """Phase 6b; returns the launch counts of its 2500-step run."""
    from repro_torch.core import conductance as C
    from repro_torch.core.models import mushroom_body as MB
    with phase("6b. mushroom body at full width: 100k KCs"):
        cfg = MB.MushroomBodyConfig(**MB_FULL)
        ex = MB_EXAMPLE
        # each group's gScale: the example's fan-in over this size's
        fan_in = {"PN_KC": ex["n_pn"] / cfg.n_pn,
                  "PN_LHI": ex["n_pn"] / cfg.n_pn,
                  "LHI_KC": ex["n_lhi"] / cfg.n_lhi,
                  "KC_DN": ex["n_kc"] / cfg.n_kc,
                  "DN_DN": ex["n_dn"] / cfg.n_dn}
        t0 = time.perf_counter()
        model = MB.compile_model(cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        groups = [(g.name, g.representation, g.ell.n_pre, g.ell.n_post,
                   g.ell.max_conn) for g in model.network.synapses]
        print(f"built {model} in {build_s:.1f} s; groups {groups}; "
              f"fan-in gScales {fan_in}")
        check(model.simulator.routes == {"PN": "codegen", "LHI": "hh_step",
                                         "KC": "hh_step", "DN": "hh_step"},
              f"neuron routes {model.simulator.routes}")
        steps = MB_RUN["steps"]
        model.run(5, gscales=fan_in)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _, secs, rates = _run_checked(torch, model, steps, "kernel run",
                                      gscales=fan_in)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        print(f"launches {launches}; peak device memory {peak} B")
        check(launches["hh_step"] == 3 * steps,
              f"hh_step launched {launches['hh_step']} times for 3 "
              f"populations x {steps} steps")
        out = report["mb_full"] = {
            "config": MB_FULL, "fan_in_gscales": fan_in, "build_s": build_s,
            "groups": groups, "steps": steps, "seconds": secs,
            "us_per_step": secs / steps * 1e6, "rates_hz": rates,
            "launches": launches, "peak_mem_bytes": peak}

        n = MB_RUN["plain_steps"]
        kr = model.run(n, gscales=fan_in, record_raster=True).raster
        reset_launches()
        with plain_versions():
            pr = model.run(n, gscales=fan_in, record_raster=True).raster
        check(not any(read_launches().values()),
              f"the plain run launched kernels: {read_launches()}")
        agree = _raster_agreement(torch, kr, pr)
        print(f"raster agreement kernel vs plain over {n} steps: {agree}")
        check(agree >= RASTER_AGREEMENT, f"rasters agree on only {agree}")
        out["plain_raster_agreement"] = agree
        out["profile"] = _profile_window(torch, model, 50, gscales=fan_in)

        others = {k: v for k, v in fan_in.items() if k != "PN_KC"}
        search_steps = MB_RUN["search_steps"]

        seen = {}

        def kc_rate(cands):
            """One batched run of every candidate; PN_KC's gScale [B], the
            other groups' fan-in gScales as scalars."""
            res = model.simulator.run(
                model.init_state(len(cands)), search_steps,
                {**others, "PN_KC": cands.to(model.device)})
            seen["kc"], seen["finite"] = res.rates_hz["KC"], res.finite
            return res.rates_hz["KC"], res.finite

        cands = list(MB_RUN["search"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pick = C.search_sweep(kc_rate, cands, kc_target)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        kc, fin = seen["kc"].tolist(), seen["finite"].tolist()
        for g, r, f in zip(cands, kc, fin):
            print(f"  PN_KC gScale {g:.4f}: KC {r:.4f} Hz, finite {f}")
        bracketed = (min(r for r, f in zip(kc, fin) if f) <= kc_target
                     <= max(r for r, f in zip(kc, fin) if f))
        print(f"search_sweep to 6a's KC rate {kc_target:.4f} Hz: {pick} "
              f"({len(cands)} candidates x {search_steps} steps in "
              f"{search_s:.3f} s; target bracketed: {bracketed})")
        check(pick.finite, f"search_sweep picked {pick}")
        out["search"] = {"candidates": cands, "steps": search_steps,
                         "seconds": search_s, "kc_rates_hz": kc,
                         "finite": fin, "target_hz": kc_target,
                         "bracketed": bracketed, "pick": pick.__dict__}
        return launches


def serve_full(torch, report) -> dict:
    """Phase 7; returns the launch counts of the serving run."""
    import numpy as np
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import transformer as T
    cfg_s = SERVE
    with phase("7. LM serving at full width: qwen2-0.5b"):
        t0 = time.perf_counter()
        srv = Server(cfg_s["arch"], use_reduced=False,
                     max_batch=cfg_s["max_batch"], max_seq=cfg_s["max_seq"],
                     seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = srv.cfg
        n_params = T.count_params(srv.params)
        leaves = tree_leaves(srv.params)
        param_bytes = sum(x.numel() * x.element_size() for x in leaves)
        caches = T.init_caches(cfg, cfg_s["max_batch"], cfg_s["max_seq"],
                               device="cuda")
        cache_bytes = sum(c[k].numel() * c[k].element_size()
                          for c in caches["segments"] for k in ("k", "v"))
        del caches
        print(f"{cfg.name}: {n_params} params ({param_bytes} B, "
              f"{leaves[0].dtype}) drawn in {init_s:.2f} s; KV cache "
              f"{cache_bytes} B at B={cfg_s['max_batch']}, "
              f"S={cfg_s['max_seq']}")
        check(all(x.dtype == torch.bfloat16 for x in leaves),
              "the full-width weights are not all bf16")

        # warm-up (cuBLAS handles, allocator), before the counted run
        warm = torch.randint(3, cfg.vocab, (1, 64), device="cuda")
        logits, caches = T.prefill(srv.params, cfg, warm, max_seq=80)
        T.decode_step(srv.params, cfg, caches, logits.argmax(-1))
        torch.cuda.synchronize()
        del caches

        rng = np.random.default_rng(0)
        lo, hi = cfg_s["prompt_len"]
        lens = rng.integers(lo, hi + 1, size=cfg_s["requests"])
        reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab,
                                                   size=int(n)).tolist(),
                        max_new=cfg_s["max_new"])
                for i, n in enumerate(lens)]
        rows_seen = {"n": 0, "finite": True}
        sample = srv._sample

        def checked_sample(logits, req):
            rows_seen["n"] += 1
            rows_seen["finite"] &= bool(np.isfinite(logits[:cfg.vocab]).all())
            return sample(logits, req)

        srv._sample = checked_sample
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t_submit = time.perf_counter()
        for r in reqs:
            srv.submit(r)
        srv.run()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t_submit
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        print(f"served {len(reqs)} requests in {total_s:.3f} s; launches "
              f"{launches}; peak device memory {peak} B")
        check(all(r.done and len(r.out) == cfg_s["max_new"] for r in reqs),
              "a request did not get its tokens: "
              f"{[len(r.out) for r in reqs]}")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
              "a sampled token is a pad id")
        check(rows_seen["finite"] and rows_seen["n"] == len(reqs)
              * cfg_s["max_new"], f"logit rows: {rows_seen}")
        n_waves = len(srv.waves)
        check(launches["flash_attention"] == cfg.n_layers * n_waves == 48,
              f"flash_attention launched {launches['flash_attention']} "
              f"times for {cfg.n_layers} layers x {n_waves} waves")
        check(not any(v for k, v in launches.items()
                      if k != "flash_attention"),
              f"an SNN kernel launched on the serving path: {launches}")
        waves = []
        for w in srv.waves:
            tokens = w["size"] * w["prompt_len"]
            waves.append({
                **w, "prefill_tokens": tokens,
                "prefill_tok_per_s": tokens / w["prefill_s"],
                "ttft_s": w["first_token_at"] - t_submit,
                "decode_ms_per_step": w["decode_s"] / w["decode_steps"] * 1e3,
                "decode_tok_per_s": w["size"] * w["decode_steps"]
                / w["decode_s"]})
            print("wave: " + json.dumps(waves[-1]))
        out = report["serve"] = {
            "config": cfg_s, "params": n_params, "param_bytes": param_bytes,
            "kv_cache_bytes": cache_bytes, "init_s": init_s,
            "prompt_lens": lens.tolist(), "total_s": total_s,
            "tokens": sum(len(r.out) for r in reqs), "waves": waves,
            "launches": launches, "peak_mem_bytes": peak}

        # the kernel against the plain versions, float32 weights
        p32 = tree_map(lambda t: t.float(), srv.params)
        toks = torch.tensor(rng.integers(
            3, cfg.vocab, (cfg_s["check_prompts"], cfg_s["check_len"])),
            device="cuda")
        lk, _ = T.prefill(p32, cfg, toks)
        with plain_versions():
            lp, _ = T.prefill(p32, cfg, toks)
        lk, lp = lk[:, :cfg.vocab], lp[:, :cfg.vocab]
        torch.cuda.synchronize()
        err = float((lk - lp).abs().max())
        print(f"float32 prefill of {tuple(toks.shape)}, kernel vs plain "
              f"last-token logits: max abs err {err}, argmax "
              f"{lk.argmax(-1).tolist()} vs {lp.argmax(-1).tolist()}")
        check(bool(torch.allclose(lk, lp, rtol=cfg_s["tol"],
                                  atol=cfg_s["tol"])),
              f"float32 logits differ by {err}")
        check(torch.equal(lk.argmax(-1), lp.argmax(-1)),
              "float32 argmax differs between kernel and plain")
        out["f32_check"] = {"shape": list(toks.shape), "max_abs_err": err}
        del p32, lk, lp

        # where the device time goes: one prefill wave, 20 decode steps
        first = reqs[:cfg_s["max_batch"]]
        maxlen = max(len(r.prompt) for r in first)
        wave = np.zeros((len(first), maxlen), np.int64)
        for i, r in enumerate(first):
            wave[i, maxlen - len(r.prompt):] = r.prompt
        wave = torch.from_numpy(wave).cuda()
        box = {}

        def prefill():
            box["logits"], box["caches"] = T.prefill(
                srv.params, cfg, wave, max_seq=cfg_s["max_seq"])
            torch.cuda.synchronize()

        prof_prefill = _device_profile(torch, prefill)
        fa_us = sum(us for n, (_, us) in prof_prefill["by_name"].items()
                    if any(k in n for k in _flash_kernels("fwd")))
        prof_prefill["flash_share"] = fa_us / prof_prefill["device_busy_us"]
        check(prof_prefill["flash_share"] > 0,
              "the prefill profile shows no flash_attention kernel by name: "
              f"{prof_prefill['top']}")
        token = box["logits"].argmax(-1)

        def decode():
            caches, tok = box["caches"], token
            for _ in range(cfg_s["decode_profile_steps"]):
                logits, caches = T.decode_step(srv.params, cfg, caches, tok)
                tok = logits.argmax(-1)
            tok.cpu()

        prof_decode = _device_profile(torch, decode)
        print(f"prefill wave {tuple(wave.shape)} profiled: device busy "
              f"{prof_prefill['device_busy_us']:.0f} us of "
              f"{prof_prefill['wall_us']:.0f}, flash_attention "
              f"{100 * prof_prefill['flash_share']:.1f}% of device time; "
              f"top {prof_prefill['top'][:4]}")
        print(f"{cfg_s['decode_profile_steps']} decode steps profiled: "
              f"card busy {100 * prof_decode['busy_share']:.1f}% of "
              f"{prof_decode['wall_us']:.0f} us, "
              f"{prof_decode['device_ops'] / cfg_s['decode_profile_steps']:.0f}"
              f" device ops/step; top {prof_decode['top'][:4]}")
        out["profile_prefill"] = prof_prefill
        out["profile_decode"] = prof_decode
        del srv, box
        return launches


def _train_setup(torch, cfg, batch: int, seq: int, steps: int, lr: float,
                 seed: int):
    """What ``launch.train.run`` builds: weights from a seeded generator,
    AdamW with the trainer's schedule, the train step, the pipeline."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build
    from repro_torch.optim import adamw, schedule
    params = build(cfg).init(seed=seed, device="cuda")
    ocfg = adamw.AdamWConfig(lr=schedule.warmup_cosine(
        lr, warmup=min(20, steps // 5 + 1), total=steps), grad_clip=1.0)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=seed),
                         device="cuda")
    return (params, adamw.init(ocfg, params), make_train_step(cfg, ocfg),
            pipe)


# device-time categories of a training step, by kernel name (first match),
# after the flash kernels of both routes (kernels.flash_attention.ROUTES)
STEP_CATEGORIES = (
    ("ssd_scan", ("ssd_scan_kernel",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
    ("copy", ("copy", "Memcpy", "Memset")),
    ("reduce", ("reduce", "SoftMax")),
    ("elementwise", ("elementwise", "Functor", "index", "scatter", "gather",
                     "cat", "where")),
)


def _categories(prof) -> dict:
    """Device us and share of busy time by STEP_CATEGORIES ("other" for a
    kernel no pattern names)."""
    cats = (("flash_attention_bwd", _flash_kernels("bwd")),
            ("flash_attention", _flash_kernels("fwd"))) + STEP_CATEGORIES
    out: dict = {}
    for n, (c, us) in prof["by_name"].items():
        cat = next((k for k, pats in cats if any(p in n for p in pats)),
                   "other")
        o = out.setdefault(cat, {"launches": 0, "us": 0.0})
        o["launches"] += c
        o["us"] += us
    for o in out.values():
        o["share"] = o["us"] / prof["device_busy_us"]
    return out


def train_full(torch, report, arch: str, label: str) -> dict:
    """Phases 8a / 8b: train ``arch`` at full width and depth; returns the
    launch counts of the run (warm-up step included)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    spec = TRAIN[arch]
    b, t, steps = spec["batch"], spec["seq"], spec["steps"]
    with phase(f"{label}. train {arch} at full width and depth"):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params, opt, step_fn, pipe = _train_setup(torch, cfg, b, t, steps,
                                                  spec["lr"], seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = T.count_params(params)
        flops_tok = T.model_flops_per_token(cfg, n_params)
        print(f"{arch}: {cfg.n_layers} layers, d {cfg.d_model}, {n_params} "
              f"params ({cfg.dtype}, fp32 master and moments), remat "
              f"{cfg.remat} ({cfg.remat_policy}); batch {b} x {t}; init "
              f"{init_s:.2f} s")
        check(cfg.remat and cfg.dtype == "bfloat16",
              f"{arch}: expected the full config (bf16, remat)")
        rows = []
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        before = read_launches()
        bwd_calls = {"SSDScan": 0}
        for i in range(steps):
            batch = pipe.next_batch()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with _counting_ssd_backward(bwd_calls):
                params, opt, m = step_fn(params, opt, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            now = read_launches()
            step_launches = {k: now[k] - before[k] for k in now}
            before = now
            rows.append({"step": i + 1, "loss": loss, "ms": secs * 1e3,
                         "tokens_per_s": b * t / secs,
                         "model_tflops": flops_tok * b * t / secs / 1e12,
                         "grad_norm": float(m["grad_norm"]),
                         "lr": float(m["lr"]),
                         "launches": {k: v for k, v in step_launches.items()
                                      if v}})
            print("step: " + json.dumps(rows[-1]))
            if i == 0 and "first_loss_cuda_cores" in spec:
                print(f"{arch}: first step's loss {loss:.4f} beside "
                      f"{spec['first_loss_cuda_cores']} on the CUDA-core "
                      "flash kernels (same seed and data)")
            check(math.isfinite(loss), f"{arch}: step {i + 1} loss {loss}")
            for k, want in spec["per_step"].items():
                check(step_launches[k] == want,
                      f"{arch}: {k} launched {step_launches[k]} times in "
                      f"step {i + 1}, expected {want}")
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        timed = rows[1:]                # the first step is the warm-up
        ms = sum(r["ms"] for r in timed) / len(timed)
        summary = {"ms_per_step": ms, "tokens_per_s": b * t / ms * 1e3,
                   "model_tflops": flops_tok * b * t / ms / 1e9,
                   "peak_mem_bytes": peak}
        if bwd_calls["SSDScan"]:
            # the SSD backward's share of a step: its calls a step times its
            # CUDA-event time at this shape (phase 2d)
            calls = bwd_calls["SSDScan"] / steps
            bwd_ms = report["ssd_table"][0]["bwd_ms"]
            summary["ssd_bwd"] = {"calls_per_step": calls, "ms": bwd_ms,
                                  "ms_per_step": calls * bwd_ms,
                                  "share": calls * bwd_ms / ms}
            fwd_ms = report["ssd_table"][0]["ms"]
            summary["ssd_fwd"] = {"launches_per_step":
                                  spec["per_step"]["ssd_scan"], "ms": fwd_ms,
                                  "ms_per_step": spec["per_step"]["ssd_scan"]
                                  * fwd_ms}
        print(f"{arch}: {json.dumps(summary)}; launches {launches}")

        # where the device time of one more step goes
        box = {"p": params, "o": opt}
        batch = pipe.next_batch()

        def one_step():
            box["p"], box["o"], box["m"] = step_fn(box["p"], box["o"], batch)
            float(box["m"]["loss"])
            torch.cuda.synchronize()

        prof = _device_profile(torch, one_step)
        cats = _categories(prof)
        for k in spec["per_step"]:
            check(cats.get(k, {}).get("us", 0) > 0,
                  f"{arch}: the step's profile shows no {k} kernel by name")
        print(f"profiled step: device busy {prof['device_busy_us']:.0f} of "
              f"{prof['wall_us']:.0f} us ({100 * prof['busy_share']:.1f}%), "
              f"{prof['device_ops']} device ops; by category "
              + "; ".join(f"{k} {v['launches']} x, {v['us']:.0f} us "
                          f"({100 * v['share']:.1f}%)"
                          for k, v in sorted(cats.items(),
                                             key=lambda kv: -kv[1]["us"]))
              + f"; top {prof['top'][:6]}")
        report[f"train_{arch}"] = {
            "config": {**spec, "params": n_params, "flops_per_token":
                       flops_tok}, "init_s": init_s, "steps": rows,
            **summary, "launches": launches, "profile": prof,
            "categories": cats}
        del params, opt, box, step_fn
        torch.cuda.empty_cache()
        return launches


@contextlib.contextmanager
def _counting_ssd_backward(calls: dict):
    """Count the calls of ``SSDScan``'s backward (autograd looks it up on
    the class at each call)."""
    from unittest import mock
    from repro_torch.kernels import ssd_scan as SSD
    real = SSD.SSDScan.backward

    def counted(ctx, gy):
        calls["SSDScan"] += 1
        return real(ctx, gy)

    with mock.patch.object(SSD.SSDScan, "backward", staticmethod(counted)):
        yield


def _grads_of_step(torch, step_fn, params, opt, batch):
    """One train step on copies of params/opt; (loss, grads, launches)."""
    from torch.utils._pytree import tree_map
    from unittest import mock
    from repro_torch.optim import adamw
    seen = {}
    real = adamw.update

    def spy(cfg, grads, state, p):
        seen["grads"] = tree_map(lambda g: g.detach().clone(), grads)
        return real(cfg, grads, state, p)

    p = tree_map(lambda x: x.detach().clone(), params)
    o = opt._replace(mu=tree_map(torch.clone, opt.mu),
                     nu=tree_map(torch.clone, opt.nu),
                     master=tree_map(torch.clone, opt.master))
    reset_launches()
    with mock.patch.object(adamw, "update", spy):
        _, _, m = step_fn(p, o, batch)
        loss = float(m["loss"])
    torch.cuda.synchronize()
    return loss, seen["grads"], read_launches()


def train_step_check(torch, report) -> None:
    """Phase 8c: one train step with the kernels and with the plain
    versions, at full width, 2 layers, float32."""
    import dataclasses
    from torch.utils._pytree import tree_flatten_with_path
    from repro_torch.configs import get_config
    c = STEP_CHECK
    out = report["train_step_check"] = {}
    with phase("8c. one train step on the card: kernels against plain "
               "versions"):
        for arch in ("qwen2-0.5b", "mamba2-2.7b"):
            cfg = dataclasses.replace(get_config(arch), n_layers=c["layers"],
                                      dtype="float32")
            params, opt, step_fn, pipe = _train_setup(
                torch, cfg, c["batch"], c["seq"], 1, 1e-3, seed=1)
            batch = pipe.next_batch()
            lk, gk, launches_k = _grads_of_step(torch, step_fn, params, opt,
                                                batch)
            with plain_versions():
                lp, gp, launches_p = _grads_of_step(torch, step_fn, params,
                                                    opt, batch)
            print(f"{arch} ({c['layers']} layers, float32): loss kernel "
                  f"{lk} plain {lp}; launches {launches_k} / plain "
                  f"{launches_p}")
            check(abs(lk - lp) <= c["loss_tol"],
                  f"{arch}: losses differ by {abs(lk - lp)}")
            check(not any(launches_p.values()),
                  f"{arch}: the plain run launched {launches_p}")
            want = ({"flash_attention": 2 * c["layers"],
                     "flash_attention_bwd": c["layers"]}
                    if cfg.family == "dense"
                    else {"ssd_scan": 2 * c["layers"]})
            check(all(launches_k[k] == n for k, n in want.items()),
                  f"{arch}: kernel launches {launches_k}, expected {want}")
            worst = {}
            for (path, a), (_, w) in zip(tree_flatten_with_path(gk)[0],
                                         tree_flatten_with_path(gp)[0]):
                key = "".join(str(x) for x in path)
                err = float((a - w).abs().max())
                scale = float(w.abs().max())
                worst[key] = [err, scale]
                check(bool(torch.allclose(a, w, rtol=c["grad_rtol"],
                                          atol=c["grad_atol_frac"] * scale)),
                      f"{arch}: gradient {key} differs by {err} "
                      f"(largest entry {scale})")
            if cfg.family == "dense":
                for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
                    g = gk["segments"][0]["attn"][name]
                    check(bool(g.abs().sum() > 0),
                          f"{arch}: {name} has no gradient on the card")
            rel = max(e / max(s, 1e-30) for e, s in worst.values())
            print(f"{arch}: {len(worst)} gradients within tolerance; "
                  f"largest error relative to its leaf's scale {rel:.3g}")
            out[arch] = {"loss_kernel": lk, "loss_plain": lp,
                         "launches": launches_k, "grad_err": worst,
                         "max_rel_grad_err": rel}
            del params, opt, step_fn, gk, gp
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
