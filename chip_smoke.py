#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one card.  The kernels
build from ``src/repro_torch/kernels/csrc`` at first use.  Phases (any
failure ends the run with a non-zero exit):

  1. the card (name, power limit) and the kernel build;
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
     bound: the serving prefill's shape, q [8, 14, 2048, 64] and k, v
     [8, 2, 2048, 64], bf16, causal (rtol=atol=1e-2 against the plain
     version in float32 on the same bf16 inputs); the same at B=1 in
     float32 (2e-5); gemma3's local layer, [1, 16, 2048, 256] /
     [1, 8, 2048, 256], window 1024, bf16; softcap 30, and prefix 100, at
     [1, 4, 256, 64] / [1, 2, 256, 64], float32; non-causal ragged T=200,
     float32;
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
     over 20 decode steps.

Before the last line it prints the card's ``nvidia-smi`` name and power
limit and a ``{"kernels": [...]}`` JSON line; the last line is
``{"ok": true, "device": {...}}``.  The full results also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS = 67e12               # H100 SXM, float32 outside tensor cores
BF16_FLOPS = 989e12              # H100 SXM, bf16 dense on the tensor cores
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
)
SERVE = dict(arch="qwen2-0.5b", max_batch=8, max_seq=4096, requests=16,
             prompt_len=(1024, 2048), max_new=32, check_prompts=2,
             check_len=512, tol=1e-3, decode_profile_steps=20)


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
    launches_main, model = main_path(torch, report)
    sweep(torch, report, model)
    del model
    torch.cuda.empty_cache()
    launches_delay = delay_path(torch, report)
    kc_target = gscale_table(torch, report)
    launches_mb = mushroom_body_full(torch, report, kc_target)
    torch.cuda.empty_cache()
    launches_serve = serve_full(torch, report)
    # each kernel's launches come from the run of its own path
    path_of = {"ell_spmv": launches_main, "ell_spmv_delay": launches_delay,
               "izhikevich_step": launches_main, "hh_step": launches_mb,
               "flash_attention": launches_serve}
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
            print(f"  {name}: " + " | ".join(regs))
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


def _visible_pairs(torch, tq, tk, causal, window=None, prefix=None, **_):
    """The number of (query, key) pairs the masks leave visible in one
    (batch, head), and the mask [tq, tk]."""
    qpos = torch.arange(tq, device="cuda")[:, None]
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
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:112",
             "launches": 0,
             **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}]


def _kernel_modules():
    from repro_torch.kernels import (ell_spmv, flash_attention, hh_step,
                                     izhikevich_step)
    return ell_spmv, izhikevich_step, hh_step, flash_attention


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
    K, IZ, HH, FA = _kernel_modules()
    with mock.patch.object(K, "ell_spmv", R.ell_spmv_ref), \
            mock.patch.object(K, "ell_spmv_delay", R.ell_spmv_delay_ref), \
            mock.patch.object(IZ, "izhikevich_step", R.izhikevich_step_ref), \
            mock.patch.object(HH, "hh_step", R.hh_step_ref), \
            mock.patch.object(FA, "flash_attention", R.flash_attention_ref):
        yield


def _raster_agreement(torch, a, b) -> float:
    num = sum(int((a[k] == b[k]).sum()) for k in a)
    den = sum(a[k].numel() for k in a)
    return num / den


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
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    check(busy > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"wall_us": wall_us, "device_busy_us": busy,
            "busy_share": busy / wall_us,
            "device_ops": sum(n for n, _ in by_name.values()),
            "top": [[n[:80], c, us] for n, (c, us) in top[:8]],
            "by_name": {n[:100]: [c, us] for n, (c, us) in top}}


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
                                    "flash_attention_kernel"))}
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
                    if "flash_attention_kernel" in n)
        prof_prefill["flash_share"] = fa_us / prof_prefill["device_busy_us"]
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


if __name__ == "__main__":
    sys.exit(main())
