"""Time one tree's float32 flash-attention route on the card at every
float32 case of chip_smoke.py's phases 2c (``FLASH_CASES``) and 2e
(``FLASH_BWD_CASES``), with chip_smoke's own timers, so that two versions
(for example this tree's and an earlier commit's) are held side by side by
the same yardstick:

    python3 experiments/flash_f32_times.py [--src DIR] [--tag NAME]

``DIR`` holds the ``repro_torch`` package to time (default: this tree's
``src``); an earlier commit's comes from ``git archive <commit> src | tar
-x -C <dir>`` into a directory that ``.gitignore`` lists.  The library is
built from that tree's sources (its build log's register and spill lines
are printed first).  For each case it prints one JSON line: ``ms`` (CUDA
events around back-to-back calls, ``chip_smoke._time_ms``: at the small
shapes this is the host's time to issue a call), ``device_ms`` (the device
time of one call's kernels, from a torch.profiler trace after a warm-up
call, ``chip_smoke._device_profile``) and its kernels by name, the largest
error against the plain version (``ref.flash_attention_ref``, or the plain
backward and autograd through the plain forward) checked at chip_smoke's
tolerances, and for the backward whether two calls gave the same bits.
The rows also go to ``chiprun_out/flash_f32_times_<NAME>.json`` (NAME
defaults to the directory's name).  Needs one card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _device_ms(torch, C, fn) -> tuple:
    """(device ms of one call of ``fn``, [[kernel, us], ...])."""
    def once():
        fn()
        torch.cuda.synchronize()
    prof = C._device_profile(torch, once, warm=True)
    return (prof["device_busy_us"] / 1e3,
            [[n, us] for n, _, us in prof["top"]])


def main(argv) -> int:
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--src", "--tag"}:
        print(__doc__, file=sys.stderr)
        return 2
    src = Path(opts.get("--src", ROOT / "src")).resolve()
    tag = opts.get("--tag", src.parent.name)
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_times: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R
    built = _build.build(["flash_attention"])["flash_attention"]
    print(f"{tag}: flash_attention built from {src} in "
          f"{built['seconds']:.1f} s")
    for ln in built["log"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("  " + ln.strip())
    dev = torch.device("cuda")
    rows = []
    gen = torch.Generator(device=dev).manual_seed(2)
    for name, (b, hq, hkv, t, d), dt, kw, tol in C.FLASH_CASES:
        if dt != "float32":
            continue
        tq, tk = t if isinstance(t, tuple) else (t, t)
        q, k, v = (torch.randn(s, device=dev, generator=gen)
                   for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
        out = FA.flash_attention(q, k, v, **kw)
        ref = R.flash_attention_ref(q, k, v, **kw)
        err = float((out - ref).abs().max())
        C.check(bool(torch.allclose(out, ref, rtol=tol, atol=tol)),
                f"{tag} forward {name}: max abs err {err} > {tol}")
        reps = 10 if b * hq * tq * tk * d > 1e9 else 50
        ms = C._time_ms(torch, lambda i: FA.flash_attention(q, k, v, **kw),
                        reps)
        dev_ms, kernels = _device_ms(torch, C, lambda: FA.flash_attention(
            q, k, v, **kw))
        row = {"tree": tag, "pass": "fwd", "case": name,
               "shape": [b, hq, hkv, t, d], "options": kw, "ms": ms,
               "device_ms": dev_ms, "kernels": kernels,
               "max_abs_err": err, "tol": tol}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, out, ref
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, (b, hq, hkv, t, d), dt, kw in C.FLASH_BWD_CASES:
        if dt != "float32":
            continue
        tq, tk = t if isinstance(t, tuple) else (t, t)
        q, k, v, g = (torch.randn(s, device=dev, generator=gen)
                      for s in ((b, hq, tq, d), (b, hkv, tk, d),
                                (b, hkv, tk, d), (b, hq, tq, d)))
        out, lse = FA.flash_attention_fwd(q, k, v, **kw)
        got = FA.flash_attention_bwd(q, k, v, out, lse, g, **kw)
        again = FA.flash_attention_bwd(q, k, v, out, lse, g, **kw)
        same = all(bool(torch.equal(a, b2)) for a, b2 in zip(got, again))
        want = R.flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        auto = torch.autograd.grad(R.flash_attention_ref(*ins, **kw), ins, g)
        rtol, atol = C.FLASH_BWD_TOL["float32"]
        errs = []
        for gname, a, w, au in zip("qkv", got, want, auto):
            errs.append(max(float((a - w).abs().max()),
                            float((a - au).abs().max())))
            C.check(bool(torch.allclose(a, w, rtol=rtol, atol=atol)
                         and torch.allclose(a, au, rtol=rtol, atol=atol)),
                    f"{tag} backward {name} d{gname}: max abs err "
                    f"{errs[-1]}")
        del want, auto, ins, again
        reps = 5 if b * hq * tq * tk * d > 1e9 else 20
        ms = C._time_ms(torch, lambda i: FA.flash_attention_bwd(
            q, k, v, out, lse, g, **kw), reps)
        dev_ms, kernels = _device_ms(torch, C, lambda: FA.flash_attention_bwd(
            q, k, v, out, lse, g, **kw))
        row = {"tree": tag, "pass": "bwd", "case": name,
               "shape": [b, hq, hkv, t, d], "options": kw, "ms": ms,
               "device_ms": dev_ms, "kernels": kernels,
               "max_abs_err": max(errs), "tol": [rtol, atol],
               "bit_equal_calls": same}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, g, out, lse, got
    torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"flash_f32_times_{tag}.json").write_text(
        json.dumps({"nvidia_smi": C.subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
