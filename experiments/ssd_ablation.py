"""Where the SSD scan's time goes: this tree's ``csrc/ssd_scan.cu`` timed
with parts of its chunk loop taken out, beside the whole kernel:

    python3 experiments/ssd_ablation.py [--rounds R]

Each ablation is the source with one text replacement (``ABLATIONS``),
built by ``nvcc`` with the kernels' flags into the git-ignored
``kernels/_build/ablation/`` and loaded in place of the library.  Taking
a product, a split or an exp out makes the output wrong by design (the
printed ``max_abs_err`` against ``ssd_chunked`` says how wrong), its time
is the point; ``no_overlap`` keeps the output right and waits for chunk c
+ 1's copies as soon as they are issued, so that none runs under chunk c's
products (the copy overlap, lever (a), taken out).  At 2d's training
shape and its two serving prefills (``chip_smoke.SSD_CASES[0]``,
``SSD_STATE_CASES[:2]``) it prints one JSON line a (round, ablation,
shape): ms a call of ``ssd_scan`` by ``chip_smoke._time_ms`` (CUDA events,
20 calls after a warm one), the plan's heads a CTA, and the card's
``nvidia-smi`` name and power limit.  The ablations run in turns, ``R``
rounds (default 2).  Needs one card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (text in csrc/ssd_scan.cu, its replacement)
_P1 = ("        wgmma3<kQ>(acc, fa[kb], desc(ch + (k0 + kb) * 64, 128, "
       "NS * 32),\n                   desc(cl + (k0 + kb) * 64, 128, "
       "NS * 32));")
_P2 = ("        wgmma3<kQ>(a2, fx[kb], desc(gh + kb * 64, 128, 1024),\n"
       "                   desc(gl + kb * 64, 128, 1024));")
_P3 = ("      wgmma3<NS>(st, fw[kb], desc(bh + kb * 64, 128, 1024),\n"
       "                 desc(bl + kb * 64, 128, 1024));")
ABLATIONS = {
    "whole": [],
    "no_p1": [(_P1, ";")],
    "no_p2": [(_P2, ";")],
    "no_p3": [(_P3, ";")],
    "no_products": [(_P1, ";"), (_P2, ";"), (_P3, ";")],
    "no_split": [("for (int u = tid; u < kQ * (NS / 8); u += nthreads)",
                  "for (int u = tid; u < 0; u += nthreads)"),
                 ("for (int u = tid; u < NS * 8; u += nthreads)",
                  "for (int u = tid; u < 0; u += nthreads)")],
    "no_decay_exp": [("const float dec = expf(j <= i ? ci - cj : 0.0f);",
                      "const float dec = 1.0f;")],
    "no_overlap": [("    if (c + 1 < nc) copy(c + 1);",
                    "    if (c + 1 < nc) { copy(c + 1); cp_wait_all(); }")],
}


def build_variants(_build, texts: dict) -> dict:
    """name -> (ctypes library, nvcc's log) for each source text in
    ``texts`` (a variant of ``csrc/ssd_scan.cu`` with its C interface),
    built in parallel by ``nvcc`` with the kernels' flags into the
    git-ignored ``kernels/_build/ablation/``; raises if one fails."""
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out / f"ssd_scan_{name}.cu"
        cu.write_text(text)
        so = out / f"libssd_scan_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name} failed to build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        lib.ssd_scan_fwd.argtypes = ([ctypes.c_void_p] * 9
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, log)
    return libs


def _ablated(src: str) -> dict:
    """name -> the source with that ablation's replacements."""
    texts = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old[:60]!r} once")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def main(argv) -> int:
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--rounds"}:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("ssd_ablation: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.ssm import ssd_chunked
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    libs = {name: lib for name, (lib, _) in build_variants(
        _build, _ablated((_build.CSRC / "ssd_scan.cu").read_text())).items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, (b, t, h, dh, ds) in [C.SSD_CASES[0]] + list(
            C.SSD_STATE_CASES[:2]):
        x = torch.randn((b, t, h, dh), device=dev, generator=gen)
        dt = 0.001 + 0.1 * torch.rand((b, t, h), device=dev, generator=gen)
        A = -torch.exp(2.0 * torch.rand(h, device=dev, generator=gen))
        B, Cm = (torch.randn((b, t, 1, ds), device=dev, generator=gen)
                 for _ in range(2))
        D = torch.randn(h, device=dev, generator=gen)
        ref = ssd_chunked(x, dt, A, B, Cm, D)
        heads = SSD.launch_plan(b, t, h, dh, ds)["scan"]["heads"]
        for rnd in range(int(opts.get("--rounds", 2))):
            for abl, lib in libs.items():
                SSD._lib = lambda lib=lib: lib
                err = float((SSD.ssd_scan(x, dt, A, B, Cm, D) - ref).abs()
                            .max())
                ms = C._time_ms(torch, lambda i: SSD.ssd_scan(
                    x, dt, A, B, Cm, D), 20)
                print(json.dumps({"round": rnd, "ablation": abl,
                                  "case": name, "shape": [b, t, h, dh, ds],
                                  "heads": heads, "ms": ms,
                                  "max_abs_err": err, "nvidia_smi": smi}),
                      flush=True)
        del x, dt, A, B, Cm, D, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
