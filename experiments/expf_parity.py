"""Where a float32 kernel can part from PyTorch's rounding on the card.
The Traub-Miles kernel (``csrc/neuron_step.cu``) calls ``expf`` where its
plain version calls ``torch.exp``, and multiplies by a reciprocal where
the plain version divides by a Python float.  This counts the float32
arguments where ``expf`` built with the port's flags
(``kernels._build.NVCC_FLAGS``, ``-fmad=false``), and without
``-fmad=false``, differs from ``torch.exp``, over ``--n`` arguments
uniform in [-40, 40] and every float32 in [-1, 1) that is a multiple of
2^-20; and the arguments where ``x / 0.143`` (the membrane capacitance)
differs from ``x * float(1 / 0.143)`` (the reciprocal taken in double)
and from ``x * (1f / 0.143f)`` (taken in float32):

    python3 experiments/expf_parity.py [--n N]

Prints one JSON line.  Needs one card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
extern "C" __global__ void exp_kernel(const float* x, float* y, long n) {
  long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i < n) y[i] = expf(x[i]);
}
extern "C" int run_exp(const float* x, float* y, long n) {
  exp_kernel<<<(n + 255) / 256, 256>>>(x, y, n);
  return (int)cudaDeviceSynchronize();
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 26)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("expf_parity: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = torch.cat([
        -40.0 + 80.0 * torch.rand(args.n, device="cuda", generator=gen),
        torch.arange(-(1 << 20), 1 << 20, device="cuda",
                     dtype=torch.float32) / float(1 << 20)])
    want = torch.exp(xs)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "expf.cu"
        src.write_text(SOURCE)
        for label, drop in (("port_flags", ()), ("fmad_true",
                                                  ("-fmad=false",))):
            flags = [f for f in _build.NVCC_FLAGS
                     if f not in drop and f not in ("-Xptxas", "-v")]
            lib = Path(tmp) / f"lib{label}.so"
            subprocess.run([_build._nvcc(), *flags, "-o", str(lib),
                            str(src)], check=True, timeout=300)
            so = ctypes.CDLL(str(lib))
            so.run_exp.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_long]
            y = torch.empty_like(xs)
            rc = so.run_exp(xs.data_ptr(), y.data_ptr(), xs.numel())
            if rc != 0:
                raise RuntimeError(f"{label}: cuda error {rc}")
            diff = y != want
            out[label] = {"differ": int(diff.sum()), "of": xs.numel(),
                          "max_ulp": int((y.view(torch.int32)
                                          - want.view(torch.int32))
                                         .abs().max())}
    x = xs[:args.n]
    q = x / 0.143
    inv64 = torch.tensor(1.0 / 0.143, dtype=torch.float32, device="cuda")
    inv32 = (torch.tensor(1.0, dtype=torch.float32)
             / torch.tensor(0.143, dtype=torch.float32)).cuda()
    out["div_by_python_float"] = {
        "differ_from_reciprocal_in_double": int((q != x * inv64).sum()),
        "differ_from_reciprocal_in_float32": int((q != x * inv32).sum()),
        "of": x.numel()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
