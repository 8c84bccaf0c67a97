"""The card's rate of the tensor-core instruction the float32 flash route
runs, ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``, alone:

    python3 experiments/mma_tf32_rate.py

Builds ``experiments/mma_tf32_rate.cu`` (nvcc, the kernels' flags) into
``chiprun_out/``, launches 8 CTAs of 256 threads for each SM, every warp
issuing 8 independent accumulations in a loop, and times the launches
with CUDA events.  Prints one JSON line: mma.sync a second, TFLOP/s (2 x
16 x 8 x 8 a product) and their share of the card's TF32 peak of 495
TFLOP/s (dense, which only wgmma reaches), and the cycles one SM
sub-partition takes for one mma.sync at the SM clock nvidia-smi reports
under the load (the median of its samples).  Needs one card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("mma_tf32_rate: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    lib_path = out_dir / "mma_tf32_rate.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "experiments" / "mma_tf32_rate.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_tf32_rate.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas, iters = 8 * sms, 4096
    out = torch.empty(ctas * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.mma_tf32_rate(out.data_ptr(), ctas, iters, stream)
        if rc:
            raise RuntimeError(f"mma_tf32_rate launch failed ({rc})")

    launch()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 500                        # ~1 s of work, the clock sampled in it
    mhz: list = []
    done = threading.Event()

    def sample():
        while not done.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout
            mhz.extend(int(x) for x in out.split() if x.isdigit())

    sampler = threading.Thread(target=sample)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    sampler.start()
    torch.cuda.synchronize()
    done.set()
    sampler.join()
    ms = start.elapsed_time(end) / reps
    n = ctas * 8 * iters * lib.mma_tf32_chains()
    per_s = n / (ms * 1e-3)
    sm_mhz = sorted(mhz)[len(mhz) // 2] if mhz else float("nan")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    row = {"mma_per_s": per_s, "tflops": per_s * 2 * 16 * 8 * 8 / 1e12,
           "share_of_tf32_peak": per_s * 2 * 16 * 8 * 8 / 495e12,
           "sm_mhz": sm_mhz,
           "cycles_per_mma_per_subpartition":
               sm_mhz * 1e6 * sms * 4 / per_s,
           "ms": ms, "mma": n, "nvidia_smi": smi}
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
