"""Batched serving on the PyTorch/CUDA port: submit concurrent requests and
watch the scheduler prefill and decode them as a batch (KV caches, ring
buffers for windowed archs, O(1) conv and SSD states for the SSM and
hybrid archs, top-k expert routing for the MoE archs, cross-attention
caches over the encoder's frames for whisper, an image prefix under the
prefix-LM mask for paligemma).

The flow of ``examples/serve_lm.py`` through ``repro_torch``, on the
reduced config of any arch.  Runs on the card (``cuda``) unless asked
otherwise:

  PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen2-0.5b
  PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2-2.7b
  PYTHONPATH=src python examples/serve_lm_torch.py \\
      --arch granite-moe-1b-a400m --device cpu
  PYTHONPATH=src python examples/serve_lm_torch.py --arch whisper-tiny
  PYTHONPATH=src python examples/serve_lm_torch.py --arch paligemma-3b
"""

import argparse
import time

import numpy as np

from repro_torch.launch.serve import Request, Server


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="a dense, moe, ssm, hybrid, encdec or vlm arch "
                         "(reduced)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    srv = Server(args.arch, use_reduced=True, max_batch=3, max_seq=128,
                 device=args.device)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(3, srv.cfg.vocab,
                              size=int(rng.integers(4, 16))).tolist()
        r = Request(rid=i, prompt=prompt, max_new=args.max_new,
                    temperature=args.temperature)
        reqs.append(r)
        srv.submit(r)

    t0 = time.time()
    srv.run()
    dt = time.time() - t0
    tokens = sum(len(r.out) for r in reqs)
    print(f"arch={args.arch} ({srv.cfg.family}) on {srv.device}: "
          f"{args.requests} requests, {tokens} tokens in {dt:.1f}s -> "
          f"{tokens/dt:.1f} tok/s")
    for r in reqs:
        print(f"  req{r.rid}: {len(r.prompt)}-token prompt -> "
              f"{r.out[:10]}{'...' if len(r.out) > 10 else ''}")


if __name__ == "__main__":
    main()
