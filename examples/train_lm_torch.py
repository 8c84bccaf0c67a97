"""End-to-end LM training on the PyTorch/CUDA port: the deterministic
token pipeline, the model's loss and backward (the flash-attention and SSD
kernels on the card), AdamW and the NaN guard.

The flow of ``examples/train_lm.py`` through ``repro_torch``.  Default: a
~20M-param qwen2-family model, 150 steps; ``--hundred-m`` a ~100M-param
one; ``--arch NAME`` the reduced config of any arch but paligemma-3b
instead (e.g. ``mamba2-2.7b``, ``granite-moe-1b-a400m``,
``mixtral-8x22b``, ``zamba2-7b``: the MoE archs print their load-balance
aux beside the cross entropy; ``whisper-tiny``: each batch carries the
trainer's audio frames).  Checkpoint and restart wait for the port of
``checkpoint/manager.py`` (ROADMAP Queue 1 item 8.6): a non-finite loss
raises.  Runs on the card (``cuda``) unless asked otherwise:

  PYTHONPATH=src python examples/train_lm_torch.py
  PYTHONPATH=src python examples/train_lm_torch.py --hundred-m --steps 300
  PYTHONPATH=src python examples/train_lm_torch.py --arch zamba2-7b \\
      --steps 20 --device cpu
  PYTHONPATH=src python examples/train_lm_torch.py --arch whisper-tiny \\
      --steps 20 --seq 64
"""

import argparse
import dataclasses

from repro_torch import configs
from repro_torch.launch import train as train_mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--arch", default=None,
                    help="train this arch's reduced config instead")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    if args.arch is not None:
        arch, use_reduced = args.arch, True
    else:
        # family: qwen2 (GQA + qkv-bias + tied embeddings)
        base = configs.get_config("qwen2-0.5b")
        if args.hundred_m:
            cfg = dataclasses.replace(
                base, n_layers=10, d_model=640, n_heads=10, n_kv=2,
                head_dim=64, d_ff=2560, vocab=50304, dtype="float32",
                remat=False)
        else:
            cfg = dataclasses.replace(
                base, n_layers=6, d_model=320, n_heads=5, n_kv=1,
                head_dim=64, d_ff=1280, vocab=16384, dtype="float32",
                remat=False)
        # register the custom config under a name so train.run finds it
        arch, use_reduced = "_example_lm", False
        configs.ARCHS[arch] = dataclasses.replace(cfg, name=arch)
    losses = train_mod.run(
        arch, steps=args.steps, batch=args.batch, seq=args.seq,
        use_reduced=use_reduced, lr=1e-3, log_every=10, device=args.device)
    n = min(10, len(losses))
    print(f"\nfirst-{n} mean loss {sum(losses[:n])/n:.3f} -> "
          f"last-{n} mean {sum(losses[-n:])/n:.3f}")


if __name__ == "__main__":
    main()
