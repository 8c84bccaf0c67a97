"""End-to-end LM training on the PyTorch/CUDA port: the deterministic
token pipeline, the model's loss and backward (the flash-attention and SSD
kernels on the card), AdamW, checkpoint/restart and the NaN guard.

The flow of ``examples/train_lm.py`` through ``repro_torch``.  Default: a
~20M-param qwen2-family model, 150 steps; ``--hundred-m`` a ~100M-param
one; ``--arch NAME`` the reduced config of any arch instead (e.g.
``mamba2-2.7b``, ``granite-moe-1b-a400m``, ``mixtral-8x22b``,
``zamba2-7b``: the MoE archs print their load-balance aux beside the
cross entropy; ``whisper-tiny`` and ``paligemma-3b``: each batch carries
the trainer's audio frames or image).  Checkpoints are saved every
``--ckpt-every`` steps and at the last one; a non-finite loss rolls back
to the latest with the LR halved.  With ``--ckpt-dir`` a run restarts
from the latest checkpoint there (run it again after an interruption);
without one they go to a temporary directory removed at exit.  Runs on
the card (``cuda``) unless asked otherwise:

  PYTHONPATH=src python examples/train_lm_torch.py --ckpt-dir ckpt_lm
  PYTHONPATH=src python examples/train_lm_torch.py --hundred-m --steps 300
  PYTHONPATH=src python examples/train_lm_torch.py --arch zamba2-7b \\
      --steps 20 --device cpu
  PYTHONPATH=src python examples/train_lm_torch.py --arch whisper-tiny \\
      --steps 20 --seq 64
"""

import argparse
import contextlib
import dataclasses
import tempfile

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
    ap.add_argument("--ckpt-dir", default=None,
                    help="keep checkpoints here and restart from the "
                         "latest (default: a temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
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
    with (contextlib.nullcontext(args.ckpt_dir) if args.ckpt_dir
          else tempfile.TemporaryDirectory(prefix="train_lm_torch_")) as ckpt:
        losses = train_mod.run(
            arch, steps=args.steps, batch=args.batch, seq=args.seq,
            use_reduced=use_reduced, ckpt_dir=ckpt,
            ckpt_every=args.ckpt_every, lr=1e-3, log_every=10,
            device=args.device)
    if not losses:
        print(f"\nnothing to train: {args.ckpt_dir} holds step {args.steps}")
        return
    n = min(10, len(losses))
    print(f"\nfirst-{n} mean loss {sum(losses[:n])/n:.3f} -> "
          f"last-{n} mean {sum(losses[-n:])/n:.3f}")


if __name__ == "__main__":
    main()
