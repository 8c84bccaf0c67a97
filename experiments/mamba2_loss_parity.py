"""Mamba2's first training losses in both packages, on the CPU: does the
port's trainer follow the JAX package's from the same weights?

    JAX_PLATFORMS=cpu PYTHONPATH=src python experiments/mamba2_loss_parity.py \
        [--layers 2] [--batch 1] [--seq 32] [--steps 3] [--dtype float32]

Both trainers (``repro.launch.train.run`` and ``repro_torch.launch.train.
run``) train mamba2-2.7b at full width (d_model 2560, 80 SSD heads of 64,
state 128, vocab 50280) cut to ``--layers`` layers by ``depth_scaled``,
with the trainer's own schedule (warmup_cosine(3e-3, warmup=min(20,
steps // 5 + 1), total=steps)), AdamW and token pipeline.  The port starts
from the JAX run's own weights (its ``PRNGKey(0)`` draw, carried over by
``repro_torch.convert.load_lm_params``), as ``tests/test_torch_train.py``
does at reduced width.  ``--dtype`` sets the parameters' type (the full
config's is bfloat16; float32 compares the algorithm).  The default
sequence is the tests' 32 tokens: from 64 on, a chunk's decay can exceed
float32's exp range, and the JAX package's ``ssd_chunked`` then gets a NaN
gradient (it exponentiates the masked upper triangle before ``where``),
which the port's masks first (``repro_torch.models.ssm.ssd_chunked``).

Prints both loss series (a trainer stops at its first non-finite loss,
which is printed as nan) and, for each step, the relative difference; the
last line is a JSON object with both series.  Exits 1 when a step's losses
differ by more than ``tests/test_torch_train.py``'s run tolerance
(rtol=1e-5) in float32.  Needs several GB of host memory at full width:
it is no tier-1 test.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from unittest import mock

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--reduced-width", action="store_true",
                    help="the tests' reduced width instead of the full one "
                         "(a quick check of the script itself)")
    args = ap.parse_args(argv)

    import jax
    import torch

    from repro.configs import base as JB
    from repro.configs import get_config as jget_config
    from repro.launch import train as JTR
    from repro.models import transformer as JT
    from repro_torch.configs import base as TB
    from repro_torch.configs import get_config as tget_config
    from repro_torch.convert import load_lm_params
    from repro_torch.launch import train as TTR
    from repro_torch.models import transformer as TT

    arch = "mamba2-2.7b"

    def cut(base, cfg):
        if args.reduced_width:
            cfg = base.reduced(cfg)
        cfg = base.depth_scaled(cfg, args.layers)
        return dataclasses.replace(cfg, dtype=args.dtype)

    jcfg = cut(JB, jget_config(arch))
    tcfg = cut(TB, tget_config(arch))
    print(f"{arch}: d_model {jcfg.d_model}, {jcfg.n_layers} layers, vocab "
          f"{jcfg.vocab}, ssm_state {jcfg.ssm_state}, dtype {jcfg.dtype}; "
          f"batch {args.batch} x {args.seq} tokens, {args.steps} steps",
          flush=True)
    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq,
              log_every=1, use_reduced=True)
    jrec: list = []
    with mock.patch.object(JTR, "make_reduced", lambda c: jcfg), \
            mock.patch.object(jax, "jit", _recording_jit(jax, jrec)):
        jlosses = _losses(lambda: JTR.run(arch, **kw), jrec)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = load_lm_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    del jp
    trec: list = []
    make_step = TTR.make_train_step

    def recording_step(*a, **k):
        f = make_step(*a, **k)

        def step(*args):
            out = f(*args)
            trec.append(float(out[2]["loss"]))
            return out
        return step
    with mock.patch.object(TTR, "make_reduced", lambda c: tcfg), \
            mock.patch.object(TT, "init_params", lambda cfg, gen: tp), \
            mock.patch.object(TTR, "make_train_step", recording_step):
        tlosses = _losses(lambda: TTR.run(arch, device="cpu", **kw), trec)
    rel = [abs(t - j) / abs(j) if math.isfinite(t - j) else None
           for t, j in zip(tlosses, jlosses)]
    if len(jlosses) != len(tlosses):
        print(f"losses for {len(jlosses)} steps (jax) and {len(tlosses)} "
              "(port)")
    for i, (j, t, r) in enumerate(zip(jlosses, tlosses, rel)):
        print(f"step {i + 1}: jax {j!r}  port {t!r}  rel diff {r}")
    print(json.dumps({"arch": arch, "layers": jcfg.n_layers,
                      "d_model": jcfg.d_model, "dtype": jcfg.dtype,
                      "batch": args.batch, "seq": args.seq,
                      "jax": jlosses, "port": tlosses, "rel_diff": rel,
                      "torch": torch.__version__, "jax_version":
                          jax.__version__}))
    agree = len(jlosses) == len(tlosses) and all(
        r is not None and r <= 1e-5 for r in rel)
    return 0 if args.dtype != "float32" or agree else 1


def _losses(run, recorded: list) -> list:
    """The losses of ``run()``.  A trainer stops at its first non-finite
    loss (FloatingPointError): then the losses its steps recorded are
    returned, that one included, with the error printed."""
    try:
        return [float(x) for x in run()]
    except FloatingPointError as e:
        print(f"  {e}")
        return list(recorded)


def _recording_jit(jax, recorded: list):
    """jax.jit that records the loss of every call of the trainer's jitted
    step (``train_step``); other functions are jitted as they are."""
    jit = jax.jit

    def patched(fn, *a, **kw):
        f = jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "train_step":
            return f

        def step(*args):
            out = f(*args)
            recorded.append(float(out[2]["loss"]))
            return out
        return step
    return patched


if __name__ == "__main__":
    sys.exit(main())
