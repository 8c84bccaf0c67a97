"""The trainer, the counterpart of ``repro/launch/train.py``: the
token pipeline, the model's loss, its backward, AdamW, checkpoint and
restart, and the paper's NaN guard, on one device (``cuda`` unless
``device=`` / ``--device`` names another; without a card that raises).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 100 --batch 8 --seq 256 --ckpt-dir ckpt   # reduced config
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --full --steps 3 --batch 2 --seq 2048           # full width, on a card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 3 --device cpu                          # the plain versions
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen2-0.5b --steps 3 --device cpu --model-parallel 2

Every family trains: dense, moe (granite-moe, mixtral: the loss is ce
plus the load-balance aux, both printed), ssm (mamba2), hybrid (zamba2,
its shared block's gradient summed over its applications), encdec
(whisper) and vlm (paligemma).  Step i's batch carries an encdec model's
audio frames ``0.1 * normal(fold_in(PRNGKey(seed), i), (b, enc_seq,
d_model))`` or a vlm model's image ``0.1 * normal(fold_in(PRNGKey(seed),
i), (b, img_tokens, img_embed_dim))``, drawn by ``repro_torch.random``'s
threefry as the JAX trainer draws them.

With ``ckpt_dir`` the trainer keeps the last two checkpoints
(``checkpoint/manager.py``) of ``{"params", "opt"}``, saved every
``ckpt_every`` steps and at the last one; a run that finds one restarts
from the latest, the pipeline at that step.  NaN containment follows the
paper's Fig-1 guard as the JAX trainer applies it: a non-finite loss
rolls back to the latest checkpoint with the LR (the "conductance")
halved, down to ``lr_floor_scale``; without a checkpoint it raises
``FloatingPointError``.  The JAX trainer does not use ``cfg.microbatches``
either: one step is one batch.

Model parallelism: with a process group up (``launch.mesh.
init_distributed``, or ``torchrun``, which ``main`` joins) ``run`` builds
``make_local_mesh(model_parallel)``; the params, and with them AdamW's
moments and master copies, are placed by ``param_specs`` (DTensors: FSDP
over the batch axes, tensor parallelism over "model"); each step's batch
is split over the batch axes by ``batch_specs`` (whole on every rank when
they do not divide it), the loss and its gradient run under ``activate``,
and the clip's global norm sums every block once.  Checkpoints hold whole
leaves (rank 0 writes them) and restore into the blocks.  Without a group
(the JAX package's one device) ``model_parallel`` is clamped to 1 and the
trainer runs on one device, as before.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import mesh as MESH
from repro_torch.launch import sharding as SH
from repro_torch.models import transformer as T
from repro_torch import random as RND
from repro_torch.optim import adamw, schedule
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.runtime.straggler import StragglerPolicy

__all__ = ["make_train_step", "run", "main", "extra_inputs"]


def make_train_step(cfg, ocfg: adamw.AdamWConfig, mesh=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss, the gradient of every parameter, and the AdamW update (in
    place).  The params are made leaves that require grad.  With ``mesh``
    the params are placed, ``batch`` is the global batch (the same on
    every rank), and the step takes this rank's rows of it by
    ``batch_specs``."""
    def grad_of(params, leaves, batch):
        loss, metrics = T.loss_fn(params, cfg, batch)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state, batch):
        leaves, spec = tree_flatten(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        if mesh is None:
            loss, metrics, grads = grad_of(params, leaves, batch)
        else:
            split = any(SH.batch_specs(batch["tokens"], mesh))
            local = {k: SH.local_rows(v, mesh, split)
                     for k, v in batch.items()}
            # the backward's collectives read the axis env too
            with SH.activate(mesh, batch_sharded=split):
                loss, metrics, grads = grad_of(params, leaves, local)
        grads = tree_unflatten(list(grads), spec)
        new_params, new_opt, om = adamw.update(ocfg, grads, opt_state,
                                               params)
        return new_params, new_opt, {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}
    return train_step


def extra_inputs(cfg, batch_size: int, step: int, seed: int,
                 device) -> dict:
    """Step ``step``'s extra inputs for a batch of ``batch_size``: an
    encdec model's audio frames ``0.1 * normal(fold_in(PRNGKey(seed),
    step), (b, enc_seq, d_model))`` float32, a vlm model's image ``0.1 *
    normal(fold_in(PRNGKey(seed), step), (b, img_tokens, img_embed_dim))``
    (the JAX trainer's draws, within the normal's 4 ulp), else none."""
    spec = T.extra_input(cfg)
    if spec is None:
        return {}
    name, row = spec
    key = RND.fold_in(RND.PRNGKey(seed, device=device), step)
    return {name: RND.normal(key, (batch_size,) + row, scale=0.1)}


def run(arch: str, steps: int = 50, batch: int = 8, seq: int = 256,
        use_reduced: bool = True, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 25, lr: float = 3e-3, seed: int = 0,
        model_parallel: int = 1, log_every: int = 10,
        lr_floor_scale: float = 0.125, device: DeviceLike = "cuda"):
    """Train to step ``steps`` (from the latest checkpoint in ``ckpt_dir``
    when there is one); returns the losses of the steps this call ran,
    a rolled-back step's included.  Weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device."""
    dev = resolve_device(device)
    mesh = None
    if dist.is_available() and dist.is_initialized():
        mesh = MESH.make_local_mesh(model_parallel, dev)
        dev = mesh.device
    cfg = get_config(arch)
    if use_reduced:
        cfg = make_reduced(cfg)

    sched = schedule.warmup_cosine(lr, warmup=min(20, steps // 5 + 1),
                                   total=steps)
    ocfg = adamw.AdamWConfig(lr=sched, grad_clip=1.0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=seed)
    pipe = TokenPipeline(dcfg, device=dev)
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2) if ckpt_dir else None

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    if mesh is not None:
        params = SH.place_params(params, mesh)
    opt_state = adamw.init(ocfg, params)
    step_fn = make_train_step(cfg, ocfg, mesh)

    def restored(step):
        # into the live tensors: the card never holds two training states
        snap = mgr.restore(step, {"params": params, "opt": opt_state},
                           in_place=True)
        cursor = {"step": step, "shard_index": 0, "num_shards": 1,
                  "seed": seed}
        return (snap["params"], snap["opt"],
                TokenPipeline.restore(dcfg, cursor, device=dev))

    start = 0
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        params, opt_state, pipe = restored(start)
        print(f"[train] restored step {start}")

    host = "host0"
    monitor = HeartbeatMonitor([host])
    straggler = StragglerPolicy()

    losses = []
    lr_scale = 1.0
    i = start
    while i < steps:
        batch_data = pipe.next_batch()
        batch_data.update(extra_inputs(
            cfg, batch_data["tokens"].shape[0], i, seed, dev))
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch_data)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        monitor.beat(host)
        straggler.observe(host, dt)
        if not math.isfinite(loss):
            # the paper's Fig-1 guard: roll back, halve the scale
            if mgr:
                mgr.wait()            # a write in flight becomes visible
            if mgr is None or mgr.latest_step() is None:
                raise FloatingPointError(
                    f"non-finite loss at step {i} and no checkpoint")
            lr_scale = max(lr_scale * 0.5, lr_floor_scale)
            back = mgr.latest_step()
            print(f"[train] NaN at step {i}; rollback to {back}, "
                  f"lr_scale={lr_scale}")
            ocfg = dataclasses.replace(ocfg,
                                       lr=lambda s: sched(s) * lr_scale)
            step_fn = make_train_step(cfg, ocfg, mesh)
            params, opt_state, pipe = restored(back)
            i = back
            continue
        losses.append(loss)
        i += 1
        if i % log_every == 0 or i == steps:
            ce, aux = float(metrics["ce"]), float(metrics["aux"])
            print(f"[train] step {i:5d} loss {loss:.4f} (ce {ce:.4f}, "
                  f"aux {aux:.4f}) ({dt*1e3:.0f} ms/step)")
        if mgr and (i % ckpt_every == 0 or i == steps):
            mgr.save(i, {"params": params, "opt": opt_state})
    if mgr:
        mgr.wait()
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (default: reduced)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    started = MESH.join_launcher(args.device)
    try:
        _train(args)
    finally:
        if started:
            MESH.shutdown_distributed()


def _train(args):
    losses = run(args.arch, steps=args.steps, batch=args.batch,
                 seq=args.seq, use_reduced=not args.full,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 lr=args.lr, seed=args.seed,
                 model_parallel=args.model_parallel, device=args.device)
    if not losses:
        print(f"[train] {args.ckpt_dir} already holds step {args.steps}")
        return
    print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
