"""The LM stack over a (data, model) mesh of gloo ranks -- not a test module.

D = 2 runs every family on a 1 x 2 mesh (with a qwen2 whose 3 heads run
whole; and qwen2 on a 2 x 1 mesh), D = 8 qwen2, granite-moe and the
reduced mixtral on a 2 x 4 one (the batch split over "data", the
sequence-split cache, "ffn" experts).  Each case returns what the mesh
computed, joined whole on every rank ("global"): the forward's logits
and aux, the loss and every gradient, a float32 prefill and two decode
steps with their caches, a short ``Server`` run's tokens, the trainer's
losses (a restart from its own checkpoint included) and a placed save.
``test_torch_lm_parallel.py`` holds them to the single-device port.  No
JAX here.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch import configs as CFG
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.convert import load_lm_params
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.launch import serve as S
from repro_torch.launch import train as TR
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# mixtral as the rule table meets it at full size (8 experts on a 16-wide
# "model" axis: the ffn dim takes the axis), at the reduced size: 3
# experts on a 2- or 4-wide axis
MIXTRAL_FFN = "mixtral-8x22b-e3"
CFG.ARCHS.setdefault(MIXTRAL_FFN, dataclasses.replace(
    get_config("mixtral-8x22b"), name=MIXTRAL_FFN, n_experts=3))

# qwen2 with heads that no "model" axis here divides (3 query heads over
# 1 KV head): attention runs whole on every rank, its weights joined, as
# qwen2-0.5b's 14 heads do on a 4-wide axis
QWEN2_WHOLE_HEADS = "qwen2-0.5b-h3"
CFG.ARCHS.setdefault(QWEN2_WHOLE_HEADS, dataclasses.replace(
    get_config("qwen2-0.5b"), name=QWEN2_WHOLE_HEADS, n_heads=3, n_kv=1))

B, T_LEN, MAX_SEQ = 4, 16, 24
PROMPTS = [[5, 9, 13, 17, 21], [7, 3, 11], [30, 31, 32, 33, 34, 35, 36]]
MAX_NEW = 4
STEPS = 3


def model_parallel(world: int) -> int:
    return 2 if world == 2 else 4


def inputs(cfg, seed: int = 1):
    """The tokens [B, T_LEN + 1] and the family's extra input, from a
    seeded numpy generator (the test makes the same)."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T_LEN + 1)))
    spec = T.extra_input(cfg)
    extra = {}
    if spec is not None:
        extra[spec[0]] = torch.from_numpy(
            0.1 * rng.standard_normal((B,) + spec[1])).float()
    return toks, extra


def _np(x):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().numpy()


def _tree_np(tree):
    return tree_map(lambda x: _np(x) if isinstance(x, torch.Tensor) else x,
                    tree)


def _run(arch: str, world_sizes=(2, 8), mp=None):
    world = dist.get_world_size()
    if world not in world_sizes:
        return None
    mp = model_parallel(world) if mp is None else mp
    mesh = M.make_local_mesh(mp, device="cpu")
    out = {}
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    placed = SH.place_params(params, mesh)
    toks, extra = inputs(cfg)
    split = True                          # B divides every batch axis here

    def rows(x):
        return SH.local_rows(x, mesh, split)

    # the forward, the loss and every gradient
    leaves, spec = tree_flatten(placed)
    for p in leaves:
        p.requires_grad_(True)
    lex = {k: rows(v) for k, v in extra.items()}
    with SH.activate(mesh, batch_sharded=split):
        logits, aux = T.forward(placed, cfg, rows(toks[:, :-1]), lex)
        out["logits"] = _np(L.batch_gather(logits.detach(), 0))
        out["aux"] = float(aux)
        loss, metrics = T.loss_fn(placed, cfg,
                                  {"tokens": rows(toks), **lex})
        grads = torch.autograd.grad(loss, leaves)
    out["loss"] = float(loss)
    out["ce"] = float(metrics["ce"].detach())
    out["grads"] = [_np(g) for g in grads]
    for p in leaves:
        p.requires_grad_(False)

    # a float32 prefill and two decode steps, the caches joined whole
    prompt = toks[:, :8]
    with SH.activate(mesh, batch_sharded=split), torch.no_grad():
        view = T.compute_view(placed, cfg)
        plog, caches = T.prefill(view, cfg, rows(prompt), lex,
                                 cache_dtype=torch.float32, max_seq=MAX_SEQ)
        steps = [_np(L.batch_gather(plog, 0))]
        for i in range(2):
            dlog, caches = T.decode_step(view, cfg, caches,
                                         rows(toks[:, 8 + i]))
            steps.append(_np(L.batch_gather(dlog, 0)))
    layout = S._CacheLayout(cfg, mesh, B, MAX_SEQ, torch.float32)
    stored = layout.store(caches)
    out["decode_logits"] = steps
    out["caches"] = _tree_np({"segments": stored["segments"],
                              "tail": stored["tail"]})
    out["cache_placements"] = [
        str(x.placements) for x in tree_flatten(stored)[0]
        if hasattr(x, "placements")]

    # a short Server run (three prompts: a wave the batch axes need not
    # divide), greedy
    srv = S.Server(arch, max_batch=4, max_seq=32, model_parallel=mp,
                   device="cpu")
    for i, p in enumerate(PROMPTS):
        srv.submit(S.Request(rid=i, prompt=p, max_new=MAX_NEW))
    out["tokens"] = {r.rid: r.out for r in srv.run()}

    # the trainer: 3 steps saving at 2 and 3, then a restart to step 4
    ck = Path(sys.argv[5]) / f"ck_{arch}_mp{mp}"
    out["losses"] = TR.run(arch, steps=STEPS, batch=B, seq=T_LEN,
                           ckpt_dir=str(ck), ckpt_every=2, log_every=100,
                           model_parallel=mp, device="cpu")
    out["restart_losses"] = TR.run(arch, steps=STEPS + 1, batch=B,
                                   seq=T_LEN, ckpt_dir=str(ck),
                                   ckpt_every=2, log_every=100,
                                   model_parallel=mp, device="cpu")

    # a placed save: every rank joins the leaves, rank 0 writes them
    save_dir = Path(sys.argv[5]) / f"save_{arch}_mp{mp}"
    mgr = CheckpointManager(save_dir)
    mgr.save(1, {"params": placed})
    mgr.wait()
    out["saved"] = _tree_np(placed)
    out["save_dir"] = str(save_dir)
    # and restored on the mesh: each rank's blocks of the whole leaves
    back = mgr.restore(1, {"params": params},
                       shardings={"params": SH.param_shardings(params,
                                                               mesh)})
    out["restored_equal"] = all(
        torch.equal(a.to_local(), b.to_local())
        for a, b in zip(tree_flatten(back["params"])[0], leaves))
    out["mesh"] = dict(mesh.shape)
    return {"global": out}


def case_qwen2(_):
    return _run("qwen2-0.5b")


def case_qwen2_data(_):
    """qwen2 on a 2 x 1 mesh: the batch split over "data", every weight
    whole on "model" (FSDP alone)."""
    return _run("qwen2-0.5b", (2,), mp=1)


def case_qwen2_jax_weights(_):
    """qwen2's forward on the mesh from the JAX package's weights (the test
    writes them), for the direct comparison at D = 2."""
    if dist.get_world_size() != 2:
        return None
    arrays = torch.load(Path(sys.argv[5]) / "jax_qwen2.pt",
                        weights_only=False)
    cfg = reduced(get_config("qwen2-0.5b"))
    mesh = M.make_local_mesh(2, device="cpu")
    placed = SH.place_params(load_lm_params(cfg, arrays, "cpu"), mesh)
    toks, _ = inputs(cfg)
    with SH.activate(mesh, batch_sharded=True), torch.no_grad():
        logits, _ = T.forward(placed, cfg, toks[:, :-1])
    return {"global": {"logits": _np(logits)}}


def rollback_run(ck: Path, mp: int = 1):
    """qwen2 trained 4 steps saving every 2, its loss made NaN at the
    third call (step 3): the trainer rolls back to step 2 with the LR
    halved and trains on (the test runs it on one device too)."""
    from unittest import mock
    real, calls = T.loss_fn, []

    def nan_at(params, cfg, batch):
        loss, metrics = real(params, cfg, batch)
        calls.append(1)
        if len(calls) == 3:
            loss = loss + float("nan")
        return loss, metrics

    with mock.patch.object(T, "loss_fn", nan_at):
        return TR.run("qwen2-0.5b", steps=4, batch=B, seq=T_LEN,
                      ckpt_dir=str(ck), ckpt_every=2, log_every=100,
                      model_parallel=mp, device="cpu")


def case_qwen2_rollback(_):
    if dist.get_world_size() != 2:
        return None
    return {"global": {"losses": rollback_run(
        Path(sys.argv[5]) / "rollback", mp=2)}}


def case_granite(_):
    return _run("granite-moe-1b-a400m")


def case_mixtral(_):
    return _run(MIXTRAL_FFN)


def case_qwen2_h3(_):
    return _run(QWEN2_WHOLE_HEADS, (2,))


def case_mamba2(_):
    return _run("mamba2-2.7b", (2,))


def case_zamba2(_):
    return _run("zamba2-7b", (2,))


def case_whisper(_):
    return _run("whisper-tiny", (2,))


def case_paligemma(_):
    return _run("paligemma-3b", (2,))
