"""The LM stack over a (data, model) mesh of gloo ranks -- not a test module.

D = 2 runs every family on a 1 x 2 mesh (with a qwen2 whose 3 heads run
whole; and qwen2 on a 2 x 1 mesh), D = 8 qwen2, granite-moe and the
reduced mixtral on a 2 x 4 one (the batch split over "data", the
sequence-split cache, "ffn" experts).  Each case returns what the mesh
computed, joined whole on every rank ("global"): the forward's logits
and aux, the loss and every gradient, a float32 prefill and two decode
steps with their caches, a short ``Server`` run's tokens, the trainer's
losses (a restart from its own checkpoint included) and a placed save.
Two cases more at both world sizes: the MoE block alone, routed by each
rank's own groups or by the gather route (``case_moe_routing``), and the
decode over a cache sequence split on "model" or on the batch axes
(``case_split_decode``).  ``test_torch_lm_parallel.py`` holds them to the
single-device port.  No JAX here.
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

    # a float32 prefill and two decode steps, the caches stored between
    # them as the server stores them (a decode attends over its block)
    prompt = toks[:, :8]
    layout = S._CacheLayout(cfg, mesh, B, MAX_SEQ, torch.float32)
    with SH.activate(mesh, batch_sharded=split), torch.no_grad():
        view = T.compute_view(placed, cfg)
        plog, caches = T.prefill(view, cfg, rows(prompt), lex,
                                 cache_dtype=torch.float32, max_seq=MAX_SEQ)
        steps = [_np(L.batch_gather(plog, 0))]
        stored = layout.store(caches, joined=True)
        for i in range(2):
            dlog, caches = T.decode_step(view, cfg, layout.load(stored),
                                         rows(toks[:, 8 + i]))
            stored = layout.store(caches)
            steps.append(_np(L.batch_gather(dlog, 0)))
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


# ---------------------------------------------------------------------------
# the MoE's routing on the mesh (each rank routes its own groups where its
# rows are whole groups) and the decode over a split cache sequence
# ---------------------------------------------------------------------------

# the MoE module at the reduced width, with drops (capacity factor 1.25):
# groups of 16 tokens fall whole on the batch ranks ("local"); groups of
# 64 (the whole batch) do not, and take the gather route ("gather")
MOE_ARCHS = ("granite-moe-1b-a400m", MIXTRAL_FFN)
MOE_GROUPS = {"local": 16, "gather": 64}


def moe_config(arch: str, group: int):
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              moe_capacity_factor=1.25,
                              moe_group_size=group)
    return TT._moe_cfg(cfg)


def moe_inputs(mcfg, seed: int = 2):
    """(params, x [B, T_LEN, d], c [B, T_LEN, d]) from seeded generators:
    the loss is sum(y * c) + aux."""
    from repro_torch.models import moe as MO
    params = MO.moe_init(torch.Generator().manual_seed(seed), mcfg)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (B, T_LEN, mcfg.d_model))).float()
    c = torch.from_numpy(rng.standard_normal(
        (B, T_LEN, mcfg.d_model))).float()
    return params, x, c


def moe_routes():
    """A recorder of ``moe_route``'s results: (expert_idx, place, keep) of
    each call, with the number of groups it routed."""
    from repro_torch.models import moe as MO
    real, seen = MO.moe_route, []

    def record(p, cfg, xg, cap, n_ranks=1):
        out = real(p, cfg, xg, cap, n_ranks)
        seen.append(out[:3])
        return out
    return record, seen


def case_moe_routing(_):
    """The MoE block alone on a 2 x 1 mesh (D = 2) and a 2 x 4 one (D =
    8), for "expert" (granite) and "ffn" (mixtral, 3 experts) sharding:
    the routing joined over the batch ranks, y, aux and the gradients of
    x and of every weight."""
    from unittest import mock
    from repro_torch.models import moe as MO
    world = dist.get_world_size()
    mesh = M.make_local_mesh(1 if world == 2 else 4, device="cpu")
    out = {}
    for arch in MOE_ARCHS:
        for route, group in MOE_GROUPS.items():
            mcfg = moe_config(arch, group)
            params, x, c = moe_inputs(mcfg)
            placed = SH.place_params({"moe": params}, mesh)
            leaves = tree_flatten(placed)[0]
            for p in leaves:
                p.requires_grad_(True)
            xl = SH.local_rows(x, mesh, True).clone().requires_grad_(True)
            record, seen = moe_routes()
            with SH.activate(mesh, batch_sharded=True), \
                    mock.patch.object(MO, "moe_route", record):
                view = T.compute_view(placed, reduced(get_config(arch)))
                y, aux = MO.moe_apply(view["moe"], mcfg, xl)
                loss = L.batch_reduce((y * SH.local_rows(c, mesh, True))
                                      .sum()) + aux
                grads = torch.autograd.grad(loss, [xl] + leaves)
                idx, place, keep = seen[0]
                routed = idx.shape[0]
                gs = MO.group_and_capacity(mcfg, B * T_LEN)[0]
                if routed < B * T_LEN // gs:      # this rank's groups
                    idx, place, keep = (L.batch_gather(t, 0)
                                        for t in (idx, place, keep))
                gx = L.batch_gather(grads[0], 0)
                out[f"{arch}/{route}"] = {
                    "y": _np(L.batch_gather(y.detach(), 0)),
                    "aux": float(aux), "loss": float(loss),
                    "groups_routed": routed,
                    "expert_idx": idx.numpy(), "place": place.numpy(),
                    "keep": keep.numpy(), "grad_x": _np(gx),
                    "grads": [_np(g) for g in grads[1:]]}
    return {"global": out}


# the decode over a split cache sequence: (arch, mesh (data, model) at D
# = 2 and at D = 8, batch, prompt length, max_seq, decode steps)
QWEN2_KV1 = "qwen2-0.5b-kv1"          # 4 query heads over 1 KV head
CFG.ARCHS.setdefault(QWEN2_KV1, dataclasses.replace(
    get_config("qwen2-0.5b"), name=QWEN2_KV1, n_kv=1))
GEMMA3_KV1 = "gemma3-12b-kv1"         # its ring caches split at D = 2
CFG.ARCHS.setdefault(GEMMA3_KV1, dataclasses.replace(
    get_config("gemma3-12b"), name=GEMMA3_KV1, n_kv=1))
SPLIT_DECODE = {
    2: {"model": (QWEN2_KV1, (1, 2), 4, 8, 24, 3),
        "ring": (GEMMA3_KV1, (1, 2), 2, 28, 64, 6),
        "batch1": ("qwen2-0.5b", (2, 1), 1, 8, 24, 3),
        "empty": (QWEN2_KV1, (1, 2), 4, 2, 64, 2)},
    8: {"model": ("qwen2-0.5b", (2, 4), 4, 8, 24, 3),
        "ring": ("gemma3-12b", (2, 4), 4, 28, 64, 6),
        "batch1": ("qwen2-0.5b", (2, 4), 1, 8, 24, 3),
        "empty": ("qwen2-0.5b", (2, 4), 4, 2, 64, 2)},
}
# a server's wave whose decode wraps the ring (28 + 6 past 32 slots)
RING_PROMPTS = [list(range(3, 31)), list(range(40, 66))]


def split_decode_tokens(arch: str, prompt: int, batch: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(
        3, reduced(get_config(arch)).vocab, (batch, prompt + 8)))


def case_split_decode(_):
    """Each ``SPLIT_DECODE`` scenario of this world size: a float32 prefill
    stored in ``cache_shardings``' layout, then decode steps through the
    layout (each rank attending over its block of the sequence), the
    logits and the stored caches joined whole; the cache placements; and
    a ``Server`` run's greedy tokens (the ring's wave wraps it)."""
    world = dist.get_world_size()
    out = {}
    for name, (arch, shape, b, prompt, max_seq, n) in \
            SPLIT_DECODE[world].items():
        mesh = M.make_mesh(shape, ("data", "model"), device="cpu")
        cfg = reduced(get_config(arch))
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        placed = SH.place_params(params, mesh)
        toks = split_decode_tokens(arch, prompt, b)
        split = b % mesh.size("batch") == 0

        def rows(x):
            return SH.local_rows(x, mesh, split)
        layout = S._CacheLayout(cfg, mesh, b, max_seq, torch.float32)
        with SH.activate(mesh, batch_sharded=split), torch.no_grad():
            view = T.compute_view(placed, cfg)
            plog, caches = T.prefill(view, cfg, rows(toks[:, :prompt]),
                                     cache_dtype=torch.float32,
                                     max_seq=max_seq)
            logits = [plog]
            stored = layout.store(caches, joined=True)
            blocks = []
            for i in range(n):
                local = layout.load(stored)
                blocks.append([tuple(x.shape) for x in tree_flatten(
                    local)[0] if isinstance(x, torch.Tensor)])
                dlog, local = T.decode_step(view, cfg, local,
                                            rows(toks[:, prompt + i]))
                stored = layout.store(local)
                logits.append(dlog)
            if split:
                logits = [L.batch_gather(x, 0) for x in logits]
        srv = S.Server(arch, max_batch=4, max_seq=max_seq,
                       model_parallel=shape[1], device="cpu")
        prompts = (RING_PROMPTS if name == "ring" else
                   [toks[r, :prompt].tolist() for r in range(b)])
        for i, p in enumerate(prompts):
            srv.submit(S.Request(rid=i, prompt=p, max_new=6))
        out[name] = {
            "logits": [_np(x) for x in logits],
            "caches": _tree_np({"segments": stored["segments"],
                                "tail": stored["tail"]}),
            "placements": [str(x.placements) for x in tree_flatten(stored)[0]
                           if hasattr(x, "placements")],
            "blocks": blocks[0],
            "tokens": {r.rid: r.out for r in srv.run()}}
    return {"global": out}
