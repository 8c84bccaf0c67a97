"""Model assembly for the LM families (dense, moe, ssm, hybrid, encdec
and vlm), the counterpart of ``repro/models/transformer.py``.

The layer stack follows the arch's ``LayerProgram`` (``configs/base.py``):
``repeats`` groups of segments plus a tail, each segment's layers stacked
``[n, ...]`` (``[R, n, ...]`` when grouped), exactly as the JAX parameter
tree has them, so that JAX weights carry over with one walk
(``repro_torch.convert.load_lm_params``).  Where the JAX package scans over
a stack, the port loops in Python over its layers, and each segment keeps
its own cache stack (ring caches for windowed layers, dense for global: the
paper's sparse-vs-dense representation choice applied to the KV "synapse
matrix").  Layer kinds: ``attn`` / ``attn_local`` / ``attn_global``
(attention and MLP), ``moe`` (attention and the MoE FFN, ``models/moe.py``),
``mamba`` (a Mamba2 block) and zamba2's ``shared_attn``: one unstacked
attention layer (``ln1``, ``attn``, ``ln2``, ``mlp``) applied at every
group, its weights shared, its caches one a group (``[R, ...]``, no ``n``
axis), and never rematerialised (as in the JAX package).

The encdec family (whisper) adds an encoder: ``params["enc"]`` holds its
layers stacked ``[n_enc_layers, ...]`` (``ln1``, ``attn``, ``ln2``,
``mlp``), a final ``norm`` and ``pos_embed`` ``[enc_seq, d]``.  It runs
non-causal, windowless self-attention with rope over ``extra["audio"]``
(frame embeddings ``[B, enc_seq, d]``: the conv front end is a stub, as
in the JAX package).  Each decoder layer adds ``ln_x`` and ``xattn``, a
non-causal cross-attention over the encoder's output projected by its own
``wk``/``wv``; its cache is ``{"self", "cross"}``, the cross cache
windowless at ``enc_seq`` slots, filled once by ``prefill``.

The vlm family (paligemma) puts an image prefix before the tokens:
``extra["img"]`` (patch embeddings ``[B, img_tokens, img_embed_dim]``:
the vision tower is a stub, as in the JAX package) projected by
``params["img_proj"]`` ``[img_embed_dim, d]``, unscaled, while the token
embeddings are scaled by sqrt(d).  Every attention layer runs the
prefix-LM mask (the image positions see each other both ways, the text
causally), positions run over ``img_tokens + T``, ``loss_fn`` drops the
image positions' logits, and ``prefill`` caches them (``index`` starts at
``img_tokens + T``); decode runs the plain causal step.

Entry points:
  init_params(cfg, generator)                      -> params
  forward(params, cfg, tokens, extra)              -> (logits, aux)
  loss_fn(params, cfg, batch)                      -> (loss, metrics)
  prefill(params, cfg, tokens, extra, max_seq=)    -> (last_logits, caches)
  decode_step(params, cfg, caches, token, index=)  -> (logits, caches)

``forward`` and ``loss_fn`` are differentiable (attention through the
``FlashAttention`` Function, Mamba2's SSD through ``SSDScan``); with
``cfg.remat`` each stacked layer is recomputed in the backward
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does in the JAX
package.  ``forward``'s aux is the sum of the MoE layers' load-balance
losses (0 for the other families) and ``loss_fn``'s loss is ``ce + aux``.

A cache tree is ``{"segments": [...], "tail": [...], "index": int}``; an
attention segment's entry holds ``k``/``v`` ``[(R,) n, B, S, n_kv, D]``,
``pos`` ``[(R,) n, S]`` and ``ring`` (a Python bool); a mamba segment's
``conv`` ``[(R,) n, B, d_conv - 1, conv_dim]`` and ``ssd`` ``[(R,) n, B, h,
ds, dh]``, both float32.  ``decode_step`` writes the new token's keys,
values and states into the caches in place and returns the same tensors
with ``index + 1``.

Under a mesh (``launch/sharding.py``'s ``activate``) the entry points take
placed params (DTensors, laid out by ``param_specs``) and this rank's
part of the batch; ``compute_view`` turns the params into the tensors
each module computes with (``layers.from_placed``: joined over the batch
axes, and over "model" where the module runs whole), the embedding is
looked up vocab-parallel (the JAX package's ``shard(x, "batch", None,
None)`` after a masked lookup summed over "model"), the head's logits are
this rank's vocab block (``shard(logits, "batch", None, "vocab")``),
which ``loss_fn``'s cross entropy reduces over "model" and the others
join, and the caches are in the layout the modules compute in (the
local KV heads, the local SSD heads).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.layers import (cross_entropy, dense_init, embed_init,
                                       mlp_apply, mlp_init, norm_apply,
                                       norm_init)

__all__ = ["init_params", "forward", "loss_fn", "prefill", "decode_step",
           "init_caches", "count_params", "model_flops_per_token",
           "padded_vocab", "resolve_dtype"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def resolve_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def padded_vocab(v: int, multiple: int = 256) -> int:
    """Vocab rounded up as the JAX package pads it (for even model-axis
    sharding there); sampling masks the pad entries to -inf."""
    return (v + multiple - 1) // multiple * multiple


# ---------------------------------------------------------------------------
# per-layer definitions
# ---------------------------------------------------------------------------

def _attn_cfg(cfg: ArchConfig, kind: str) -> A.AttnConfig:
    window = cfg.window
    if kind == "attn_local":
        window = cfg.local_window
    elif kind == "attn_global":
        window = None
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias, window=window,
        causal=True)


def _ssm_cfg(cfg: ArchConfig) -> S.SSMConfig:
    return S.SSMConfig(d_model=cfg.d_model, d_state=cfg.ssm_state,
                       d_head=cfg.ssm_head, expand=cfg.ssm_expand,
                       n_groups=cfg.ssm_groups)


def _moe_cfg(cfg: ArchConfig) -> M.MoEConfig:
    return M.MoEConfig(
        d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
        top_k=cfg.top_k, activation=cfg.activation,
        capacity_factor=cfg.moe_capacity_factor, dispatch=cfg.moe_dispatch,
        group_size=cfg.moe_group_size, expert_sharding=cfg.expert_sharding)


def _layer_init(cfg: ArchConfig, kind: str, gen: torch.Generator, dtype):
    d, dev = cfg.d_model, gen.device
    if kind == "mamba":
        return {"norm": norm_init(cfg.norm, d, dtype, dev),
                "ssm": S.ssm_init(gen, _ssm_cfg(cfg), dtype)}
    p = {"ln1": norm_init(cfg.norm, d, dtype, dev),
         "attn": A.attn_init(gen, _attn_cfg(cfg, kind), dtype),
         "ln2": norm_init(cfg.norm, d, dtype, dev)}
    if kind == "moe":
        p["moe"] = M.moe_init(gen, _moe_cfg(cfg), dtype)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.gated_mlp, dtype)
    if cfg.family == "encdec" and kind == "attn":
        p["ln_x"] = norm_init(cfg.norm, d, dtype, dev)
        p["xattn"] = A.attn_init(gen, _attn_cfg(cfg, "attn"), dtype)
    return p


def _enc_attn_cfg(cfg: ArchConfig) -> A.AttnConfig:
    """The encoder's self-attention: non-causal, windowless."""
    return dataclasses.replace(_attn_cfg(cfg, "attn"), causal=False,
                               window=None)


def _enc_layer_init(cfg: ArchConfig, gen: torch.Generator, dtype):
    d, dev = cfg.d_model, gen.device
    return {"ln1": norm_init(cfg.norm, d, dtype, dev),
            "attn": A.attn_init(gen, _enc_attn_cfg(cfg), dtype),
            "ln2": norm_init(cfg.norm, d, dtype, dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, cfg.gated_mlp, dtype)}


def _enc_kv(cfg: ArchConfig, p_x, enc_out: torch.Tensor):
    """The encoder's output [B, Ta, d] projected to one decoder layer's
    cross-attention (k, v) [B, Ta, n_kv, D]."""
    b, t, _ = enc_out.shape
    acfg = _attn_cfg(cfg, "attn")
    n_kv = A._cache_config(acfg).n_kv
    p_x = A.rank_blocks(p_x, acfg, A._heads_plan(acfg))
    if n_kv != cfg.n_kv:
        # this rank's KV heads (whole ones enter in attention_forward)
        enc_out = L.model_enter(enc_out)
    k = (enc_out @ p_x["wk"]).reshape(b, t, n_kv, cfg.head_dim)
    v = (enc_out @ p_x["wv"]).reshape(b, t, n_kv, cfg.head_dim)
    if cfg.qkv_bias:
        k = k + p_x["bk"].reshape(n_kv, cfg.head_dim)
        v = v + p_x["bv"].reshape(n_kv, cfg.head_dim)
    return k, v


def _layer_apply(cfg: ArchConfig, kind: str, p, x: torch.Tensor,
                 positions: torch.Tensor, want_cache: bool = False,
                 enc_out: Optional[torch.Tensor] = None,
                 prefix: Optional[int] = None):
    """Full-sequence layer: returns (x, aux, cache entry): aux the MoE
    load-balance loss (None for other kinds); with ``want_cache`` the
    attention layer's (k, v) (an encdec decoder layer's ((k, v), (kx,
    vx)), the cross-attention's beside it) or the mamba block's (conv,
    ssd) state, else None.  ``enc_out``: the encoder's output, which an
    encdec decoder layer cross-attends to; ``prefix``: the prefix-LM
    span of a vlm model's self-attention."""
    if kind == "mamba":
        h = norm_apply(cfg.norm, x, p["norm"])
        if want_cache:
            y, state = S.ssm_apply(p["ssm"], _ssm_cfg(cfg), h,
                                   return_state=True)
            return x + y, None, state
        return x + S.ssm_apply(p["ssm"], _ssm_cfg(cfg), h), None, None
    h = norm_apply(cfg.norm, x, p["ln1"])
    acfg = _attn_cfg(cfg, kind)
    y, kv = A.attention_forward(p["attn"], acfg, h, positions=positions,
                                return_kv=True, prefix=prefix)
    x = x + y
    if "xattn" in p:
        enc_kv = _enc_kv(cfg, p["xattn"], enc_out)
        h = norm_apply(cfg.norm, x, p["ln_x"])
        x = x + A.attention_forward(
            p["xattn"], dataclasses.replace(acfg, causal=False), h,
            kv=enc_kv)
        kv = (kv, enc_kv)
    h = norm_apply(cfg.norm, x, p["ln2"])
    aux = None
    if kind == "moe":
        y, aux = M.moe_apply(p["moe"], _moe_cfg(cfg), h)
    else:
        y = mlp_apply(p["mlp"], h, cfg.activation, cfg.d_ff)
    return x + y, aux, kv if want_cache else None


def _layer_decode(cfg: ArchConfig, kind: str, p, x: torch.Tensor, cache,
                  index: int) -> torch.Tensor:
    """One-token layer step (the cache is written in place)."""
    if kind == "mamba":
        y, new = S.ssm_decode_step(p["ssm"], _ssm_cfg(cfg),
                                   norm_apply(cfg.norm, x, p["norm"]), cache)
        cache["conv"].copy_(new["conv"])
        cache["ssd"].copy_(new["ssd"])
        return x + y
    acfg = _attn_cfg(cfg, kind)
    h = norm_apply(cfg.norm, x, p["ln1"])
    if "xattn" in p:
        y, _ = A.attention_decode(p["attn"], acfg, h, cache["self"], index)
        x = x + y
        h = norm_apply(cfg.norm, x, p["ln_x"])
        y, _ = A.attention_decode(p["xattn"], acfg, h, cache["cross"], index,
                                  cross=True)
    else:
        y, _ = A.attention_decode(p["attn"], acfg, h, cache, index)
    x = x + y
    h = norm_apply(cfg.norm, x, p["ln2"])
    if kind == "moe":
        y, _ = M.moe_apply(p["moe"], _moe_cfg(cfg), h)
    else:
        y = mlp_apply(p["mlp"], h, cfg.activation, cfg.d_ff)
    return x + y


# ---------------------------------------------------------------------------
# the stacked layout
# ---------------------------------------------------------------------------

def _layers(cfg: ArchConfig) -> Iterator[Tuple[str, str, int, tuple, tuple]]:
    """(kind, where, i, pidx, cidx) for every layer in execution order: the
    layer's params are ``_take(params[where][i], pidx)`` and its cache
    ``_take(caches[where][i], cidx)``.  The two differ only for
    ``shared_attn`` (kind ``"attn"`` here): its params are one unstacked
    tree (pidx ``()``), its caches one a group."""
    prog = cfg.program()
    grouped = prog.repeats > 1
    for r in range(prog.repeats):
        for i, seg in enumerate(prog.segments):
            if seg.kind == "shared_attn":
                yield "attn", "segments", i, (), (r,) if grouped else ()
                continue
            for l in range(seg.n):
                idx = (r, l) if grouped else (l,)
                yield seg.kind, "segments", i, idx, idx
    for i, seg in enumerate(prog.tail):
        for l in range(seg.n):
            yield seg.kind, "tail", i, (l,), (l,)


def _take(tree, idx: tuple):
    """One layer of a stacked tree: every tensor indexed by ``idx`` (views,
    so writes reach the stack); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    return tree


def _split(tree, n: int) -> List[Any]:
    """The n trees ``tree[l]``, made with one ``unbind`` per tensor.  Its
    gradient is one ``stack`` of the layers' gradients, where indexing
    the stack layer by layer would add a full-size gradient per layer."""
    if isinstance(tree, dict):
        parts = {k: _split(v, n) for k, v in tree.items()}
        return [{k: parts[k][l] for k in tree} for l in range(n)]
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree, 0))
    return [tree] * n


def _per_layer(params, cfg: ArchConfig) -> Dict[tuple, Any]:
    """(where, i, pidx) of ``_layers`` -> that layer's params, for a pass
    that differentiates them (``forward``).  A shared block's tree is used
    as it is at every application, so that its gradient sums over them."""
    prog = cfg.program()
    out: Dict[tuple, Any] = {}
    for where, segs in (("segments", prog.segments), ("tail", prog.tail)):
        grouped = where == "segments" and prog.repeats > 1
        for i, seg in enumerate(segs):
            if seg.kind == "shared_attn":
                out[(where, i, ())] = params[where][i]
                continue
            groups = (_split(params[where][i], prog.repeats) if grouped
                      else [params[where][i]])
            for r, tree in enumerate(groups):
                for l, layer in enumerate(_split(tree, seg.n)):
                    out[(where, i, (r, l) if grouped else (l,))] = layer
    return out


def _stack(trees: List[Any]):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random weights on ``gen``'s device, with the JAX initializers'
    distributions (embeddings N(0, 0.02^2), projections N(0, 1/fan_in),
    norm scales as the JAX package sets them, biases 0)."""
    dtype = resolve_dtype(cfg.dtype)
    prog = cfg.program()
    pv = padded_vocab(cfg.vocab)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, pv, cfg.d_model, dtype),
        "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, pv, dtype)

    def seg_init(seg):
        if seg.kind == "shared_attn":       # one tree, unstacked
            return _layer_init(cfg, "attn", gen, dtype)
        return _stack([_layer_init(cfg, seg.kind, gen, dtype)
                       for _ in range(seg.n)])

    params["segments"] = [
        _stack([seg_init(seg) for _ in range(prog.repeats)])
        if prog.repeats > 1 and seg.kind != "shared_attn" else seg_init(seg)
        for seg in prog.segments]
    params["tail"] = [seg_init(seg) for seg in prog.tail]
    if cfg.family == "vlm":
        params["img_proj"] = dense_init(gen, cfg.img_embed_dim, cfg.d_model,
                                        dtype)
    if cfg.family == "encdec":
        params["enc"] = {
            "layers": _stack([_enc_layer_init(cfg, gen, dtype)
                              for _ in range(cfg.n_enc_layers)]),
            "norm": norm_init(cfg.norm, cfg.d_model, dtype, gen.device),
            "pos_embed": embed_init(gen, cfg.enc_seq, cfg.d_model, dtype)}
    return params


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------

def _vocab_start(params, cfg: ArchConfig) -> Optional[int]:
    """The first vocab entry of this rank's block of the embedding (and
    tied head) rows / the head's columns under a mesh that splits the
    vocab, else None."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    if not L.parallel() or head.shape[0] == padded_vocab(cfg.vocab):
        return None
    return L.model_rank() * head.shape[0]


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embeddings, scaled by sqrt(d) for gemma-style configs
    and the vlm family."""
    table = params["embed"]
    if L.parallel() and table.shape[0] != padded_vocab(cfg.vocab):
        # vocab-parallel: each rank looks up the tokens of its rows, the
        # others' rows are zeros, and the sum over "model" is exact
        rows = table.shape[0]
        local = tokens - L.model_rank() * rows
        hit = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)] * hit[..., None].to(table.dtype)
        x = L.model_reduce(x)
    else:
        x = table[tokens]
    if cfg.embed_scale or cfg.family == "vlm":
        # the scale is rounded to the activations' dtype first, as JAX
        # rounds a Python scalar that multiplies an array
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _embed_inputs(params, cfg: ArchConfig, tokens: torch.Tensor,
                  extra) -> torch.Tensor:
    """The sequence the layers run over: the tokens' embeddings, after a
    vlm model's projected image prefix (``extra["img"]`` required)."""
    x = _embed(params, cfg, tokens)
    if cfg.family != "vlm":
        return x
    if not extra or "img" not in extra:
        raise ValueError(f"{cfg.name}: a vlm model needs extra['img'] "
                         "[B, img_tokens, img_embed_dim]")
    img = extra["img"].to(x.dtype) @ params["img_proj"]
    return torch.cat([img, x], dim=1)


def extra_input(cfg: ArchConfig) -> Optional[Tuple[str, tuple]]:
    """The input beside the tokens that the family needs, as (name, the
    shape of one row): an encdec model's audio frames, a vlm model's
    image; None for the others."""
    if cfg.family == "encdec":
        return "audio", (cfg.enc_seq, cfg.d_model)
    if cfg.family == "vlm":
        return "img", (cfg.img_tokens, cfg.img_embed_dim)
    return None


def _prefix(cfg: ArchConfig) -> Optional[int]:
    """The prefix-LM span of a vlm model's attention (its image), else
    None."""
    return cfg.img_tokens if cfg.family == "vlm" else None


def _logits(params, cfg: ArchConfig, x: torch.Tensor,
            mask_pad: bool = False, local: bool = False) -> torch.Tensor:
    """The head's logits; under a mesh that splits the vocab, this rank's
    block of them with ``local``, else joined over "model"."""
    x = norm_apply(cfg.norm, x, params["final_norm"])
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    start = _vocab_start(params, cfg)
    if start is not None:
        x = L.model_enter(x)
    logits = x @ head
    if cfg.logits_dtype == "bfloat16":
        logits = logits.to(torch.bfloat16)
    if mask_pad and padded_vocab(cfg.vocab) != cfg.vocab:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            + (start or 0) >= cfg.vocab
        logits = logits.masked_fill(pad, float("-inf"))
    if start is not None and not local:
        logits = L.model_gather(logits, -1)
    return logits


# every leaf's module under a mesh: the leaves matched by _WHOLE compute
# whole (the rule table splits whisper's pos_embed as an "embed" on its
# positions, and Mamba2's fused projection and conv on channels that are
# not heads), those by _HEADS_* and _SSM_HEADS on their "model" block only
# when the module's heads are split, the rest always on their block (the
# vocab, the ffn, the experts)
_WHOLE = re.compile(r"(pos_embed|ssm/(w_in|conv_w|conv_b))$")
_HEADS_Q = re.compile(r"(wq|bq|wo)$")
_HEADS_KV = re.compile(r"(wk|wv|bk|bv)$")
_SSM_HEADS = re.compile(r"ssm/")


def _keep_model(cfg: ArchConfig, path: str) -> bool:
    mp = L.model_size()
    if _WHOLE.search(path):
        return False
    if _SSM_HEADS.search(path):
        return _ssm_cfg(cfg).n_heads % mp == 0
    heads = bool(cfg.n_heads) and cfg.n_heads % mp == 0
    if _HEADS_KV.search(path):
        return heads and cfg.n_kv % mp == 0
    if _HEADS_Q.search(path):
        return heads
    return True


def compute_view(params, cfg: ArchConfig, path: str = ""):
    """The params as the modules compute with them under a mesh (placed
    leaves through ``layers.from_placed``), the tree itself without one."""
    if not L.parallel():
        return params
    if isinstance(params, dict):
        return {k: compute_view(v, cfg, f"{path}/{k}" if path else k)
                for k, v in params.items()}
    if isinstance(params, list):
        return [compute_view(v, cfg, f"{path}/{i}")
                for i, v in enumerate(params)]
    # the MoE's weights enter the rank's rows in moe_apply, where it
    # routes its own groups (a decode wave runs whole on every rank)
    return L.from_placed(params, _keep_model(cfg, path),
                         batch_specific="moe/" not in path)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

# the products without a batch dimension: what ``"dots"`` saves (a
# [B, T, d] @ W reaches ``mm``; attention's and the experts' batched
# products are ``bmm``)
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, body):
    """The configured activation-checkpoint policy around a layer body:
    ``"full"`` recomputes the layer in the backward
    (``torch.utils.checkpoint``, non-reentrant), ``"dots"`` saves the
    outputs of the matrix products that have no batch dimension (JAX's
    ``dots_with_no_batch_dims_saveable``: ``mm`` and ``addmm``, through
    selective-checkpoint contexts) and recomputes the rest (batched
    products, the flash and SSD ops, norms, elementwise ops), ``"none"``
    or ``cfg.remat`` False saves everything."""
    if not cfg.remat or cfg.remat_policy == "none":
        return body
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        return checkpoint(body, *args, use_reentrant=False, **kw)
    return run


def _encode(params, cfg: ArchConfig, audio: torch.Tensor) -> torch.Tensor:
    """The whisper encoder over frame embeddings [B, enc_seq, d] (any
    float dtype; cast to the model's) -> [B, enc_seq, d]: each layer
    rematerialised in the backward under ``cfg.remat``."""
    x = audio.to(resolve_dtype(cfg.dtype)) + params["enc"]["pos_embed"]
    acfg = _enc_attn_cfg(cfg)

    def body(h, p):
        h = h + A.attention_forward(p["attn"], acfg,
                                    norm_apply(cfg.norm, h, p["ln1"]))
        return h + mlp_apply(p["mlp"], norm_apply(cfg.norm, h, p["ln2"]),
                             cfg.activation, cfg.d_ff)

    run = _remat(cfg, body)
    for p in _split(params["enc"]["layers"], cfg.n_enc_layers):
        x = run(x, p)
    return norm_apply(cfg.norm, x, params["enc"]["norm"])


def _enc_out(params, cfg: ArchConfig, extra) -> Optional[torch.Tensor]:
    """The encoder's output for an encdec model (``extra["audio"]``
    required), else None."""
    if cfg.family != "encdec":
        return None
    if not extra or "audio" not in extra:
        raise ValueError(f"{cfg.name}: an encdec model needs "
                         "extra['audio'] [B, enc_seq, d_model]")
    return _encode(params, cfg, extra["audio"])


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, extra=None):
    """Logits over a full sequence: (logits [B, T, V], aux float32 scalar:
    the sum of the MoE layers' load-balance losses, 0 without any).
    ``extra``: ``{"audio": [B, enc_seq, d]}`` for an encdec model,
    ``{"img": [B, img_tokens, img_embed_dim]}`` for a vlm model, whose
    logits then cover ``img_tokens + T`` positions."""
    return _forward(compute_view(params, cfg), cfg, tokens, extra)


def _forward(params, cfg: ArchConfig, tokens: torch.Tensor, extra=None,
             local: bool = False):
    x = _embed_inputs(params, cfg, tokens, extra)
    enc_out = _enc_out(params, cfg, extra)
    positions = torch.arange(x.shape[1], device=x.device)
    prefix = _prefix(cfg)
    layers = _per_layer(params, cfg)
    shared = {i for i, seg in enumerate(cfg.program().segments)
              if seg.kind == "shared_attn"}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, where, i, pidx, _ in _layers(cfg):
        def body(h, p, e, kind=kind):
            h, aux, _ = _layer_apply(cfg, kind, p, h, positions, enc_out=e,
                                     prefix=prefix)
            return h, aux
        # the shared block is not rematerialised (as in the JAX package)
        run = body if where == "segments" and i in shared \
            else _remat(cfg, body)
        x, aux = run(x, layers[(where, i, pidx)], enc_out)
        if aux is not None:
            aux_total = aux_total + aux
    return _logits(params, cfg, x, local=local), aux_total


def loss_fn(params, cfg: ArchConfig, batch):
    """batch: {'tokens': [B, T+1] integer, 'audio' for an encdec model,
    'img' for a vlm model}: next-token cross entropy over the padded vocab
    with its pad entries masked (a vlm model's image positions give no
    loss), plus the MoE aux loss -> (loss, {'ce', 'aux'})."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    extra = {k: batch[k] for k in ("audio", "img") if k in batch}
    params = compute_view(params, cfg)
    logits, aux = _forward(params, cfg, inp, extra, local=True)
    if cfg.family == "vlm":
        logits = logits[:, cfg.img_tokens:]
    ce = cross_entropy(logits, labels, true_vocab=cfg.vocab,
                       vocab_start=_vocab_start(params, cfg))
    return ce + aux, {"ce": ce, "aux": aux}


def _layer_cache(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                 dtype, device):
    if kind == "mamba":               # float32 whatever ``dtype`` is
        return S.ssm_init_cache(_ssm_cfg(cfg), batch, device=device)
    acfg = _attn_cfg(cfg, kind)
    c = A.init_cache(acfg, batch, max_seq, dtype, device)
    if cfg.family == "encdec":
        cross = A.init_cache(dataclasses.replace(acfg, window=None), batch,
                             cfg.enc_seq, dtype, device)
        return {"self": c, "cross": cross}
    return c


def _expand(tree, lead: tuple):
    """Every tensor of a cache tree broadcast to ``lead + shape`` (a copy);
    other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _expand(v, lead) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.expand(lead + tuple(tree.shape)).clone()
    return tree


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device=None):
    """Empty caches in the layer program's structure (``index`` 0): a
    segment's caches ``[n, ...]`` (``[R, n, ...]`` grouped), a shared
    block's one a group (``[R, ...]``)."""
    prog = cfg.program()

    def seg_cache(seg, reps: tuple):
        c = _layer_cache(cfg, seg.kind, batch, max_seq, dtype, device)
        lead = reps + (() if seg.kind == "shared_attn" else (seg.n,))
        return _expand(c, lead)

    grouped = (prog.repeats,) if prog.repeats > 1 else ()
    return {
        "segments": [seg_cache(s, grouped) for s in prog.segments],
        "tail": [seg_cache(s, ()) for s in prog.tail],
        "index": 0,
    }


def _write_prefill_caches(cfg: ArchConfig, caches, states: List[Any]):
    """Write each layer's prompt state (``states``, in layer order) into
    its cache, in place: an attention layer's (k, v) by ``fill_cache`` (a
    ring keeps the last positions; an encdec layer's cross cache takes the
    encoder's (kx, vx)), a mamba block's conv history (cast to the cache's
    float32) and SSD state."""
    for (kind, where, i, _, cidx), st in zip(_layers(cfg), states):
        cache = _take(caches[where][i], cidx)
        if kind == "mamba":
            conv, ssd = st
            cache["conv"].copy_(conv)
            cache["ssd"].copy_(ssd)
        elif "cross" in cache:
            A.fill_cache(cache["self"], *st[0], 0)
            A.fill_cache(cache["cross"], *st[1], 0)
        else:
            A.fill_cache(cache, *st, 0)
    return caches


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, extra=None,
            cache_dtype=torch.bfloat16, max_seq: Optional[int] = None):
    """Run the prompts [B, T] (and an encdec model's ``extra["audio"]``, a
    vlm model's ``extra["img"]`` before them): (last-token logits [B, V],
    caches).  The attention caches are bfloat16 by default whatever the
    weights' dtype, the mamba caches float32, as in the JAX package."""
    params = compute_view(params, cfg)
    x = _embed_inputs(params, cfg, tokens, extra)
    b, total_t = x.shape[:2]          # a vlm model's image positions too
    max_seq = max(max_seq or total_t, total_t)
    enc_out = _enc_out(params, cfg, extra)
    positions = torch.arange(total_t, device=x.device)
    states = []
    for kind, where, i, pidx, _ in _layers(cfg):
        x, _, st = _layer_apply(cfg, kind, _take(params[where][i], pidx), x,
                                positions, want_cache=True, enc_out=enc_out,
                                prefix=_prefix(cfg))
        states.append(st)
    caches = init_caches(cfg, b, max_seq, cache_dtype, x.device)
    _write_prefill_caches(cfg, caches, states)
    caches["index"] = total_t
    logits = _logits(params, cfg, x[:, -1:, :], mask_pad=True)
    return logits[:, 0], caches


def decode_step(params, cfg: ArchConfig, caches, token: torch.Tensor,
                index: Optional[int] = None):
    """token [B] -> (logits [B, V], caches): one step at position ``index``
    (default ``caches["index"]``); the caches are written in place.  An
    MoE layer routes the wave's B tokens as one group (its aux is
    dropped)."""
    index = caches["index"] if index is None else int(index)
    params = compute_view(params, cfg)
    x = _embed(params, cfg, token)[:, None, :]
    for kind, where, i, pidx, cidx in _layers(cfg):
        x = _layer_decode(cfg, kind, _take(params[where][i], pidx), x,
                          _take(caches[where][i], cidx), index)
    logits = _logits(params, cfg, x, mask_pad=True)[:, 0]
    return logits, {"segments": caches["segments"], "tail": caches["tail"],
                    "index": index + 1}


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return params.numel() if isinstance(params, torch.Tensor) else 0


def model_flops_per_token(cfg: ArchConfig, n_params: int,
                          n_active: Optional[int] = None) -> float:
    """Training FLOPs a token by the 6 N convention (N = the active
    parameters for MoE)."""
    return 6.0 * (n_active if n_active is not None else n_params)
