"""Architecture + shape configuration schema (a copy of
``repro/configs/base.py``, the port's own).

One `ArchConfig` describes any member of the assigned pool (dense / MoE /
SSM / hybrid / enc-dec / VLM).  `LayerProgram` describes the layer stacking
pattern (uniform, local:global interleave, shared-attention hybrid, ...) in a
scan-friendly grouped form: `repeats x segments + tail`, where each segment
is a (kind, count) pair whose params are stacked [repeats, count, ...].

Shapes: every arch is paired with the four assigned shape cells; `applicable`
encodes the briefed skips (encoder-only decode, full-attention long_500k).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "Segment", "LayerProgram", "SHAPES",
           "reduced", "full_groups", "depth_scaled"]


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str   # 'attn' | 'attn_local' | 'attn_global' | 'moe' | 'mamba'
    #           | 'shared_attn'
    n: int


@dataclasses.dataclass(frozen=True)
class LayerProgram:
    repeats: int
    segments: Tuple[Segment, ...]
    tail: Tuple[Segment, ...] = ()

    @property
    def total_layers(self) -> int:
        per = sum(s.n for s in self.segments)
        return self.repeats * per + sum(s.n for s in self.tail)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    norm: str = "rmsnorm"
    activation: str = "silu"
    gated_mlp: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False      # multiply embeddings by sqrt(d) (gemma)
    # attention pattern
    window: Optional[int] = None   # uniform sliding window (mixtral SWA)
    local_global: int = 0          # gemma3: N local layers per 1 global
    local_window: int = 1024
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_group_size: int = 1024
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "onehot"   # 'onehot' | 'gather' (see models/moe.py)
    expert_sharding: str = "expert"
    # ssm (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    # hybrid (zamba2): one shared attention block every `attn_every` blocks
    attn_every: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500            # audio frames after conv stub
    # vlm (paligemma)
    img_tokens: int = 0
    img_embed_dim: int = 0
    # numerics / compile
    microbatches: int = 1          # gradient-accumulation steps (train)
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"     # 'full' | 'dots' | 'none'
    logits_dtype: str = "float32"  # CE logits compute dtype ('bfloat16' cuts
    #                                head/CE HBM traffic ~2x; see §Perf)
    serve_replicate_weights: bool = False  # decode cells: skip TP, replicate
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))

    # ---- layer program ----------------------------------------------------
    def program(self) -> LayerProgram:
        if self.family == "ssm":
            return LayerProgram(1, (Segment("mamba", self.n_layers),))
        if self.family == "hybrid":
            k = self.attn_every
            groups, rem = divmod(self.n_layers, k + 1)
            segs = (Segment("mamba", k), Segment("shared_attn", 1))
            tail = (Segment("mamba", rem),) if rem else ()
            return LayerProgram(groups, segs, tail)
        if self.local_global > 0:
            lg = self.local_global
            groups, rem = divmod(self.n_layers, lg + 1)
            segs = (Segment("attn_local", lg), Segment("attn_global", 1))
            tail = (Segment("attn_local", rem),) if rem else ()
            return LayerProgram(groups, segs, tail)
        kind = "moe" if self.family == "moe" else "attn"
        return LayerProgram(1, (Segment(kind, self.n_layers),))

    # ---- shape-cell applicability (DESIGN.md §4 skips) ---------------------
    def applicable(self, shape: "ShapeConfig") -> Tuple[bool, str]:
        if shape.kind in ("decode", "long") and self.family == "encdec" \
                and self.n_layers == 0:
            return False, "encoder-only arch has no decode step"
        if shape.kind == "long":
            sub_quadratic = (
                self.family in ("ssm", "hybrid")
                or self.window is not None
                or self.local_global > 0)
            if not sub_quadratic:
                return False, ("pure full-attention arch: 500k decode "
                               "exceeds design assumptions (DESIGN.md §4)")
        return True, ""


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode' | 'long'


SHAPES: List[ShapeConfig] = [
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "long"),
]


def full_groups(cfg: ArchConfig) -> int:
    """Depth-extrapolation unit count of the full config (see dryrun)."""
    prog = cfg.program()
    if prog.repeats > 1:
        return prog.repeats
    return cfg.n_layers


def depth_scaled(cfg: ArchConfig, g: int) -> ArchConfig:
    """Same arch with g depth-groups (for roofline extrapolation):
    cost(g) is linear in g; full cost = cost at full_groups(cfg)."""
    prog = cfg.program()
    kw = {}
    if prog.repeats > 1:
        per = sum(s.n for s in prog.segments)
        tail = sum(s.n for s in prog.tail)
        kw["n_layers"] = per * g + tail
    else:
        kw["n_layers"] = g
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = g
    return dataclasses.replace(cfg, **kw)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=min(cfg.n_layers, 4) if cfg.family != "hybrid" else 7,
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv else 0,
        head_dim=32 if cfg.n_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        moe_group_size=64,
        moe_capacity_factor=8.0,   # dropless: smoke tests are deterministic

        ssm_state=min(cfg.ssm_state, 16),
        ssm_head=16 if cfg.ssm_state else 64,
        local_window=32 if cfg.local_global else cfg.local_window,
        window=min(cfg.window, 32) if cfg.window else None,
        attn_every=2 if cfg.family == "hybrid" else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=16 if cfg.n_enc_layers else cfg.enc_seq,
        img_tokens=8 if cfg.img_tokens else 0,
        img_embed_dim=64 if cfg.img_embed_dim else 0,
        dtype="float32",
        remat=False,
        local_global=cfg.local_global and 2,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
