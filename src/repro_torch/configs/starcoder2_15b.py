"""starcoder2-15b [dense]: 40L, d=6144, 48H GQA kv=4, ff=24576,
vocab=49152.  LayerNorm, non-gated GELU MLP, attention+MLP bias, RoPE.
[arXiv:2402.19173]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv=4, head_dim=128,
    d_ff=24576, vocab=49152,
    norm="layernorm", activation="gelu", gated_mlp=False, qkv_bias=True,
    rope_theta=100000.0,
    microbatches=16,
)
