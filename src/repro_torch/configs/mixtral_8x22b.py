"""mixtral-8x22b [moe]: 56L, d=6144, 48H GQA kv=8, 8 experts top-2 with
per-expert ff=16384, vocab=32768, sliding-window attention.  8 experts
don't divide the 16-way model axis -> tensor-parallel inside experts
(expert_sharding='ffn').  [arXiv:2401.04088]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, expert_sharding="ffn",
    window=4096, rope_theta=1000000.0,
    microbatches=16,
)
