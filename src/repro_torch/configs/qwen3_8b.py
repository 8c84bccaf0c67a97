"""qwen3-8b [dense]: 36L, d=4096, 32H GQA kv=8, head_dim=128, ff=12288,
vocab=151936.  RMSNorm, SwiGLU, qk-norm.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=12288, vocab=151936,
    qk_norm=True, rope_theta=1000000.0,
    microbatches=8,
)
