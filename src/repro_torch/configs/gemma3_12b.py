"""gemma3-12b [dense]: 48L, d=3840, 16H GQA kv=8, head_dim=256, ff=15360,
vocab=262144.  5:1 local:global attention (1024-token local window), GeGLU,
tied embeddings, 128k context.  [hf:google/gemma-3-*]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, head_dim=256,
    d_ff=15360, vocab=262144,
    activation="gelu_tanh", tie_embeddings=True, embed_scale=True,
    local_global=5, local_window=1024, rope_theta=1000000.0,
    microbatches=8,
)
