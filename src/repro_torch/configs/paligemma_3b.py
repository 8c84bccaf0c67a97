"""paligemma-3b [vlm]: 18L gemma backbone, d=2048, 8H MQA kv=1,
head_dim=256, ff=16384, vocab=257216.  SigLIP vision tower is a STUB:
input_specs() feeds precomputed patch embeddings [B, 256, 1152]; a learned
projection maps them into the prefix.  Prefix-LM masking (image prefix
bidirectional, text causal).  [arXiv:2407.07726]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, head_dim=256,
    d_ff=16384, vocab=257216,
    activation="gelu_tanh", tie_embeddings=True,
    img_tokens=256, img_embed_dim=1152,
    microbatches=4,
)
