"""mamba2-2.7b [ssm]: 64L attention-free SSD blocks, d=2560,
ssm_state=128, vocab=50280.  [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_head=64, ssm_expand=2,
    notes="attention-free; decode is O(1)/token",
    microbatches=8,
)
