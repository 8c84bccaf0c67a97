"""zamba2-7b [hybrid]: Mamba2 backbone + one SHARED attention block applied
every 6th layer slot (weights reused, Zamba-style).  81 layer slots =
13 x (5 mamba + 1 shared-attn) + 3 mamba tail.  [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_head=64, ssm_expand=2, attn_every=5,
    notes="shared transformer block (Zamba2); ssm_state=64",
    microbatches=16,
)
