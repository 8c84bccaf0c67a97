"""whisper-tiny [audio]: 4L enc + 4L dec, d=384, 6H, ff=1536, vocab=51865.
Conv audio frontend is a STUB: input_specs() feeds precomputed frame
embeddings [B, 1500, 384].  LayerNorm + GELU, non-gated MLP.
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, enc_seq=1500,
    d_model=384, n_heads=6, n_kv=6, head_dim=64,
    d_ff=1536, vocab=51865,
    norm="layernorm", activation="gelu", gated_mlp=False,
    notes="enc-dec; conv frontend stubbed to frame embeddings",
)
