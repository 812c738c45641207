"""whisper-small [audio]: 12L enc + 12L dec, d=768 12H (MHA) d_ff=3072
vocab 51865.  Encoder-decoder; the conv audio frontend is a STUB —
input_specs() provides precomputed frame embeddings (B, seq/4, d).
Plain (non-GLU) GELU MLP, tied embeddings.  [arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12, n_kv_heads=12, d_head=64,
    d_ff=3072,
    vocab_size=51865,
    layer_pattern=("attn",),
    mlp_act="gelu",
    glu=False,
    enc_layers=12,
    enc_ratio=4,
    tie_embeddings=True,
)
