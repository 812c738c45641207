"""gemma2-2b [dense]: 26L d=2304 8H (GQA kv=4, d_head=256) d_ff=9216
vocab 256000; alternating local(4096)/global attention, attention logit
softcap 50, final logit softcap 30, GeGLU.  [arXiv:2408.00118]
long_500k SKIPPED: the global layers are full attention."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=("attn_local", "attn"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    mlp_act="gelu",
    tie_embeddings=True,
)
