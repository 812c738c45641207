"""granite-20b [dense]: 52L d=6144 48H (MQA kv=1) d_ff=24576 vocab 49152,
gpt-bigcode-style plain GELU MLP (no GLU).  [arXiv:2405.04324]  FSDP on."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576,
    vocab_size=49152,
    layer_pattern=("attn",),
    mlp_act="gelu",
    glu=False,
    fsdp=True,
)
