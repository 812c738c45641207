"""command-r-plus-104b [dense]: 64L d=12288 96H (GQA kv=8) d_ff=33792
vocab 256000, no biases, SwiGLU.  [hf:CohereForAI/c4ai-command-r-plus]
FSDP on (104B params).  (The parallel attn+MLP block layout of the
original is implemented sequentially; noted in DESIGN.md.)"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96, n_kv_heads=8, d_head=128,
    d_ff=33792,
    vocab_size=256000,
    layer_pattern=("attn",),
    mlp_act="silu",
    fsdp=True,
    serve_2d=True,   # §Perf C2: split-KV decode, 7.8x fewer collectives
)
