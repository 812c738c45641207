"""phi-3-vision-4.2b [vlm]: phi3-mini backbone, 32L d=3072 32H (MHA kv=32)
d_ff=8192 vocab 32064 + CLIP frontend STUB (input_specs provides 256
precomputed patch embeddings per image).  [hf:microsoft/Phi-3-vision-128k-instruct]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192,
    vocab_size=32064,
    layer_pattern=("attn",),
    mlp_act="silu",
    vision_tokens=256,
)
