"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H (MHA kv=16) vocab 151936,
MoE 60 routed top-4 + 4 shared experts, expert d_ff=1408.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=0,
    vocab_size=151936,
    layer_pattern=("attn",),
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    d_ff_expert=1408,
    mlp_act="silu",
)
