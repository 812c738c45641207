"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4) vocab 151936,
MoE 128 experts top-8, expert d_ff=1536, no dense MLP, no shared experts.
[hf:Qwen/Qwen3-235B-A22B family]  FSDP on (235B params)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=0,                       # every layer routes through the MoE
    vocab_size=151936,
    layer_pattern=("attn",),
    n_experts=128,
    n_shared_experts=0,
    top_k=8,
    d_ff_expert=1536,
    mlp_act="silu",
    fsdp=True,
    rope_theta=1000000.0,
)
