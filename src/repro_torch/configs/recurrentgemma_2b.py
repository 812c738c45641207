"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1) d_ff=7680
vocab 256000; RG-LRU x2 : local-attention(2048) x1 pattern.  [arXiv:2402.19427]
26 = 8 full periods + 2 tail layers (rglru, rglru) — handled by the
scan-plus-tail layout.  long_500k RUNS (recurrent state + windowed cache)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "attn_local"),
    window=2048,
    rnn_width=2560,
    rnn_conv=4,
    mlp_act="gelu",
    tie_embeddings=True,
)
