"""mamba2-370m [ssm]: 48L d_model=1024, attention-free SSD (state-space
duality), ssm_state=128, vocab 50280.  [arXiv:2405.21060]
No MLP (d_ff=0): the block is norm -> SSD -> residual.  long_500k RUNS
(O(1) recurrent decode state)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1, n_kv_heads=1, d_head=64,   # unused (attention-free)
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssd",),
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    tie_embeddings=True,
)
