"""Model configuration system + architecture registry (a copy of
``repro.configs.base``: the same fields, ``reduced()``, ``param_count()``,
registry and ``SHAPES``).

One config file per architecture lives next to this module; each exposes
``CONFIG``.  ``reduced()`` produces a smoke-scale config of the same
family for CPU tests (few layers, tiny widths, few experts).  The port
trains the ``dense`` family; the other families' configs are here so that
the registry is whole.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # block pattern, cycled over the depth; tokens:
    #   attn | attn_local | ssd | rglru
    layer_pattern: tuple = ("attn",)
    window: int = 0             # local-attention window (attn_local)
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    mlp_act: str = "silu"       # silu | gelu | relu2 (squared ReLU)
    glu: bool = True            # gated MLP (SwiGLU/GeGLU) vs plain 2-layer
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    # --- RG-LRU (recurrentgemma) ---
    rnn_width: int = 0
    rnn_conv: int = 4
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_ratio: int = 4          # encoder length = seq_len // enc_ratio
    # --- VLM stub frontend ---
    vision_tokens: int = 0
    # --- numerics / runtime ---
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    fsdp: bool = False          # additionally shard weights over the data axis
    # parallelism strategy: "tp" = tensor-parallel over the model axis
    # (+fsdp flag); "fsdp" = no tensor parallelism, the model axis becomes a
    # second data axis and every weight's d_model dim shards over
    # (data, model) — the right choice for small-dense models where TP
    # all-reduces dominate (§Perf hillclimb A2).
    strategy: str = "tp"
    # decode-time 2D sharding: replicate the (small) decode batch, shard the
    # KV cache sequence dim over (data, model) and keep weights ZeRO-sharded;
    # projections become contraction-partials with tiny psums instead of
    # per-layer weight gathers (flash-decoding-style split-KV; §Perf C2).
    serve_2d: bool = False
    # MoE dispatch locality: per-row dispatch keeps the routing sort/scatter
    # inside each data shard (§Perf hillclimb B2)
    moe_per_row_dispatch: bool = False
    # pin activation sharding (batch over DP axes, d_model replicated) at
    # block boundaries so GSPMD cannot defer TP psums past token-expanding
    # ops (§Perf hillclimb B3)
    constrain_activations: bool = False
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    loss_token_block: int = 131072  # §Perf A4: coarse seq-chunks

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def d_inner(self) -> int:  # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.pattern_period

    @property
    def n_tail_layers(self) -> int:
        return self.n_layers % self.pattern_period

    def supports_long_context(self) -> bool:
        """True iff every layer is sub-quadratic (no full-attention layer)."""
        return all(k in ("ssd", "rglru", "attn_local") for k in self.layer_pattern)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        per_layer = 0
        counts = {}
        for kind in self.layer_pattern:
            if kind in ("attn", "attn_local"):
                qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                out = self.n_heads * self.d_head * d
                counts[kind] = qkv + out
            elif kind == "ssd":
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                counts[kind] = d * (2 * di + 2 * N + H) + di * d + di * self.ssm_conv
            elif kind == "rglru":
                w = self.rnn_width
                counts[kind] = d * w * 3 + w * d + 2 * w * w // w * w  # in/gate/out + lru gates
        mlp = 0
        if self.d_ff:
            mlp = d * f * (3 if self.glu else 2)
        moe = 0
        if self.n_experts:
            fe = self.d_ff_expert
            moe = self.n_experts * d * fe * (3 if self.glu else 2) + d * self.n_experts
            moe += self.n_shared_experts * d * fe * (3 if self.glu else 2)
        total = 0
        for i in range(self.n_layers):
            kind = self.layer_pattern[i % self.pattern_period]
            total += counts.get(kind, 0)
            if kind in ("attn", "attn_local") or kind == "rglru":
                total += moe if self.n_experts else mlp
        if self.enc_layers:
            enc_attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head + self.n_heads * self.d_head * d
            total += self.enc_layers * (enc_attn + mlp)
            total += self.n_layers * enc_attn  # cross attention
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k + shared experts)."""
        if not self.n_experts:
            return self.param_count()
        fe = self.d_ff_expert
        d = self.d_model
        per_tok_moe = (self.top_k + self.n_shared_experts) * d * fe * (3 if self.glu else 2)
        all_moe = self.n_experts * d * fe * (3 if self.glu else 2)
        n_moe_layers = self.n_layers
        return self.param_count() - n_moe_layers * (all_moe - per_tok_moe)

    def reduced(self) -> "ModelConfig":
        """Smoke-scale config of the same family for CPU tests."""
        period = self.pattern_period
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2 * period, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            window=min(self.window, 32) if self.window else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_ff_expert=64 if self.d_ff_expert else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 256,
            rnn_width=64 if self.rnn_width else 0,
            enc_layers=2 if self.enc_layers else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            vocab_pad_multiple=64,
            dtype="float32",
            attn_q_block=16,
            attn_kv_block=32,
            loss_token_block=256,
        )


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------

ARCH_IDS = [
    "mamba2-370m",
    "phi-3-vision-4.2b",
    "recurrentgemma-2b",
    "qwen3-moe-235b-a22b",
    "qwen2-moe-a2.7b",
    "whisper-small",
    "granite-20b",
    "command-r-plus-104b",
    "gemma2-2b",
    "nemotron-4-15b",
]

_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "whisper-small": "whisper_small",
    "granite-20b": "granite_20b",
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma2-2b": "gemma2_2b",
    "nemotron-4-15b": "nemotron4_15b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


# ----------------------------------------------------------------------------
# Input shapes assigned to the LM family (all 10 archs share these)
# ----------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}
