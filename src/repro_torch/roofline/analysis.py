"""Roofline analysis (``repro.roofline.analysis``) with the H100's
constants (DESIGN.md §9).

Terms (per card, NVIDIA H100 80GB HBM3 (SXM), 700 W; published peaks):
    compute    = FLOPs_dev / 989e12          [s]   dense bf16 tensor cores
    memory     = bytes_dev / 3.35e12         [s]   HBM3
    collective = collective_bytes_dev / 50e9 [s]

The collective term's rate is the per-card link that both production
meshes' axes of 16 cross: a (16, 16) or (2, 16, 16) mesh spans 8-card
nodes, and each card's traffic between nodes goes through its one
400 Gb/s NDR NIC, 50e9 B/s.  NVLink inside a node gives 450e9 B/s per
direction, but a ring over an axis that leaves the node runs at its
slowest link, the NIC; with latency and contention left out, the term
is a lower bound on the collectives' time.

What is ported: :class:`Roofline`, the analytic cost model
(:func:`analytic_cost`, ``_fwd_flops_per_token``, ``_cache_bytes_dev``,
:func:`model_flops`, :func:`dtype_size`, the reference's
``jnp_dtype_size``) with the same arithmetic in the same order, and the
ring wire-byte conventions of the reference's ``collective_stats`` as
:func:`wire_bytes` of (kind, result bytes, group size).  The reference's
HLO text parser and its loop weighting read XLA's per-device HLO; a
PyTorch program has none, and eager execution runs every loop
iteration, so the dry run counts each collective as it is issued
(``launch/dryrun.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 80GB HBM3 (SXM), 700 W
PEAK_FLOPS = 989e12          # bf16 FLOP/s a card, dense
HBM_BW = 3.35e12             # B/s a card
LINK_BW = 50e9               # B/s a card between nodes (one NDR NIC)

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, result_bytes: float, group_size: int) -> float:
    """Wire bytes a rank moves for one collective, from its RESULT size,
    by the standard ring-algorithm conventions (the reference's
    ``collective_stats``; EXPERIMENTS.md §Roofline):

      all-gather          ~ result * (W-1)/W        (result is the gathered buf)
      all-reduce          ~ 2 * result * (W-1)/W    (reduce-scatter + all-gather)
      reduce-scatter      ~ result * (W-1)          (operand = result * W)
      all-to-all          ~ result * (W-1)/W
      collective-permute  ~ result
    """
    nbytes = result_bytes
    w = max(group_size, 1)
    if kind == "all-gather":
        wire = nbytes * (w - 1) / w
    elif kind == "all-reduce":
        wire = 2 * nbytes * (w - 1) / w
    elif kind == "reduce-scatter":
        wire = nbytes * (w - 1)
    elif kind == "all-to-all":
        wire = nbytes * (w - 1) / w
    elif kind == "collective-permute":
        wire = nbytes
    else:
        raise ValueError(f"unknown collective {kind!r}")
    return wire


@dataclass
class Roofline:
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    model_flops_global: float = 0.0
    chips: int = 1

    @property
    def compute_s(self) -> float:
        return self.flops_dev / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time model: max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips * flops_dev): how much compiled compute
        is 'useful' — catches remat/redundancy waste."""
        total = self.chips * self.flops_dev
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achieved fraction of the compute roofline if the step runs at the
        modeled time: useful FLOPs / (chips * peak * step_time)."""
        denom = self.chips * PEAK_FLOPS * self.step_time_s
        return self.model_flops_global / denom if denom else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_dev": self.flops_dev,
            "bytes_dev": self.bytes_dev,
            "coll_bytes_dev": self.coll_bytes_dev,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


# ----------------------------------------------------------------------------
# Analytic, implementation-accurate cost model (the reference's): chunked
# attention computes the full (masked) S_kv per query block, remat re-runs
# each group's forward on the backward pass, MoE compute includes the
# capacity-factor padding.  The dry run records it beside the FLOPs it
# counts; the roofline's compute and memory terms are this model's.
# ----------------------------------------------------------------------------


def _fwd_flops_per_token(cfg, s_ctx: int, *, decode: bool) -> dict:
    """Forward FLOPs per token, by component, for ONE layer of each kind."""
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    out = {}
    # attention: qkv + out projections, then scores/values against s_ctx keys
    proj = 2 * d * dh * (H + 2 * K) + 2 * H * dh * d
    attn_mix = 4 * H * dh * s_ctx
    out["attn"] = proj + attn_mix
    out["attn_local"] = proj + 4 * H * dh * (min(cfg.window, s_ctx) if decode
                                             else s_ctx)  # train path scans all kv blocks (masked)
    if cfg.d_ff:
        out["mlp"] = (6 if cfg.glu else 4) * d * cfg.d_ff
    if cfg.n_experts:
        fe = cfg.d_ff_expert
        slots = cfg.top_k * (1.0 if decode else cfg.capacity_factor)
        moe = 2 * d * cfg.n_experts + slots * (6 if cfg.glu else 4) * d * fe
        moe += cfg.n_shared_experts * 6 * d * fe
        out["moe"] = moe
    if cfg.ssm_state:
        di, N, Hs, Ps = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
        Q = 1 if decode else cfg.ssm_chunk
        proj_s = 2 * d * (2 * di + 2 * N + Hs) + 2 * di * d
        conv = 2 * cfg.ssm_conv * (di + 2 * N)
        if decode:
            mix = 4 * Hs * N * Ps
        else:
            mix = 2 * Q * N + 3 * Q * Hs + 2 * Q * Hs * Ps + 4 * Hs * N * Ps
        out["ssd"] = proj_s + conv + mix
    if cfg.rnn_width:
        W = cfg.rnn_width
        out["rglru"] = 6 * d * W + 4 * W * W + 2 * cfg.rnn_conv * W + 12 * W
    return out


def analytic_cost(cfg, kind: str, seq_len: int, global_batch: int, *,
                  chips: int, model_shards: int, microbatches: int = 1,
                  param_bytes_dev: float = 0.0) -> dict:
    """(flops_dev, bytes_dev) of the compiled program, first-order model."""
    d, Vp = cfg.d_model, cfg.padded_vocab
    decode = kind == "decode"
    tokens_global = global_batch * (1 if decode else seq_len)
    tokens_dev = tokens_global / max(chips / model_shards, 1)
    s_ctx = seq_len  # decode: cache length; train/prefill: full sequence
    comp = _fwd_flops_per_token(cfg, s_ctx, decode=decode)

    per_tok = 0.0
    for i in range(cfg.n_layers):
        k = cfg.layer_pattern[i % cfg.pattern_period]
        per_tok += comp[k]
        if cfg.n_experts and k in ("attn", "attn_local"):
            per_tok += comp["moe"]
        elif cfg.d_ff and k in ("attn", "attn_local", "rglru"):
            per_tok += comp["mlp"]
    per_tok += 2 * d * Vp  # unembedding (loss / logits)
    if cfg.is_encdec and not decode:
        enc_tok_ratio = 1.0 / cfg.enc_ratio
        enc = cfg.enc_layers * (comp["attn"] + comp.get("mlp", 0.0))
        per_tok += enc * enc_tok_ratio
        # cross attention per decoder layer
        proj = 2 * d * cfg.d_head * (cfg.n_heads + 2 * cfg.n_kv_heads) + \
            2 * cfg.n_heads * cfg.d_head * d
        per_tok += cfg.n_layers * (proj + 4 * cfg.n_heads * cfg.d_head *
                                   (seq_len // cfg.enc_ratio))
    if cfg.is_encdec and decode:
        proj = 2 * d * cfg.d_head * (cfg.n_heads + 2 * cfg.n_kv_heads) + \
            2 * cfg.n_heads * cfg.d_head * d
        per_tok += cfg.n_layers * (proj + 4 * cfg.n_heads * cfg.d_head *
                                   (seq_len // cfg.enc_ratio))

    fwd_flops_global = per_tok * tokens_global
    if kind == "train":
        # fwd + remat re-fwd + backward(2x fwd) = 4 forward-equivalents
        total_global = 4.0 * fwd_flops_global
    else:
        total_global = fwd_flops_global
    flops_dev = total_global / chips

    # ---- HBM bytes per device (first-order) ----
    bts = dtype_size(cfg.dtype)
    n_params_dev = param_bytes_dev / bts if param_bytes_dev else \
        cfg.param_count() * 1.0 / chips
    if kind == "train":
        passes = 3 * microbatches            # fwd + re-fwd + bwd per mb
        weight_traffic = passes * n_params_dev * bts
        opt_traffic = n_params_dev * (4 + 8 + 8 + 2 * bts)  # g + m+v rw + p rw
        act_traffic = 6 * cfg.n_layers * tokens_dev * d * bts
        logits_traffic = 4 * tokens_dev * Vp / model_shards * bts
        bytes_dev = weight_traffic + opt_traffic + act_traffic + logits_traffic
    elif kind == "prefill":
        act_traffic = 4 * cfg.n_layers * tokens_dev * d * bts
        cache_write = _cache_bytes_dev(cfg, seq_len, global_batch, chips,
                                       model_shards)
        bytes_dev = n_params_dev * bts + act_traffic + cache_write
    else:  # decode: read every weight + the whole cache once per token
        cache_read = _cache_bytes_dev(cfg, seq_len, global_batch, chips,
                                      model_shards)
        bytes_dev = n_params_dev * bts + cache_read + \
            8 * tokens_dev * cfg.n_layers * d
    return {"flops_dev": flops_dev, "bytes_dev": bytes_dev,
            "fwd_flops_global": fwd_flops_global}


def _cache_bytes_dev(cfg, seq_len, global_batch, chips, model_shards) -> float:
    bts = dtype_size(cfg.dtype)
    total = 0.0
    for i in range(cfg.n_layers):
        k = cfg.layer_pattern[i % cfg.pattern_period]
        if k == "attn":
            total += 2 * seq_len * cfg.n_kv_heads * cfg.d_head * bts
        elif k == "attn_local":
            total += 2 * min(cfg.window or seq_len, seq_len) * \
                cfg.n_kv_heads * cfg.d_head * bts
        elif k == "ssd":
            total += cfg.ssm_heads * cfg.ssm_state * cfg.ssm_headdim * 4 + \
                (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * bts
        elif k == "rglru":
            total += cfg.rnn_width * (4 + (cfg.rnn_conv - 1) * bts)
    return total * global_batch / chips


def dtype_size(dtype: str) -> int:
    """Bytes an element of the config dtype (``jnp.dtype(...).itemsize``
    for the three the configs use; 2 otherwise, as the reference's)."""
    return {"bfloat16": 2, "float16": 2, "float32": 4}.get(dtype, 2)


def model_flops(cfg, kind: str, seq_len: int, global_batch: int) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (forward-only), N = active params
    (MoE counts routed top-k + shared only), D = tokens processed."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens
    if kind == "decode":
        tokens = 1 * global_batch          # one new token per sequence
        return 2.0 * n_active * tokens
    raise ValueError(kind)
