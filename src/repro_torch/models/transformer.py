"""The LM stack (``repro.models.transformer``): every block kind
(``attn`` / ``attn_local`` / ``ssd`` / ``rglru``), the MoE feed-forward,
cross attention and the encoder (whisper), and the image-embedding
prefix (the VLM stub).

The layout is the reference's: the depth is ``n_groups`` repetitions of
the config's ``layer_pattern`` with each pattern slot's parameters
stacked over the groups (``groups/p<i>``, leading dim ``n_groups``), plus
an unrolled tail for depths the pattern does not divide (recurrentgemma:
26 = 8 x 3 + 2); parameters are plain nested dicts of tensors described
by ``ParamSpec``.  Each layer group, each encoder block and each loss
chunk runs under ``torch.utils.checkpoint``, as the reference wraps them
in ``jax.checkpoint``: without it, the float32 logits of a full-width
vocabulary do not fit on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

from . import dt, layers, moe, rglru, ssm
from .tree import param_leaves, tree_from_leaves, tree_map


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple          # logical axis names (len == len(shape))
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # stddev; None -> 1/sqrt(fan_in)


# ----------------------------------------------------------------------------
# Parameter specs
# ----------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig) -> dict:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "wq": ParamSpec((d, H, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, K, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, K, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, dh, d), ("heads", "head_dim", "embed")),
    }


def _mlp_specs(cfg: ModelConfig, d_ff: int) -> dict:
    d = cfg.d_model
    out = {}
    if cfg.glu:
        out["w_gate"] = ParamSpec((d, d_ff), ("embed", "ffn"))
    out["w_up"] = ParamSpec((d, d_ff), ("embed", "ffn"))
    out["w_down"] = ParamSpec((d_ff, d), ("ffn", "embed"))
    return out


def _moe_specs(cfg: ModelConfig) -> dict:
    d, E, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    out = {
        "router": ParamSpec((d, E), ("embed", None)),
        "w_gate": ParamSpec((E, d, fe), ("experts", "embed", None)),
        "w_up": ParamSpec((E, d, fe), ("experts", "embed", None)),
        "w_down": ParamSpec((E, fe, d), ("experts", None, "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        out["shared"] = {
            "w_gate": ParamSpec((d, fs), ("embed", "ffn")),
            "w_up": ParamSpec((d, fs), ("embed", "ffn")),
            "w_down": ParamSpec((fs, d), ("ffn", "embed")),
        }
    return out


def _ssd_specs(cfg: ModelConfig) -> dict:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, Kc = cfg.ssm_heads, cfg.ssm_conv
    return {
        "w_z": ParamSpec((d, di), ("embed", "inner")),
        "w_x": ParamSpec((d, di), ("embed", "inner")),
        "w_b": ParamSpec((d, N), ("embed", None)),
        "w_c": ParamSpec((d, N), ("embed", None)),
        "w_dt": ParamSpec((d, H), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((Kc, di), (None, "inner"), "normal", 0.2),
        "conv_b": ParamSpec((Kc, N), (None, None), "normal", 0.2),
        "conv_c": ParamSpec((Kc, N), (None, None), "normal", 0.2),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), "zeros"),
        "a_log": ParamSpec((H,), ("ssm_heads",), "zeros"),
        "d_skip": ParamSpec((H,), ("ssm_heads",), "ones"),
        "norm": ParamSpec((di,), ("inner",), "zeros"),
        "w_out": ParamSpec((di, d), ("inner", "embed")),
    }


def _rglru_specs(cfg: ModelConfig) -> dict:
    d, W, Kc = cfg.d_model, cfg.rnn_width, cfg.rnn_conv
    return {
        "w_x": ParamSpec((d, W), ("embed", "rnn")),
        "w_gate": ParamSpec((d, W), ("embed", "rnn")),
        "w_out": ParamSpec((W, d), ("rnn", "embed")),
        "conv_w": ParamSpec((Kc, W), (None, "rnn"), "normal", 0.2),
        "w_r": ParamSpec((W, W), (None, "rnn")),
        "w_i": ParamSpec((W, W), (None, "rnn")),
        "lam": ParamSpec((W,), ("rnn",), "zeros"),
    }


def block_specs(cfg: ModelConfig, kind: str, *,
                with_cross: bool = False) -> dict:
    d = cfg.d_model
    out = {"ln1": ParamSpec((d,), (None,), "zeros")}
    if kind in ("attn", "attn_local"):
        out.update(_attn_specs(cfg))
    elif kind == "ssd":
        out["ssd"] = _ssd_specs(cfg)
    elif kind == "rglru":
        out["rnn"] = _rglru_specs(cfg)
    else:
        raise ValueError(kind)
    if with_cross:
        out["ln_x"] = ParamSpec((d,), (None,), "zeros")
        out["cross"] = _attn_specs(cfg)
    # feed-forward sublayer (absent for pure-SSD blocks with d_ff == 0)
    if cfg.n_experts and kind in ("attn", "attn_local"):
        out["ln2"] = ParamSpec((d,), (None,), "zeros")
        out["moe"] = _moe_specs(cfg)
    elif cfg.d_ff:
        out["ln2"] = ParamSpec((d,), (None,), "zeros")
        out["mlp"] = _mlp_specs(cfg, cfg.d_ff)
    return out


def _stack_specs(specs: dict, n: int) -> dict:
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.scale), specs)


def param_specs(cfg: ModelConfig) -> dict:
    d, Vp = cfg.d_model, cfg.padded_vocab
    specs: dict = {"embed": ParamSpec((Vp, d), ("vocab", "embed"), "normal",
                                      0.02)}
    specs["groups"] = {
        f"p{i}": _stack_specs(block_specs(cfg, kind,
                                          with_cross=cfg.is_encdec),
                              cfg.n_groups)
        for i, kind in enumerate(cfg.layer_pattern)}
    tail = {f"t{j}": block_specs(cfg, cfg.layer_pattern[j],
                                 with_cross=cfg.is_encdec)
            for j in range(cfg.n_tail_layers)}
    if tail:
        specs["tail"] = tail
    specs["final_norm"] = ParamSpec((d,), (None,), "zeros")
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, Vp), ("embed", "vocab"), "normal",
                                     0.02)
    if cfg.vision_tokens:
        specs["img_proj"] = ParamSpec((d, d), ("embed", None))
    if cfg.is_encdec:
        enc_block = {"ln1": ParamSpec((d,), (None,), "zeros")}
        enc_block.update(_attn_specs(cfg))
        enc_block["ln2"] = ParamSpec((d,), (None,), "zeros")
        enc_block["mlp"] = _mlp_specs(cfg, cfg.d_ff)
        specs["enc"] = {
            "blocks": _stack_specs(enc_block, cfg.enc_layers),
            "final_norm": ParamSpec((d,), (None,), "zeros"),
        }
    return specs


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: ModelConfig, generator, *, device=None) -> dict:
    """Random parameters by the reference's per-leaf rule: zeros, ones, or
    normal times ``scale`` (default ``1/sqrt(fan_in)``, ``fan_in`` the
    stacked shape's second-to-last dim, or its only dim), drawn in float32
    and cast to the config dtype.

    ``generator``: a ``torch.Generator`` (its device is where the
    parameters go) or an int seed for one on ``device`` (default
    ``cuda``).  Leaves are drawn in the reference's leaf order, so a seed
    gives the same parameters on every call, though not the reference's
    (``jax.random`` draws other numbers)."""
    from repro_torch.device import resolve_device
    if not isinstance(generator, torch.Generator):
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    dev = generator.device
    dtype = param_dtype(cfg)
    out = []
    for path, spec in param_leaves(param_specs(cfg)):
        if spec.init == "zeros":
            leaf = torch.zeros(spec.shape, dtype=dtype, device=dev)
        elif spec.init == "ones":
            leaf = torch.ones(spec.shape, dtype=dtype, device=dev)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            scale = (spec.scale if spec.scale is not None
                     else 1.0 / math.sqrt(fan_in))
            leaf = (torch.randn(spec.shape, generator=generator, device=dev,
                                dtype=torch.float32) * scale).to(dtype)
        out.append((path, leaf))
    return tree_from_leaves(out)


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` tensors of the config dtype: shapes
    and dtypes with no allocation (the dry run's stand-ins)."""
    dtype = param_dtype(cfg)
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), param_specs(cfg))


# ----------------------------------------------------------------------------
# Block application — train (full sequence)
# ----------------------------------------------------------------------------


def _apply_ffn(cfg: ModelConfig, p, x, aux=None):
    """The feed-forward sublayer with its residual: the MoE (plus shared
    experts; its load-balancing loss added to ``aux`` unless ``aux`` is
    None, as in serving), the MLP, or nothing.  -> (x, aux)."""
    def act(v):
        return layers.activation(v, cfg.mlp_act)

    if "moe" in p:
        if cfg.constrain_activations:
            from repro_torch.distributed.sharding import \
                constrain_batch_sharded
            x = constrain_batch_sharded(x)
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        y, (logits, eids) = moe.moe_ffn(
            p["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
            act_fn=act, capacity_factor=cfg.capacity_factor,
            per_row=cfg.moe_per_row_dispatch)
        if cfg.n_shared_experts:
            y = y + moe.shared_expert_ffn(p["moe"]["shared"], h, act_fn=act)
        if aux is not None:
            aux = aux + moe.load_balancing_loss(logits, eids, cfg.n_experts,
                                                cfg.top_k)
        return x + dt.pin_batch(y), aux
    if "mlp" in p:
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + dt.pin_batch(layers.mlp(p["mlp"], h, act=cfg.mlp_act,
                                           glu=cfg.glu)), aux
    return x, aux


def cross_kv(p_cross, enc_out):
    """Cross attention's keys and values (B, Se, K, dh) from the encoder's
    output (no RoPE)."""
    B, Se, d = enc_out.shape
    K, dh = p_cross["wk"].shape[1:]
    kx = dt.split_guard(enc_out @ dt.merged(p_cross["wk"], 1), K).reshape(
        B, Se, K, dh)
    vx = dt.split_guard(enc_out @ dt.merged(p_cross["wv"], 1), K).reshape(
        B, Se, K, dh)
    return kx, vx


def block_train(cfg: ModelConfig, kind: str, p, x, positions, enc_out,
                aux):
    """One block over the full sequence: pre-norm mixer (attention, SSD
    or RG-LRU) with its residual, cross attention over ``enc_out`` (the
    encoder-decoder), the feed-forward.  -> (x, aux)."""
    x = dt.pin_batch(x)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "attn_local"):
        window = cfg.window if kind == "attn_local" else 0
        y = layers.attention_train(
            p, h, positions=positions, causal=True, window=window,
            rope_theta=cfg.rope_theta, cap=cfg.attn_softcap,
            q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block)
    elif kind == "ssd":
        y, _ = ssm.ssd_train(p["ssd"], h, d_inner=cfg.d_inner,
                             n_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                             chunk=cfg.ssm_chunk)
    elif kind == "rglru":
        y, _ = rglru.recurrent_block_train(p["rnn"], h)
    else:
        raise ValueError(kind)
    x = x + dt.pin_batch(y)
    if cfg.is_encdec and enc_out is not None:
        h = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
        kx, vx = cross_kv(p["cross"], enc_out)
        x = x + dt.pin_batch(layers.attention_train(
            p["cross"], h, positions=positions, causal=False, window=0,
            rope_theta=0.0, cap=0.0, q_block=cfg.attn_q_block,
            kv_block=cfg.attn_kv_block, kv_override=(kx, vx, None)))
    return _apply_ffn(cfg, p, x, aux)


def _unstack(tree, n: int) -> list:
    """Stacked ``(n, ...)`` leaves -> n trees of views (one ``unbind`` a
    leaf, so the backward stacks the groups' gradients once)."""
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda parts: parts[g], split) for g in range(n)]


def apply_backbone(cfg: ModelConfig, params, x, positions, enc_out=None):
    """x: (B, S, d) embedded inputs -> (hidden (B, S, d), aux_loss)."""
    def group_step(x, aux, gp, enc_out):
        for i, kind in enumerate(cfg.layer_pattern):
            x, aux = block_train(cfg, kind, gp[f"p{i}"], x, positions,
                                 enc_out, aux)
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gp in _unstack(params["groups"], cfg.n_groups):
        x, aux = checkpoint(group_step, x, aux, gp, enc_out,
                            use_reentrant=False)
    for j in range(cfg.n_tail_layers):
        x, aux = block_train(cfg, cfg.layer_pattern[j],
                             params["tail"][f"t{j}"], x, positions, enc_out,
                             aux)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def encode(cfg: ModelConfig, params, frames):
    """Whisper-style encoder over stub frame embeddings (B, Senc, d):
    sinusoidal positions, bidirectional attention and the MLP a block
    (each block under ``torch.utils.checkpoint`` while autograd records;
    serving runs them plainly), the final norm."""
    B, Senc, d = frames.shape
    x = frames.to(param_dtype(cfg))
    x = x + layers.sinusoidal_positions(Senc, d, frames.device)[None].to(
        x.dtype)
    positions = torch.arange(Senc, device=frames.device)

    def enc_step(x, bp):
        x = dt.pin_batch(x)
        h = layers.rms_norm(x, bp["ln1"], cfg.norm_eps)
        x = x + dt.pin_batch(layers.attention_train(
            bp, h, positions=positions, causal=False, window=0,
            rope_theta=0.0, cap=0.0, q_block=cfg.attn_q_block,
            kv_block=cfg.attn_kv_block))
        h = layers.rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + dt.pin_batch(layers.mlp(bp["mlp"], h, act=cfg.mlp_act,
                                           glu=cfg.glu))

    for bp in _unstack(params["enc"]["blocks"], cfg.enc_layers):
        x = (checkpoint(enc_step, x, bp, use_reentrant=False)
             if torch.is_grad_enabled() else enc_step(x, bp))
    return layers.rms_norm(x, params["enc"]["final_norm"], cfg.norm_eps)


# ----------------------------------------------------------------------------
# Embedding / logits / loss
# ----------------------------------------------------------------------------


def _lookup(table, ids):
    return table[ids]


def embed_tokens(cfg: ModelConfig, params, tokens, image_embeds=None):
    """Token embeddings times sqrt(d_model), in the config dtype; for the
    VLM the first ``vision_tokens`` positions are ``image_embeds`` (B, P,
    d) through ``img_proj``."""
    dtype = param_dtype(cfg)
    # (on DTensors each rank looks its rows' tokens up in the whole table,
    # its gradient a pending sum over the ranks)
    x = dt.batch_local(_lookup, "rb", "b", params["embed"],
                       tokens.to(torch.int64)).to(dtype)
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
    x = x * scale.to(dtype).to(x.device)
    if cfg.vision_tokens and image_embeds is not None:
        proj = dt.keep_layout(image_embeds.to(x.dtype) @ params["img_proj"])
        x = torch.cat([proj, x[:, cfg.vision_tokens:]], dim=1)
    return x


def _unembed_matrix(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def loss_chunk_len(cfg: ModelConfig, B: int, S: int) -> int:
    """Sequence positions a loss chunk holds (the reference's rule)."""
    cb = max(min(cfg.loss_token_block // max(B, 1), S), 1)
    while S % cb:
        cb -= 1
    return cb


def lm_loss(cfg: ModelConfig, params, hidden, labels, mask):
    """Cross-entropy, chunked over the sequence so that the (T, V) logits
    of the whole batch are never held at once: each chunk's float32
    logits get the logit softcap, the padded vocabulary entries
    ``NEG_INF``, then the log-sum-exp less the gold logit, summed under
    the mask; the total over the mask's sum (at least 1)."""
    B, S, d = hidden.shape
    W = _unembed_matrix(cfg, params)
    Vp = W.shape[1]
    cb = loss_chunk_len(cfg, B, S)
    maskf = mask.to(torch.float32)
    pad = Vp > cfg.vocab_size
    vocab_ok = dt.aligned(W, torch.arange(Vp, device=hidden.device)
                          < cfg.vocab_size, 1)

    def chunk(hc, lc, mc, W):
        logits = (hc @ W).to(torch.float32)
        logits = layers.softcap(logits, cfg.logit_softcap)
        if pad:
            logits = torch.where(vocab_ok, logits, layers.NEG_INF)
        logz = dt.logsumexp(logits, -1)
        gold = dt.take_last(logits, lc.to(torch.int64))
        return torch.sum(mc * (logz - gold))

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for k in range(S // cb):
        sl = slice(k * cb, (k + 1) * cb)
        total = total + checkpoint(chunk, hidden[:, sl], labels[:, sl],
                                   maskf[:, sl], W, use_reentrant=False)
    denom = torch.clamp(maskf.sum(), min=1.0)
    return total / denom


def logits_last(cfg: ModelConfig, params, hidden_last):
    """hidden_last: (B, d) -> (B, Vp) float32 logits with the logit
    softcap; the padded vocabulary is left to the caller (the engine
    masks it)."""
    logits = (hidden_last @ _unembed_matrix(cfg, params)).to(torch.float32)
    return layers.softcap(logits, cfg.logit_softcap)
