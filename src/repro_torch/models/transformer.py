"""The dense LM stack (``repro.models.transformer``, the dense subset).

The layout is the reference's: the depth is ``n_groups`` repetitions of
the config's ``layer_pattern`` with each pattern slot's parameters
stacked over the groups (``groups/p<i>``, leading dim ``n_groups``), plus
an unrolled tail for depths the pattern does not divide; parameters are
plain nested dicts of tensors described by ``ParamSpec``.  Each layer
group and each loss chunk runs under ``torch.utils.checkpoint``, as the
reference wraps them in ``jax.checkpoint``: without it, the float32
logits of a full-width vocabulary do not fit on the card.

The families the port does not train yet raise ``NotImplementedError``
naming their slice: MoE (``models/moe.py``), SSD (``models/ssm.py``),
RG-LRU (``models/rglru.py``), the encoder-decoder (``encode``) and the
VLM stub (``img_proj``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

from . import layers
from .tree import param_leaves, tree_from_leaves, tree_map


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple          # logical axis names (len == len(shape))
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # stddev; None -> 1/sqrt(fan_in)


_LATER = {
    "moe": "the MoE family (models/moe.py)",
    "ssd": "the SSD family (models/ssm.py)",
    "rglru": "the RG-LRU family (models/rglru.py)",
    "encdec": "the encoder-decoder family (encode)",
    "vlm": "the VLM family (img_proj)",
}


def check_dense(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the later slice of the port
    that takes ``cfg``'s family, unless it is a dense attention stack."""
    if cfg.n_experts:
        part = _LATER["moe"]
    elif cfg.is_encdec:
        part = _LATER["encdec"]
    elif cfg.vision_tokens:
        part = _LATER["vlm"]
    else:
        kinds = [k for k in cfg.layer_pattern
                 if k not in ("attn", "attn_local")]
        if not kinds:
            return
        part = _LATER.get(kinds[0], f"layer kind {kinds[0]!r}")
    raise NotImplementedError(
        f"{cfg.name}: {part} is a later slice of the port (ROADMAP step "
        "A6); the port trains the dense family")


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


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    out = {"ln1": ParamSpec((d,), (None,), "zeros")}
    if kind not in ("attn", "attn_local"):
        check_dense(cfg)
        raise ValueError(kind)
    out.update(_attn_specs(cfg))
    if cfg.d_ff:
        out["ln2"] = ParamSpec((d,), (None,), "zeros")
        out["mlp"] = _mlp_specs(cfg, cfg.d_ff)
    return out


def _stack_specs(specs: dict, n: int) -> dict:
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.scale), specs)


def param_specs(cfg: ModelConfig) -> dict:
    check_dense(cfg)
    d, Vp = cfg.d_model, cfg.padded_vocab
    specs: dict = {"embed": ParamSpec((Vp, d), ("vocab", "embed"), "normal",
                                      0.02)}
    specs["groups"] = {f"p{i}": _stack_specs(block_specs(cfg, kind),
                                             cfg.n_groups)
                       for i, kind in enumerate(cfg.layer_pattern)}
    tail = {f"t{j}": block_specs(cfg, cfg.layer_pattern[j])
            for j in range(cfg.n_tail_layers)}
    if tail:
        specs["tail"] = tail
    specs["final_norm"] = ParamSpec((d,), (None,), "zeros")
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, Vp), ("embed", "vocab"), "normal",
                                     0.02)
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


# ----------------------------------------------------------------------------
# Block application — train (full sequence)
# ----------------------------------------------------------------------------


def _apply_ffn(cfg: ModelConfig, p, x):
    if "mlp" in p:
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + layers.mlp(p["mlp"], h, act=cfg.mlp_act, glu=cfg.glu)
    return x


def block_train(cfg: ModelConfig, kind: str, p, x, positions):
    """One ``attn`` / ``attn_local`` block: pre-norm attention and MLP,
    each with a residual."""
    if kind not in ("attn", "attn_local"):
        check_dense(cfg)
        raise ValueError(kind)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    window = cfg.window if kind == "attn_local" else 0
    x = x + layers.attention_train(
        p, h, positions=positions, causal=True, window=window,
        rope_theta=cfg.rope_theta, cap=cfg.attn_softcap,
        q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block)
    return _apply_ffn(cfg, p, x)


def _unstack(tree, n: int) -> list:
    """Stacked ``(n, ...)`` leaves -> n trees of views (one ``unbind`` a
    leaf, so the backward stacks the groups' gradients once)."""
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda parts: parts[g], split) for g in range(n)]


def apply_backbone(cfg: ModelConfig, params, x, positions):
    """x: (B, S, d) embedded inputs -> (hidden (B, S, d), aux_loss 0)."""
    check_dense(cfg)

    def group_step(x, gp):
        for i, kind in enumerate(cfg.layer_pattern):
            x = block_train(cfg, kind, gp[f"p{i}"], x, positions)
        return x

    for gp in _unstack(params["groups"], cfg.n_groups):
        x = checkpoint(group_step, x, gp, use_reentrant=False)
    for j in range(cfg.n_tail_layers):
        x = block_train(cfg, cfg.layer_pattern[j], params["tail"][f"t{j}"], x,
                        positions)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ----------------------------------------------------------------------------
# Embedding / logits / loss
# ----------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params, tokens):
    """Token embeddings times sqrt(d_model), in the config dtype."""
    dtype = param_dtype(cfg)
    x = params["embed"][tokens.to(torch.int64)].to(dtype)
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
    return x * scale.to(dtype).to(x.device)


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
    vocab_ok = torch.arange(Vp, device=hidden.device) < cfg.vocab_size

    def chunk(hc, lc, mc, W):
        logits = (hc @ W).to(torch.float32)
        logits = layers.softcap(logits, cfg.logit_softcap)
        if pad:
            logits = torch.where(vocab_ok, logits, layers.NEG_INF)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].to(torch.int64))[..., 0]
        return torch.sum(mc * (logz - gold))

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for k in range(S // cb):
        sl = slice(k * cb, (k + 1) * cb)
        total = total + checkpoint(chunk, hidden[:, sl], labels[:, sl],
                                   maskf[:, sl], W, use_reentrant=False)
    denom = torch.clamp(maskf.sum(), min=1.0)
    return total / denom
