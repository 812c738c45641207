"""Public model API (``repro.models.model``): the training loss.

- ``loss_fn(cfg, params, batch)`` -> (loss, metrics)   [train]

Serving the LM (``prefill_fn`` / ``decode_fn``, the decode state, the
``serve/engine.py`` engine) is a later slice of the port: those entry
points raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

from .transformer import apply_backbone, embed_tokens, encode, lm_loss


def loss_fn(cfg: ModelConfig, params, batch) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    (B, S) int, optional ``mask`` (B, S); ``frames`` (B, Senc, d) for the
    encoder-decoder, ``image_embeds`` (B, vision_tokens, d) for the VLM,
    whose image positions leave the loss) under ``params``, plus 0.01
    times the MoE load-balancing loss: (total, {"ce_loss", "aux_loss"})."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    enc_out = None
    if cfg.is_encdec:
        enc_out = encode(cfg, params, batch["frames"])
    x = embed_tokens(cfg, params, tokens, batch.get("image_embeds"))
    hidden, aux = apply_backbone(cfg, params, x, positions, enc_out)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    if cfg.vision_tokens:
        img_mask = positions >= cfg.vision_tokens
        mask = mask * img_mask[None].to(mask.dtype)
    loss = lm_loss(cfg, params, hidden, batch["labels"], mask)
    total = loss + 0.01 * aux
    return total, {"ce_loss": loss, "aux_loss": aux}


def _serving_slice(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: serving the LM (prefill / decode, serve/engine.py, "
            "launch/serve.py) is a later slice of the port (ROADMAP step "
            "A6.6)")
    fn.__name__ = name
    return fn


prefill_fn = _serving_slice("prefill_fn")
decode_fn = _serving_slice("decode_fn")
