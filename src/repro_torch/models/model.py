"""Public model API (``repro.models.model``): the training loss.

- ``loss_fn(cfg, params, batch)`` -> (loss, metrics)   [train]

Serving the LM (``prefill_fn`` / ``decode_fn``, the decode state, the
``serve/engine.py`` engine) is a later slice of the port: those entry
points raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

from .transformer import apply_backbone, check_dense, embed_tokens, lm_loss


def loss_fn(cfg: ModelConfig, params, batch) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    (B, S) int, optional ``mask`` (B, S)) under ``params``.  The dense
    family has no auxiliary loss (``aux_loss`` 0)."""
    check_dense(cfg)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_tokens(cfg, params, tokens)
    hidden, aux = apply_backbone(cfg, params, x, positions)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    loss = lm_loss(cfg, params, hidden, batch["labels"], mask)
    total = loss + 0.01 * aux
    return total, {"ce_loss": loss, "aux_loss": aux}


def _serving_slice(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: serving the LM (prefill / decode, serve/engine.py, "
            "launch/serve.py) is a later slice of the port (ROADMAP step A6)")
    fn.__name__ = name
    return fn


prefill_fn = _serving_slice("prefill_fn")
decode_fn = _serving_slice("decode_fn")
