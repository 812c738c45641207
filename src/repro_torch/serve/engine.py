"""Batched LM serving engine (``repro.serve.engine``): prefill + decode
with KV caches / recurrent state, greedy or temperature sampling, simple
continuous batching over a request queue (pad-to-batch, evict finished).

Temperature sampling draws Gumbel noise from a ``torch.Generator`` on the
engine's device seeded by ``seed``: the same seed repeats its samples,
but they are not the reference's (``jax.random`` draws other numbers).
Greedy decoding is the reference's: the first maximum of the logits with
the padded vocabulary masked.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import decode_fn, prefill_fn


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Static-batch serving engine (continuous batching at batch
    granularity: a new wave starts when the current wave drains).
    ``params`` live on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: ModelConfig, params, *, batch_size: int = 8,
                 max_len: int = 256, temperature: float = 0.0, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_len = max_len
        self.temperature = temperature
        self.device = resolve_device(device)
        self._prefill = prefill_fn(cfg, max_len=max_len)
        self._decode = decode_fn(cfg)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, Vp) float32 logits -> (B,) int32 tokens below vocab_size."""
        ok = torch.arange(logits.shape[-1], device=logits.device) \
            < self.cfg.vocab_size
        logits = torch.where(ok, logits, -1e30)
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits / self.temperature + gumbel,
                            dim=-1).to(torch.int32)

    def generate_wave(self, requests: list[Request]) -> list[Request]:
        """Run one wave of at most ``batch`` requests to completion."""
        wave = requests[: self.batch]
        B, dev, cfg = self.batch, self.device, self.cfg
        S = max(len(r.prompt) for r in wave)
        qb = cfg.attn_q_block
        S = max(-(-S // qb) * qb, qb)
        with obs.op("serve.lm.wave") as sp:
            sp.set("requests", len(wave))
            toks = np.zeros((B, S), np.int32)
            for i, r in enumerate(wave):
                toks[i, S - len(r.prompt):] = r.prompt  # left-pad
            batch = {"tokens": torch.as_tensor(toks, device=dev)}
            if cfg.vision_tokens:
                batch["image_embeds"] = torch.zeros(
                    (B, cfg.vision_tokens, cfg.d_model), dtype=torch.float32,
                    device=dev)
            if cfg.is_encdec:
                batch["frames"] = torch.zeros(
                    (B, max(S // cfg.enc_ratio, 1), cfg.d_model),
                    dtype=torch.float32, device=dev)
            logits, state = self._prefill(self.params, batch)
            tok = self._sample(logits)
            steps = max(r.max_new_tokens for r in wave)
            emitted = 0
            for _ in range(steps):
                host = tok.cpu().numpy()
                for i, r in enumerate(wave):
                    if not r.done and len(r.output) < r.max_new_tokens:
                        r.output.append(int(host[i]))
                        emitted += 1
                        if len(r.output) >= r.max_new_tokens:
                            r.done = True
                if all(r.done for r in wave):
                    break
                logits, state = self._decode(self.params, state, tok[:, None])
                tok = self._sample(logits)
            if obs.enabled():
                obs.counter("repro_lm_waves_total",
                            "LM serving waves run").inc()
                obs.counter("repro_lm_tokens_total",
                            "Tokens emitted by the LM engine").inc(emitted)
        return wave

    def serve(self, requests: list[Request]) -> list[Request]:
        pending = list(requests)
        finished = []
        while pending:
            wave = self.generate_wave(pending)
            finished.extend(wave)
            pending = pending[len(wave):]
        return finished
