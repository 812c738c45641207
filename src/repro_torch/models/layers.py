"""Shared neural building blocks (``repro.models.layers``, the training
subset): norms, softcap, activations, RoPE, gated MLPs and grouped-query
attention with the chunked online softmax.

Parameters are plain dicts of tensors in the reference's layouts
(``wq`` (d, H, dh), ``wk``/``wv`` (d, K, dh), ``wo`` (H, dh, d)).  Compute
runs in the parameters' dtype (bfloat16 on the card), the norm's and the
attention's reductions in float32.  The reference computes attention in
plain JAX outside any Pallas kernel, so plain PyTorch matrix products are
its port; ``scaled_dot_product_attention`` cannot take the score softcap
and is not used.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ----------------------------------------------------------------------------
# Norms / activations / softcap
# ----------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with a ``1 + gamma`` gain, in float32, cast back."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.to(torch.float32))
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":  # squared ReLU (nemotron-4)
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


# ----------------------------------------------------------------------------
# Rotary position embedding
# ----------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) float32 sinusoidal position table, [sin | cos] halves
    (computed in float64 on the host, as the reference's)."""
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(table.astype(np.float32), device=device)


# ----------------------------------------------------------------------------
# MLP (gated / plain)
# ----------------------------------------------------------------------------


def mlp(p, x: torch.Tensor, *, act: str, glu: bool) -> torch.Tensor:
    if glu:
        gate = activation(x @ p["w_gate"], act)
        up = x @ p["w_up"]
        return (gate * up) @ p["w_down"]
    h = activation(x @ p["w_up"], act)
    return h @ p["w_down"]


# ----------------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------------


def project_qkv(p, x: torch.Tensor):
    """x: (B, S, d) -> q (B,S,K,G,dh), k/v (B,S,K,dh) (grouped-query
    layout)."""
    B, S, d = x.shape
    H, dh = p["wq"].shape[1:]
    K = p["wk"].shape[1]
    q = (x @ p["wq"].reshape(d, H * dh)).reshape(B, S, K, H // K, dh)
    k = (x @ p["wk"].reshape(d, K * dh)).reshape(B, S, K, dh)
    v = (x @ p["wv"].reshape(d, K * dh)).reshape(B, S, K, dh)
    return q, k, v


def _fit(size: int, block: int) -> int:
    """The largest block <= ``block`` that divides ``size``."""
    block = min(block, size)
    while size % block:
        block -= 1
    return block


def chunked_attention(q, k, v, *, causal: bool, window: int, q_pos0: int,
                      k_pos0: int, q_block: int, kv_block: int,
                      cap: float = 0.0) -> torch.Tensor:
    """Online-softmax attention over (q_block x kv_block) tiles, the
    reference's recurrence: fp32 scores, the score softcap before the
    mask, masked scores at ``NEG_INF``, the local window
    ``k_pos > q_pos - window``.

    q: (B, Sq, K, G, dh); k, v: (B, Skv, K, dh); positions start at
    ``q_pos0`` / ``k_pos0``.  A tile that the causal mask or the window
    hides entirely is skipped: the recurrence leaves (m, l, acc) as they
    are on such a tile, so the result is the same."""
    B, Sq, K, G, dh = q.shape
    Skv = k.shape[1]
    q_block = _fit(Sq, q_block)
    kv_block = _fit(Skv, kv_block)
    nq, nk = Sq // q_block, Skv // kv_block
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))
    dev = q.device
    # (B, K, G, S, dh) and (B, K, S, dh) float32 views for the tile products
    qf = q.to(torch.float32).permute(0, 2, 3, 1, 4)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    outs = []
    for qi in range(nq):
        q_lo = q_pos0 + qi * q_block
        q_pos = q_lo + torch.arange(q_block, device=dev)
        q_blk = qf[:, :, :, qi * q_block:(qi + 1) * q_block]
        m = torch.full((B, K, G, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, q_block, dh), dtype=torch.float32,
                          device=dev)
        for kj in range(nk):
            k_lo = k_pos0 + kj * kv_block
            if causal and k_lo > q_lo + q_block - 1:
                continue
            if window and k_lo + kv_block - 1 <= q_lo - window:
                continue
            k_pos = k_lo + torch.arange(kv_block, device=dev)
            k_blk = kf[:, :, kj * kv_block:(kj + 1) * kv_block]
            v_blk = vf[:, :, kj * kv_block:(kj + 1) * kv_block]
            s = torch.matmul(q_blk,
                             k_blk[:, :, None].transpose(-1, -2)) * scale
            s = softcap(s, cap)                              # (B,K,G,qb,kb)
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # maximum / minimum against a constant, not clamp: their
            # gradients split ties evenly, as jnp.maximum / jnp.minimum do
            m_safe = torch.maximum(m_new, torch.full_like(m_new, -1e28))
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            dm = m - m_safe
            corr = torch.exp(torch.minimum(dm, torch.zeros_like(dm)))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, v_blk[:, :, None])
            m = m_new
        # (B, K, G, qb, dh)
        out = acc / torch.maximum(l, torch.full_like(l, 1e-30))[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_train(p, x: torch.Tensor, *, positions: torch.Tensor,
                    causal: bool, window: int, rope_theta: float, cap: float,
                    q_block: int, kv_block: int,
                    kv_override=None) -> torch.Tensor:
    """Full-sequence attention (training).  ``positions``: (S,).
    ``kv_override`` supplies precomputed ``(k, v, k_positions)`` for cross
    attention: no RoPE on those keys, key positions from 0 (the
    reference's ``k_positions`` is unused)."""
    q, k, v = project_qkv(p, x)
    if kv_override is not None:
        k, v, _ = kv_override
    if rope_theta:
        q = rope(q.reshape(q.shape[:2] + (-1, q.shape[-1])), positions,
                 rope_theta).reshape(q.shape)
        if kv_override is None:
            k = rope(k, positions, rope_theta)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            q_pos0=int(positions[0]), k_pos0=0,
                            q_block=q_block, kv_block=kv_block, cap=cap)
    B, S = x.shape[:2]
    wo = p["wo"]
    return out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
