"""Shared neural building blocks (``repro.models.layers``): norms,
softcap, activations, RoPE, gated MLPs, grouped-query attention with the
chunked online softmax, and the ring KV cache with one-token decode
attention.

Parameters are plain dicts of tensors in the reference's layouts
(``wq`` (d, H, dh), ``wk``/``wv`` (d, K, dh), ``wo`` (H, dh, d)).  Compute
runs in the parameters' dtype (bfloat16 on the card), the norm's and the
attention's reductions in float32.  The reference computes attention in
plain JAX outside any Pallas kernel, so plain PyTorch matrix products are
its port; ``scaled_dot_product_attention`` cannot take the score softcap
and is not used.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import dt

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
    w_up = dt.fsdp_whole(p["w_up"], 0, x)
    if glu:
        gate = activation(dt.linear(x, dt.fsdp_whole(p["w_gate"], 0, x)),
                          act)
        up = dt.linear(x, w_up)
        return dt.row_parallel(gate * up, p["w_down"])
    h = activation(dt.linear(x, w_up), act)
    return dt.row_parallel(h, p["w_down"])


# ----------------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------------


def project_qkv(p, x: torch.Tensor):
    """x: (B, S, d) -> q (B,S,K,G,dh), k/v (B,S,K,dh) (grouped-query
    layout)."""
    B, S, d = x.shape
    H, dh = p["wq"].shape[1:]
    K = p["wk"].shape[1]
    # (on a DTensor, heads the mesh splits unevenly into K groups are
    # gathered first)
    q = dt.split_guard(dt.linear(x, dt.merged(dt.fsdp_whole(p["wq"], 0, x),
                                              1)), K).reshape(
        B, S, K, H // K, dh)
    return (q,) + project_kv(p, x)


def project_kv(p, x: torch.Tensor):
    """x: (B, S, d) -> k, v (B, S, K, dh)."""
    B, S, d = x.shape
    K, dh = p["wk"].shape[1:]
    k, v = (dt.split_guard(dt.linear(x, dt.merged(
        dt.fsdp_whole(p[w], 0, x), 1)), K).reshape(B, S, K, dh)
        for w in ("wk", "wv"))
    return k, v


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
    """Full-sequence attention (training).  ``positions``: (S,), the
    positions ``0 .. S - 1`` (every caller's; the tile skipping takes the
    first as 0 rather than reading the tensor).
    ``kv_override`` supplies precomputed ``(k, v, k_positions)`` for cross
    attention: no RoPE on those keys, key positions from 0 (the
    reference's ``k_positions`` is unused)."""
    tiles = functools.partial(chunked_attention, causal=causal,
                              window=window, q_pos0=0, k_pos0=0,
                              q_block=q_block, kv_block=kv_block, cap=cap)
    n = dt.shard_count(p["wq"], 1)
    if n > 1 and p["wk"].shape[1] % n:
        return _attention_by_head(p, x, positions, rope_theta, kv_override,
                                  tiles)
    q, k, v = project_qkv(p, x)
    if kv_override is not None:
        k, v, _ = kv_override
    K = k.shape[2]
    if rope_theta:
        q = rope(dt.grad_unshard(q.reshape(q.shape[:2] + (-1, q.shape[-1])),
                                 2, K),
                 positions, rope_theta).reshape(q.shape)
        if kv_override is None:
            k = rope(k, positions, rope_theta)
    # the tiles on each rank's rows (and kv heads, where the mesh divides
    # them)
    out = dt.batch_local(tiles, "kkk", "k", q, k, v)
    B, S = x.shape[:2]
    wo = p["wo"]
    return dt.row_parallel(dt.grad_unshard(out.reshape(B, S, -1), 2, K),
                           dt.merged(wo, 0))


def _attention_by_head(p, x, positions, rope_theta: float, kv_override,
                       tiles):
    """:func:`attention_train` on DTensors whose mesh splits the query
    heads evenly but not the K kv heads (K < the model axis): each rank
    runs its own query heads, each against a copy of its kv head (the kv
    projections whole on every rank), instead of every head on every
    rank."""
    B, S, d = x.shape
    H, dh = p["wq"].shape[1:]
    K = p["wk"].shape[1]
    q = (x @ dt.merged(dt.fsdp_whole(p["wq"], 0, x), 1)).reshape(
        B, S, H, dh)
    if kv_override is not None:
        k, v, _ = kv_override
    else:
        k, v = project_kv(p, x)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        if kv_override is None:
            k = rope(k, positions, rope_theta)
    heads = dt.aligned(q, torch.arange(H, device=x.device), 2)
    out = dt.batch_local(functools.partial(_tiles_by_head, tiles=tiles,
                                           groups=H // K),
                         "kbbm", "k", q, k, v, heads)
    return dt.row_parallel(out.reshape(B, S, H * dh), dt.merged(p["wo"], 0))


def _tiles_by_head(q, k, v, heads, *, tiles, groups: int):
    """q (B, S, h, dh) of the query heads ``heads`` against k / v (B, S,
    K, dh), each head its group's kv head -> (B, S, h, dh)."""
    kv = torch.div(heads, groups, rounding_mode="floor")
    return tiles(q[:, :, :, None], k.index_select(2, kv),
                 v.index_select(2, kv))[:, :, :, 0]


# ----------------------------------------------------------------------------
# KV cache (decode)
# ----------------------------------------------------------------------------


def init_kv_cache(batch: int, cache_len: int, n_kv: int, d_head: int, dtype,
                  *, lead: tuple = (), device=None) -> dict:
    """An empty ring cache: ``k`` / ``v`` (*lead, B, C, K, dh) zeros in
    ``dtype``, ``pos`` (*lead, B, C) int32 -1 (no entry).  ``lead`` puts
    the stacked groups in front; each group gets storage of its own."""
    kv = tuple(lead) + (batch, cache_len, n_kv, d_head)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": torch.full(tuple(lead) + (batch, cache_len), -1,
                          dtype=torch.int32, device=device),
    }


def _decode_scores(q, ck, cpos, pos, *, window: int, cap: float):
    """One-token scores (B, K, G, 1, C) float32 of q (B, 1, K, G, dh)
    against the cache keys ``ck`` (B, C, K, dh): the softcap, then
    ``NEG_INF`` off the valid slots (filled, at or before ``pos``, and for
    a local layer inside the window)."""
    scale = float(torch.tensor(1.0 / math.sqrt(q.shape[-1]),
                               dtype=torch.float32))
    # (B, K, G, 1, dh) x (B, K, 1, dh, C) -> (B, K, G, 1, C)
    s = torch.matmul(q.to(torch.float32).permute(0, 2, 3, 1, 4),
                     ck.to(torch.float32).permute(0, 2, 3, 1)[:, :, None]
                     ) * scale
    s = softcap(s, cap)
    valid = (cpos >= 0) & (cpos <= pos)
    if window:
        valid &= cpos > pos - window
    return torch.where(valid[:, None, None, None, :], s, NEG_INF)


def _decode_attend(q, ck, cv, cpos, pos, *, window: int, cap: float):
    """``softmax(scores) @ values`` of one-token decode -> (B, K, G, 1,
    dh) float32."""
    s = _decode_scores(q, ck, cpos, pos, window=window, cap=cap)
    pr = torch.softmax(s, dim=-1)
    return torch.matmul(pr, cv.to(torch.float32).permute(0, 2, 1, 3)
                        [:, :, None])


def attention_decode(p, x1: torch.Tensor, cache, *, pos: torch.Tensor,
                     window: int, rope_theta: float, cap: float):
    """One-token decode against a ring cache.  x1: (B, 1, d); ``pos``: the
    0-d int32 position on the device.  Writes k, v and ``pos`` into slot
    ``pos % C`` of ``cache`` **in place** (the reference returns a new
    cache; here the caller's tensors are the new cache) and attends over
    the valid slots: filled, at or before ``pos``, and for a local layer
    inside the window.  Scores in float32, the softcap before the mask.
    -> (y (B, 1, d), cache)."""
    q, k, v = project_qkv(p, x1)
    B, _, K, G, dh = q.shape
    posv = pos.reshape(1)
    if rope_theta:
        q = rope(q.reshape(B, 1, K * G, dh), posv, rope_theta).reshape(q.shape)
        k = rope(k, posv, rope_theta)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = (posv % ck.shape[1]).to(torch.int64)
    dt.ring_write_(ck, 1, slot, k.to(ck.dtype))
    dt.ring_write_(cv, 1, slot, v.to(cv.dtype))
    dt.ring_write_(cpos, 1, slot, posv.to(torch.int32).expand(B, 1))
    if dt.shard_count(ck, 1) > 1:
        # the cache split along its sequence: flash-decoding's combine
        s = _decode_scores(q, ck, cpos, pos, window=window, cap=cap)
        out = dt.split_softmax_values(s, cv)
    else:
        # each rank's own (batch, kv-head) block: DTensor has no rule for
        # the batched product of a batch and a head dim both split
        out = dt.batch_local(functools.partial(
            _decode_attend, window=window, cap=cap), "kkkbr", "h",
            q, ck, cv, cpos, pos)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, K * G * dh).to(x1.dtype)
    wo = p["wo"]
    return dt.linear(out, wo.reshape(-1, wo.shape[-1])), cache
