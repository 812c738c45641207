"""Public model API (``repro.models.model``): one entry point a lifecycle
stage.

- ``loss_fn(cfg, params, batch)``  -> (loss, metrics)                [train]
- ``prefill_fn(cfg, max_len)``     -> (params, batch) -> (logits, state)
- ``decode_fn(cfg)``               -> (params, state, token) -> (logits, state)
- ``init_decode_state``            empty caches, pos = 0

The decode state has the reference's layout: ``pos`` a 0-d int32 tensor;
``groups/p<i>`` leaves stacked over the groups, ``tail/t<j>`` unrolled;
attention layers carry a ring cache (``k``, ``v``, ``pos``; -1 marks an
empty slot; window-sized for local attention), SSD layers ``conv_x`` /
``conv_b`` / ``conv_c`` / ``ssm``, RG-LRU layers ``conv`` / ``h``;
``cross/{groups,tail}`` holds whisper's cross-attention ``k`` / ``v``.
Caches are in the config dtype, ``ssm`` and ``h`` in float32.

Serving writes the state **in place**: prefill fills a state it
allocates, each decode step writes slot ``pos % C`` of every ring cache
and overwrites the recurrent states, so a step moves one token's worth
of cache, not the cache.  Both run under ``torch.inference_mode()``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import dt, layers, rglru, ssm
from .transformer import (_apply_ffn, _unstack, apply_backbone, cross_kv,
                          embed_tokens, encode, lm_loss, logits_last,
                          param_dtype)
from .tree import param_leaves, tree_from_leaves


def loss_fn(cfg: ModelConfig, params, batch) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    (B, S) int, optional ``mask`` (B, S); ``frames`` (B, Senc, d) for the
    encoder-decoder, ``image_embeds`` (B, vision_tokens, d) for the VLM,
    whose image positions leave the loss) under ``params``, plus 0.01
    times the MoE load-balancing loss: (total, {"ce_loss", "aux_loss"})."""
    with dt.scope(params, batch):
        return _loss(cfg, params, batch)


def _loss(cfg: ModelConfig, params, batch):
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


# ----------------------------------------------------------------------------
# Decode state
# ----------------------------------------------------------------------------


def _cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    if kind == "attn_local" and cfg.window:
        return min(cfg.window, seq_len)
    return seq_len


def _zero_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                      dtype, *, lead: tuple = (), device=None) -> dict:
    if kind in ("attn", "attn_local"):
        return layers.init_kv_cache(batch, _cache_len(cfg, kind, seq_len),
                                    cfg.n_kv_heads, cfg.d_head, dtype,
                                    lead=lead, device=device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    if kind == "ssd":
        di, N, Kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        H, P = cfg.ssm_heads, cfg.ssm_headdim
        return {"conv_x": zeros(batch, Kc - 1, di),
                "conv_b": zeros(batch, Kc - 1, N),
                "conv_c": zeros(batch, Kc - 1, N),
                "ssm": zeros(batch, H, N, P, dt=torch.float32)}
    if kind == "rglru":
        W, Kc = cfg.rnn_width, cfg.rnn_conv
        return {"conv": zeros(batch, Kc - 1, W),
                "h": zeros(batch, W, dt=torch.float32)}
    raise ValueError(kind)


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      enc_len: int = 0, *, device=None) -> dict:
    """Empty decode state (every cache empty, pos = 0) for ``batch``
    sequences of up to ``seq_len`` positions on ``device`` (default
    ``cuda``).  Every stacked leaf is allocated whole: no group shares
    storage with another, so an in-place write lands in one group."""
    return _decode_state(cfg, batch, seq_len, enc_len, resolve_device(device))


def _placed_state(cfg: ModelConfig, batch: int, seq_len: int, enc_len: int,
                  dev, mesh) -> dict:
    """:func:`init_decode_state`'s state laid out as ``mesh``'s rules say
    (``decode_state_shardings``), each rank making only its own shards:
    the empty caches of the whole batch are never made on one rank.  A
    cache's ``pos`` is -1, every other leaf 0."""
    from repro_torch.distributed.sharding import (decode_state_shardings,
                                                  place_full)
    shard = dict(param_leaves(decode_state_shardings(cfg, mesh, batch)))
    meta = _decode_state(cfg, batch, seq_len, enc_len, torch.device("meta"))
    return tree_from_leaves(
        (path, place_full(x, shard[path],
                          -1 if len(path) > 1 and path[-1] == "pos" else 0,
                          dev))
        for path, x in param_leaves(meta))


def decode_state_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """The decode state's leaves as ``meta`` tensors (shapes and dtypes,
    no allocation)."""
    return _decode_state(cfg, batch, seq_len, 0, torch.device("meta"))


def _decode_state(cfg: ModelConfig, batch: int, seq_len: int, enc_len: int,
                  dev) -> dict:
    dtype = param_dtype(cfg)
    lead = (cfg.n_groups,)
    state: dict = {
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "groups": {f"p{i}": _zero_block_cache(cfg, kind, batch, seq_len,
                                              dtype, lead=lead, device=dev)
                   for i, kind in enumerate(cfg.layer_pattern)},
    }
    if cfg.n_tail_layers:
        state["tail"] = {
            f"t{j}": _zero_block_cache(cfg, cfg.layer_pattern[j], batch,
                                       seq_len, dtype, device=dev)
            for j in range(cfg.n_tail_layers)}
    if cfg.is_encdec:
        enc_len = enc_len or max(seq_len // cfg.enc_ratio, 1)
        kv = (batch, enc_len, cfg.n_kv_heads, cfg.d_head)

        def empty_kv(shape):
            return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}

        state["cross"] = {"groups": {f"p{i}": empty_kv(lead + kv)
                                     for i in range(len(cfg.layer_pattern))}}
        if cfg.n_tail_layers:
            state["cross"]["tail"] = {f"t{j}": empty_kv(kv)
                                      for j in range(cfg.n_tail_layers)}
    return state


def make_batch_specs(cfg: ModelConfig, kind: str, seq_len: int,
                     global_batch: int) -> dict:
    """A cell's batch as ``meta`` tensors (the reference's
    ``ShapeDtypeStruct`` stand-ins)."""
    B, S = global_batch, seq_len
    i32 = torch.int32
    dt_ = param_dtype(cfg)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "train":
        batch = {"tokens": spec((B, S), i32), "labels": spec((B, S), i32),
                 "mask": spec((B, S), torch.float32)}
    elif kind == "prefill":
        batch = {"tokens": spec((B, S), i32)}
    elif kind == "decode":
        batch = {"token": spec((B, 1), i32)}
    else:
        raise ValueError(kind)
    if cfg.vision_tokens and kind in ("train", "prefill"):
        batch["image_embeds"] = spec((B, cfg.vision_tokens, cfg.d_model), dt_)
    if cfg.is_encdec and kind in ("train", "prefill"):
        batch["frames"] = spec((B, max(S // cfg.enc_ratio, 1), cfg.d_model),
                               dt_)
    return batch


def _write(cache: dict, new: dict) -> None:
    """Copy a block's new recurrent state into its slice of the state."""
    for k, v in new.items():
        cache[k].copy_(v)


def _group_views(state: dict, key: str, n: int) -> list:
    """``state[key]``'s stacked leaves as ``n`` trees of views (each
    group's slice), or ``n`` Nones when the state has no such part."""
    part = state.get(key)
    return _unstack(part, n) if part is not None else [None] * n


# ----------------------------------------------------------------------------
# Decode step
# ----------------------------------------------------------------------------


def _cross_decode(p_cross, x1, ck, cv):
    """Cross attention of x1 (B, S, d) over the encoder's k / v: no mask,
    no softcap, float32 scores over sqrt(dh)."""
    B, S, d = x1.shape
    H, dh = p_cross["wq"].shape[1:]
    K = ck.shape[2]
    q = dt.split_guard(dt.linear(x1, p_cross["wq"].reshape(d, H * dh)),
                       K).reshape(B, S, K, H // K, dh)
    out = dt.batch_local(_cross_scores, "kkk", "k", q, ck, cv)
    wo = p_cross["wo"]
    return dt.linear(out.to(x1.dtype), wo.reshape(-1, wo.shape[-1]))


def _cross_scores(q, ck, cv):
    """q (B, S, K, G, dh) over ck / cv (B, Se, K, dh) -> (B, S, K G dh)
    float32."""
    B, S, K, G, dh = q.shape
    root = float(torch.sqrt(torch.tensor(float(dh), dtype=torch.float32)))
    s = torch.matmul(q.to(torch.float32).permute(0, 2, 3, 1, 4),
                     ck.to(torch.float32).permute(0, 2, 3, 1)[:, :, None]
                     ) / root                                   # (B,K,G,S,Se)
    pr = torch.softmax(s, dim=-1)
    out = torch.matmul(pr, cv.to(torch.float32).permute(0, 2, 1, 3)[:, :, None])
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, K * G * dh)


def block_decode(cfg: ModelConfig, kind: str, p, cache, x1, pos, cross_ctx):
    """One block on one token; ``cache`` (the block's slice of the state)
    is written in place.  -> x."""
    x1 = dt.pin_batch(x1)
    h = layers.rms_norm(x1, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "attn_local"):
        window = cfg.window if kind == "attn_local" else 0
        y, _ = layers.attention_decode(
            p, h, cache, pos=pos, window=window, rope_theta=cfg.rope_theta,
            cap=cfg.attn_softcap)
    elif kind == "ssd":
        y, new = ssm.ssd_decode(p["ssd"], h, cache, d_inner=cfg.d_inner,
                                n_state=cfg.ssm_state,
                                headdim=cfg.ssm_headdim)
        _write(cache, new)
    elif kind == "rglru":
        y, (conv, hn) = rglru.recurrent_block_decode(p["rnn"], h,
                                                     cache["conv"],
                                                     cache["h"])
        _write(cache, {"conv": conv, "h": hn})
    else:
        raise ValueError(kind)
    x = x1 + dt.pin_batch(y)
    if cfg.is_encdec and cross_ctx is not None:
        h = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + dt.pin_batch(_cross_decode(p["cross"], h, cross_ctx["k"],
                                           cross_ctx["v"]))
    x, _ = _apply_ffn(cfg, p, x)
    return x


def decode_fn(cfg: ModelConfig):
    """Returns ``serve_step(params, state, token (B, 1)) -> (logits (B, Vp)
    float32, state)``.

    The returned state shares storage with the state passed in: the
    caches are written in place (only ``pos`` is a new tensor), so a
    consumed state is not to be reused; clone it first to keep it.
    ``pos`` stays on the device: the ring slot and the validity mask are
    computed from the tensor."""

    def serve_step(params, state, token):
        with dt.no_grad_scope(params, state, token), \
                dt.scope(params, state, token):
            pos = state["pos"]
            n = cfg.n_groups
            x = embed_tokens(cfg, params, token)
            cross = state.get("cross", {})
            for gp, gc, gx in zip(_unstack(params["groups"], n),
                                  _unstack(state["groups"], n),
                                  _group_views(cross, "groups", n)):
                for i, kind in enumerate(cfg.layer_pattern):
                    key = f"p{i}"
                    x = block_decode(cfg, kind, gp[key], gc[key], x, pos,
                                     gx[key] if gx is not None else None)
            for j in range(cfg.n_tail_layers):
                key = f"t{j}"
                x = block_decode(cfg, cfg.layer_pattern[j],
                                 params["tail"][key], state["tail"][key], x,
                                 pos, cross.get("tail", {}).get(key))
            x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
            logits = logits_last(cfg, params, x[:, 0])
            return logits, {**state, "pos": pos + 1}

    return serve_step


# ----------------------------------------------------------------------------
# Prefill
# ----------------------------------------------------------------------------


def _attn_prefill_cache(p, h, positions, rope_theta: float, cache) -> None:
    """Project k / v for the whole sequence and pack its last min(C, S)
    positions into the ring layout (slot = pos % C) of ``cache``, in
    place.  C is the cache's length: the decode horizon for a global
    layer (so the ring never wraps onto live entries), min(window,
    horizon) for a local one."""
    B, S = h.shape[:2]
    k, v = layers.project_kv(p, h)
    if rope_theta:
        k = layers.rope(k, positions, rope_theta)
    C = cache["k"].shape[1]
    take = min(C, S)
    pos_tail = positions[S - take:]
    slots = pos_tail % C
    dt.ring_write_(cache["k"], 1, slots,
                   k[:, S - take:].to(cache["k"].dtype))
    dt.ring_write_(cache["v"], 1, slots,
                   v[:, S - take:].to(cache["v"].dtype))
    dt.ring_write_(cache["pos"], 1, slots,
                   pos_tail.to(torch.int32).expand(B, take))


def block_prefill(cfg: ModelConfig, kind: str, p, x, positions, enc_out,
                  cache, cross_cache):
    """One block over the prompt, its caches (its slices of the state)
    filled in place.  -> x."""
    x = dt.pin_batch(x)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "attn_local"):
        window = cfg.window if kind == "attn_local" else 0
        y = layers.attention_train(
            p, h, positions=positions, causal=True, window=window,
            rope_theta=cfg.rope_theta, cap=cfg.attn_softcap,
            q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block)
        _attn_prefill_cache(p, h, positions, cfg.rope_theta, cache)
    elif kind == "ssd":
        y, new = ssm.ssd_train(p["ssd"], h, d_inner=cfg.d_inner,
                               n_state=cfg.ssm_state,
                               headdim=cfg.ssm_headdim, chunk=cfg.ssm_chunk)
        _write(cache, new)
    elif kind == "rglru":
        y, (conv, hl) = rglru.recurrent_block_train(p["rnn"], h)
        _write(cache, {"conv": conv, "h": hl})
    else:
        raise ValueError(kind)
    x = x + dt.pin_batch(y)
    if cfg.is_encdec and enc_out is not None:
        hx = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
        kx, vx = cross_kv(p["cross"], enc_out)
        x = x + dt.pin_batch(layers.attention_train(
            p["cross"], hx, positions=positions, causal=False, window=0,
            rope_theta=0.0, cap=0.0, q_block=cfg.attn_q_block,
            kv_block=cfg.attn_kv_block, kv_override=(kx, vx, None)))
        _write(cross_cache, {"k": kx, "v": vx})
    x, _ = _apply_ffn(cfg, p, x)
    return x


def prefill_fn(cfg: ModelConfig, max_len: int | None = None):
    """Returns ``prefill_step(params, batch) -> (last_logits (B, Vp)
    float32, decode_state)``; ``batch``: ``tokens`` (B, S), and
    ``frames`` / ``image_embeds`` where the config has them.

    ``max_len``: the decode horizon; global attention caches hold that
    many positions (default: the prompt's length S).  When it is below S
    the ring wraps during prefill and keeps the last ``max_len``
    positions, as the reference's does."""

    def prefill_step(params, batch):
        with dt.no_grad_scope(params, batch), dt.scope(params, batch):
            tokens = batch["tokens"]
            B, S = tokens.shape
            dev = tokens.device
            n = cfg.n_groups
            positions = torch.arange(S, device=dev)
            enc_out = None
            if cfg.is_encdec:
                enc_out = encode(cfg, params, batch["frames"])
            enc_len = enc_out.shape[1] if enc_out is not None else 0
            mesh = dt.mesh_of(params)
            if mesh is None:
                state = init_decode_state(cfg, B, max_len or S, enc_len,
                                          device=dev)
            else:
                state = _placed_state(cfg, B, max_len or S, enc_len, dev,
                                      mesh)
            x = embed_tokens(cfg, params, tokens, batch.get("image_embeds"))
            cross = state.get("cross", {})
            for gp, gc, gx in zip(_unstack(params["groups"], n),
                                  _unstack(state["groups"], n),
                                  _group_views(cross, "groups", n)):
                for i, kind in enumerate(cfg.layer_pattern):
                    key = f"p{i}"
                    x = block_prefill(cfg, kind, gp[key], x, positions,
                                      enc_out, gc[key],
                                      gx[key] if gx is not None else None)
            for j in range(cfg.n_tail_layers):
                key = f"t{j}"
                x = block_prefill(cfg, cfg.layer_pattern[j],
                                  params["tail"][key], x, positions, enc_out,
                                  state["tail"][key],
                                  cross.get("tail", {}).get(key))
            x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
            logits = logits_last(cfg, params, x[:, -1])
            state["pos"].fill_(S)
            return logits, state

    return prefill_step
