"""Payload-generic tau-union merge (DESIGN.md §14, §18 of the reference).

The merge never looks at the payload beyond its weight: ranks are
recomputed from the stored coordinates and ``payload_weight`` of the
stored rows; the merged priority tau is the (m+1)-st smallest of {kept
ranks} ∪ {part taus}, and the merged threshold tau is Algorithm 4's closed
form over the union weights plus the additive ``PartitionStats``.  The
payload only rides through the final compaction: ``select_and_pack`` on
float32 lane positions (exact below 2^24 lanes), then one row gather.
d = 1 is the vector merge of ``core.merge``.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.hashing import hash_unit
from repro_torch.core.merge import _adaptive_tau_union, _dup_earlier
from repro_torch.core.sketches import (INVALID_IDX, flush_subnormal,
                                       sampling_ranks, select_and_pack)
from repro_torch.kernels.sketch_build.ops import kth_smallest_ranks

from .containers import PayloadSketch, payload_capacity, payload_weight


def _union_payloads(parts: PayloadSketch, seed, variant: str, dedupe: bool):
    """Flatten (P, D, cap, d) parts into (D, P*cap) union lanes with
    recomputed sampling ranks; duplicates (unless ``dedupe=False``) and
    padding carry rank +inf (padding rows are 0, so weight 0)."""
    n_parts, D, cap, d = parts.payload.shape
    idx_u = parts.idx.transpose(0, 1).reshape(D, n_parts * cap)
    pay_u = parts.payload.transpose(0, 1).reshape(D, n_parts * cap, d)
    ranks = sampling_ranks(payload_weight(pay_u, variant),
                           hash_unit(seed, idx_u))
    if dedupe:
        dup = _dup_earlier(parts.idx).transpose(0, 1).reshape(D, -1)
        ranks = torch.where(dup, torch.full_like(ranks, torch.inf), ranks)
    return idx_u, pay_u, ranks


def _pack_union(ranks, include, idx_u, pay_u, cap: int, tau
                ) -> PayloadSketch:
    """Keep the smallest-rank included lanes up to ``cap``, re-sorted by
    id; lane positions ride through ``select_and_pack`` as a float32
    payload and the payload rows follow with one gather."""
    pos_f = torch.arange(idx_u.shape[-1], dtype=torch.float32,
                         device=idx_u.device).expand(idx_u.shape)
    kidx, kpos = select_and_pack(ranks, include, idx_u, pos_f, cap)
    gather = kpos.to(torch.int64)[:, :, None].expand(-1, -1, pay_u.shape[-1])
    kpay = torch.gather(pay_u, 1, gather)
    kpay = torch.where((kidx != INVALID_IDX)[:, :, None], kpay,
                       torch.zeros_like(kpay))
    return PayloadSketch(idx=kidx, payload=kpay, tau=tau.to(torch.float32))


def _merge_priority_payload(parts: PayloadSketch, seed, *, m: int,
                            variant: str, dedupe: bool) -> PayloadSketch:
    idx_u, pay_u, ranks = _union_payloads(parts, seed, variant, dedupe)
    # the (m+1)-st smallest merged rank is kept in some part or equals that
    # part's tau, so {kept ranks} ∪ {part taus} holds it exactly
    cand = torch.cat([ranks, parts.tau.T.to(torch.float32)], dim=-1)
    if cand.shape[-1] < m + 1:
        tau = torch.full(cand.shape[:1], torch.inf, dtype=torch.float32,
                         device=cand.device)
    else:
        tau = kth_smallest_ranks(cand.contiguous(), m + 1)
    include = ranks < tau[:, None]
    return _pack_union(ranks, include, idx_u, pay_u, m, tau)


def _merge_threshold_payload(parts: PayloadSketch, seed, stats, *, m: int,
                             variant: str, cap: int, adaptive: bool,
                             dedupe: bool) -> PayloadSketch:
    idx_u, pay_u, ranks = _union_payloads(parts, seed, variant, dedupe)
    w_u = torch.where(torch.isfinite(ranks), payload_weight(pay_u, variant),
                      torch.zeros_like(ranks))
    if adaptive:
        W, nnz = stats
        tau = _adaptive_tau_union(w_u, W, nnz, m)
    else:
        if stats is not None:
            W, _ = stats
        else:
            # the non-adaptive tau is m / W_part: each part's W is
            # recoverable
            taus = parts.tau.to(torch.float32)
            W = torch.where(taus > 0, m / taus,
                            torch.zeros_like(taus)).sum(dim=0)
        tau = flush_subnormal(torch.where(W > 0, m / W, torch.zeros_like(W)))
    include = (torch.isfinite(ranks) & (w_u > 0)
               & (hash_unit(seed, idx_u) <= tau[:, None] * w_u))
    # overflow beyond cap evicts the largest ranks first, as the builders
    # do (select_and_pack keeps the cap smallest)
    return _pack_union(ranks, include, idx_u, pay_u, cap, tau)


def merge_payload_sketches(parts: PayloadSketch, seed, *, m: int,
                           method: str = "priority", variant: str = "l2",
                           cap: int | None = None, adaptive: bool = True,
                           stats=None, dedupe: bool = True) -> PayloadSketch:
    """Payload sketch of the union of P disjoint partitions.

    ``parts``: a stacked (P, D, cap, d) ``PayloadSketch`` with tau (P, D)
    (``core.merge`` handles list stacking, capacity padding and rank
    lifting).  ``stats``: the folded ``(W (D,), nnz (D,))``, needed for
    ``method="threshold"`` with ``adaptive``.  One flat P-way union: one
    selection for tau and one compaction.  Runs on the parts' device."""
    if parts.idx.ndim != 3 or parts.payload.ndim != 4:
        raise ValueError("expected stacked (P, D, cap[, d]) parts, got idx "
                         f"{tuple(parts.idx.shape)}, payload "
                         f"{tuple(parts.payload.shape)}")
    with obs.op("engine.merge_payload_sketches") as sp:
        sp.set("method", method)
        if method == "priority":
            return _merge_priority_payload(parts, seed, m=m, variant=variant,
                                           dedupe=dedupe)
        if method == "threshold":
            if stats is None and adaptive:
                raise ValueError(
                    "merging adaptive threshold sketches needs "
                    "PartitionStats for every part (tau = m'/W does not "
                    "expose W); collect them with partition_stats() at "
                    "build time")
            return _merge_threshold_payload(
                parts, seed, stats, m=m, variant=variant,
                cap=payload_capacity(m) if cap is None else cap,
                adaptive=adaptive, dedupe=dedupe)
        raise ValueError(f"unknown method {method!r}; "
                         "expected 'priority' or 'threshold'")
