"""Payload-generic batched sketch builders (DESIGN.md §18 of the reference).

A (D, n, d) block is reduced to per-entry sampling weights, hashed once,
resolved with the selection primitive of ``kernels/sketch_build``
(``kth_smallest_ranks``) and compacted with the prefix-sum pack.  d = 1
delegates to the fused vector front end (the CUDA hash/rank/histogram
kernel and the level-0 histogram reuse); d > 1 hashes the coordinate ids
directly, as the reference does.

Only ``method="priority"`` is ported so far; the threshold build is
ROADMAP step A4.
"""
from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.core.hashing import hash_unit
from repro_torch.core.sketches import sampling_ranks
from repro_torch.device import resolve_device
from repro_torch.kernels.sketch_build.ops import (_front_end, _sort_sparse,
                                                  kth_smallest_ranks,
                                                  pack_kept)

from .containers import PayloadSketch, payload_weight


def pack_payloads(keep: torch.Tensor, payloads: torch.Tensor, cap: int,
                  indices: torch.Tensor | None = None):
    """Pack kept (D, n, d) payload rows into (cap,) slots, idx-sorted —
    ``sketch_build.pack_kept`` over a payload axis."""
    return pack_kept(keep, payloads, cap, indices)


def _generic_front_end(P: torch.Tensor, seed, variant: str,
                       indices: torch.Tensor | None):
    """(h, ranks (D, n), hist0) for a (D, n, d) block."""
    if P.shape[-1] == 1:
        return _front_end(P[..., 0], seed, variant, indices)
    W = payload_weight(P, variant)
    ids = (torch.arange(P.shape[1], dtype=torch.int32, device=P.device)
           if indices is None else indices.to(torch.int32))
    h = hash_unit(seed, ids)
    h2 = h if h.ndim == 2 else h[None, :]
    return h, sampling_ranks(W, h2), None


def _build_priority_payload(P: torch.Tensor, seed, indices, *, m: int,
                            variant: str) -> PayloadSketch:
    if indices is not None:
        P, indices = _sort_sparse(P, indices)
    D, n, _ = P.shape
    _, ranks, hist0 = _generic_front_end(P, seed, variant, indices)
    if n < m + 1:
        # fewer candidates than m+1: tau is the padded (m+1)-st rank, +inf
        tau = torch.full((D,), math.inf, dtype=torch.float32, device=P.device)
    else:
        tau = kth_smallest_ranks(ranks, m + 1, hist0=hist0)
    include = ranks < tau[:, None]
    kidx, kpay = pack_payloads(include, P, m, indices)
    return PayloadSketch(idx=kidx, payload=kpay, tau=tau)


def build_payload_corpus(payloads, m: int, seed, *, method: str = "priority",
                         variant: str = "l2", indices=None,
                         device=None) -> PayloadSketch:
    """Batched coordinated sampling of a (D, n, d) payload block (a (D, n)
    block is d = 1).  ``method="priority"``: Algorithm 3, tau the exact
    (m+1)-st smallest rank, ``min(m, nnz)`` entries kept.  ``indices``
    passes explicit coordinates ((n,) shared or (D, n) per row, any
    order).  Runs on ``device`` (default ``cuda``)."""
    if method == "threshold":
        raise NotImplementedError(
            "method='threshold' is not ported yet (ROADMAP step A4)")
    if method != "priority":
        raise ValueError(f"unknown method {method!r}; "
                         "expected 'threshold' or 'priority'")
    dev = resolve_device(device)
    P = torch.as_tensor(payloads, dtype=torch.float32, device=dev)
    if P.ndim == 2:
        P = P[..., None]
    if P.ndim != 3:
        raise ValueError(f"expected (D, n, d) payloads, got shape "
                         f"{tuple(P.shape)}")
    if indices is not None:
        indices = torch.as_tensor(indices, dtype=torch.int32, device=dev)
    with obs.op("engine.build_payload_corpus") as sp:
        sp.set("method", method)
        return _build_priority_payload(P, seed, indices, m=m, variant=variant)
