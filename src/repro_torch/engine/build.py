"""Payload-generic batched sketch builders (DESIGN.md §18 of the reference).

A (D, n, d) block is reduced to per-entry sampling weights, hashed once,
resolved with the selection primitive of ``kernels/sketch_build``
(``kth_smallest_ranks``) and compacted with the prefix-sum pack.  d = 1
delegates to the fused vector front end (the CUDA hash/rank/histogram
kernel and the level-0 histogram reuse); d > 1 hashes the coordinate ids
directly, as the reference does.

``method="threshold"`` (Algorithms 1+4) takes the adaptive scale from
``adaptive_tau_batched`` (or m / W), keeps ``h <= tau w`` and cuts an
overflow beyond ``cap`` at the (cap+1)-st smallest rank;
``method="priority"`` (Algorithm 3) keeps the ranks below the exact
(m+1)-st smallest.  ``use_kernel=False`` runs the kernels' plain versions
on any device.

``selector`` picks how the order statistics are found:

- ``"histogram"`` (the default): the linear-time histogram selection
  above;
- ``"sort"``: the O(n log n) formulations the reference keeps as its
  parity oracle (``selector="sort"``, behind the matrix builders'
  ``backend="reference"``): ``core.threshold.adaptive_tau`` over all n
  weights and priority tau from ``torch.topk`` over all n ranks.

Both are exact statistics: priority tau and every kept set agree bit for
bit; the adaptive threshold tau differs only in summation order.
"""
from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.core.hashing import hash_unit
from repro_torch.core.sketches import flush_subnormal, sampling_ranks
from repro_torch.core.threshold import adaptive_tau
from repro_torch.device import resolve_device
from repro_torch.kernels.sketch_build.ops import (_front_end, _overflow_cut,
                                                  _sort_sparse,
                                                  adaptive_tau_batched,
                                                  kth_smallest_ranks,
                                                  pack_kept)

from .containers import PayloadSketch, payload_capacity, payload_weight

SELECTORS = ("histogram", "sort")


def pack_payloads(keep: torch.Tensor, payloads: torch.Tensor, cap: int,
                  indices: torch.Tensor | None = None):
    """Pack kept (D, n, d) payload rows into (cap,) slots, idx-sorted —
    ``sketch_build.pack_kept`` over a payload axis."""
    return pack_kept(keep, payloads, cap, indices)


def _generic_front_end(P: torch.Tensor, seed, variant: str,
                       indices: torch.Tensor | None, want_hist: bool,
                       use_kernel: bool):
    """(h, ranks (D, n), W (D, n), hist0) for a (D, n, d) block.  At
    d = 1 with ``want_hist`` (the priority build, which needs no weights)
    W is None."""
    if P.shape[-1] == 1:
        h, ranks, hist0 = _front_end(P[..., 0], seed, variant, indices,
                                     want_hist=want_hist,
                                     use_kernel=use_kernel)
        W = None if want_hist else payload_weight(P, variant)
        return h, ranks, W, hist0
    W = payload_weight(P, variant)
    ids = (torch.arange(P.shape[1], dtype=torch.int32, device=P.device)
           if indices is None else indices.to(torch.int32))
    h = hash_unit(seed, ids)
    h2 = h if h.ndim == 2 else h[None, :]
    return h, sampling_ranks(W, h2), W, None


def _build_threshold_payload(P: torch.Tensor, seed, indices, *, m: int,
                             variant: str, cap: int, adaptive: bool,
                             selector: str, use_kernel: bool
                             ) -> PayloadSketch:
    if indices is not None:
        P, indices = _sort_sparse(P, indices)
    h, ranks, W, _ = _generic_front_end(P, seed, variant, indices,
                                        want_hist=False,
                                        use_kernel=use_kernel)
    if adaptive and selector == "sort":
        tau = adaptive_tau(W, m)
    elif adaptive:
        tau = adaptive_tau_batched(W, m, use_kernel=use_kernel)
    else:
        Wsum = W.sum(dim=1)
        tau = flush_subnormal(torch.where(Wsum > 0, m / Wsum,
                                          torch.zeros_like(Wsum)))
    h2 = h if h.ndim == 2 else h[None, :]
    include = (W > 0) & (h2 <= tau[:, None] * W)
    keep = _overflow_cut(include, ranks, cap, use_kernel=use_kernel)
    kidx, kpay = pack_payloads(keep, P, cap, indices)
    return PayloadSketch(idx=kidx, payload=kpay, tau=tau.to(torch.float32))


def _build_priority_payload(P: torch.Tensor, seed, indices, *, m: int,
                            variant: str, selector: str, use_kernel: bool
                            ) -> PayloadSketch:
    if indices is not None:
        P, indices = _sort_sparse(P, indices)
    D, n, _ = P.shape
    _, ranks, _, hist0 = _generic_front_end(P, seed, variant, indices,
                                            want_hist=selector != "sort",
                                            use_kernel=use_kernel)
    if n < m + 1:
        # fewer candidates than m+1: tau is the padded (m+1)-st rank, +inf
        tau = torch.full((D,), math.inf, dtype=torch.float32, device=P.device)
    elif selector == "sort":
        tau = torch.topk(ranks, m + 1, dim=1, largest=False,
                         sorted=True).values[:, m]
    else:
        tau = kth_smallest_ranks(ranks, m + 1, hist0=hist0,
                                 use_kernel=use_kernel)
    include = ranks < tau[:, None]
    kidx, kpay = pack_payloads(include, P, m, indices)
    return PayloadSketch(idx=kidx, payload=kpay, tau=tau)


def build_payload_corpus(payloads, m: int, seed, *, method: str = "priority",
                         variant: str = "l2", cap: int | None = None,
                         adaptive: bool = True, indices=None, device=None,
                         selector: str | None = None,
                         use_kernel: bool = True) -> PayloadSketch:
    """Batched coordinated sampling of a (D, n, d) payload block (a (D, n)
    block is d = 1).

    ``method="threshold"``: Algorithms 1+4, entry kept iff
    ``h <= tau * w``; ``adaptive=True`` solves E[size] == min(m, nnz);
    ``cap`` defaults to ``payload_capacity(m)`` (Lemma 4).
    ``method="priority"``: Algorithm 3, tau the exact (m+1)-st smallest
    rank, ``min(m, nnz)`` entries kept.  ``indices`` passes explicit
    coordinates ((n,) shared or (D, n) per row, any order) for sparse
    inputs and partitioned builds.  ``selector``: None or ``"histogram"``
    (linear time) or ``"sort"`` (the oracle).  Runs on ``device`` (default
    ``cuda``)."""
    if method not in ("threshold", "priority"):
        raise ValueError(f"unknown method {method!r}; "
                         "expected 'threshold' or 'priority'")
    selector = "histogram" if selector is None else selector
    if selector not in SELECTORS:
        raise ValueError(f"unknown selector {selector!r}; "
                         f"expected one of {SELECTORS}")
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
        if method == "threshold":
            return _build_threshold_payload(
                P, seed, indices, m=m, variant=variant,
                cap=payload_capacity(m) if cap is None else cap,
                adaptive=adaptive, selector=selector, use_kernel=use_kernel)
        return _build_priority_payload(P, seed, indices, m=m,
                                       variant=variant, selector=selector,
                                       use_kernel=use_kernel)
