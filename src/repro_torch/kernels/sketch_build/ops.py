"""The linear-time batched priority build (DESIGN.md §13 of the reference).

Pipeline per (D, n) block:

1. **Fused hash/weight/rank pass** — one read of the values
   (:func:`hash_rank_hist`), which also emits the level-0 log-domain
   histogram of the rank bits.  Sparse blocks (explicit ``indices``) hash
   the given coordinates with plain tensor ops instead.
2. **Exact k-th smallest rank** — positive float32 values compare like
   their bit patterns, so the (m+1)-st smallest rank (priority tau) is
   resolved by four 8-bit histogram levels: level 0 from step 1, then
   shifts 16, 8, 0, all inside one launch of :func:`radix_select` (the
   plain version runs the same descent as tensor code).
3. **Compaction** — kept entries go to output slot ``cumsum(keep) - 1``
   (coordinates ascend, so the output is idx-sorted without a sort).

The threshold build uses the same three steps: the hash/rank pass without
the histogram (:func:`hash_rank_batched`), the top-m weight cutoff and the
overflow cut as k-th order statistics (:func:`adaptive_tau_batched`,
:func:`_overflow_cut`), and the pack.

Bit-exact against the reference build of ``repro.kernels.sketch_build``
(kept sets and priority tau; the adaptive threshold tau within the
rounding of its sums).  ``use_kernel=False`` asks for the kernels' plain
versions on any device (the reference's ``use_pallas``).
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import hash_unit
from repro_torch.core.sketches import (INVALID_IDX, Sketch, default_capacity,
                                       flush_subnormal, sampling_ranks, weight)
from repro_torch.core.threshold import _tau_all, _tau_from_sorted, suffix_sums
from repro_torch.device import resolve_device

from ..hash_rank import hash_rank, hash_rank_batched
from ..hash_rank.ref import hash_rank_batched_ref, hash_rank_ref
from .ref import hash_rank_hist_ref, kth_smallest_ranks_ref
from .sketch_build import check_k, hash_rank_hist, radix_select


def kth_smallest_ranks(keys: torch.Tensor, k, *,
                       hist0: torch.Tensor | None = None,
                       use_kernel: bool = True) -> torch.Tensor:
    """Exact per-row k-th smallest of (D, n) nonnegative float32 keys
    (+inf allowed, no NaN), 1 <= k <= n.  ``hist0`` is the level-0
    histogram when the caller already has it (from :func:`hash_rank_hist`);
    without it the top level is counted too.  One launch of
    :func:`radix_select` on the card (no host synchronisation); the plain
    descent (``kth_smallest_ranks_ref``) on the CPU or with
    ``use_kernel=False``.  Returns (D,) float32.

    The shared selection primitive: priority tau is the (m+1)-st smallest
    rank, the threshold overflow cut the (cap+1)-st smallest included
    rank, adaptive tau's cutoff the (n-m+1)-st smallest weight and the
    merged tau the (m+1)-st smallest union candidate."""
    check_k(k, keys.shape[1])
    if not use_kernel:
        return kth_smallest_ranks_ref(keys, k, hist0=hist0)
    return radix_select(keys.contiguous(), k, hist0=hist0)


def pack_kept(keep: torch.Tensor, vals: torch.Tensor, cap: int,
              indices: torch.Tensor | None = None):
    """Pack the kept entries of each row into ``cap`` slots, idx-sorted.

    ``keep``: (D, n) bool; ``vals``: (D, n) or (D, n, d) payloads;
    ``indices``: None (coordinates = positions), (n,) shared or (D, n)
    per-row, ascending.  A kept entry goes to slot ``cumsum(keep) - 1``;
    rows with more than ``cap`` kept entries truncate in coordinate order.
    Returns (idx (D, cap) int32 with INVALID padding, payloads (D, cap[, d])
    float32 with 0 padding)."""
    D, n = keep.shape
    dev = keep.device
    csum = torch.cumsum(keep.to(torch.int32), dim=1)
    # non-kept entries (and any beyond cap) land in a discarded extra slot
    slot = torch.where(keep & (csum <= cap), csum - 1,
                       torch.full_like(csum, cap)).to(torch.int64)
    if indices is None:
        gidx = torch.arange(n, dtype=torch.int32, device=dev).expand(D, n)
    else:
        gidx = indices.to(device=dev, dtype=torch.int32).expand(D, n)
    out_idx = torch.full((D, cap + 1), INVALID_IDX, dtype=torch.int32,
                         device=dev).scatter_(1, slot, gidx)
    vals = vals.to(torch.float32)
    rest = vals.shape[2:]
    slot_v = slot.reshape(D, n, *([1] * len(rest))).expand(vals.shape)
    out_val = torch.zeros((D, cap + 1, *rest), dtype=torch.float32,
                          device=dev).scatter_(1, slot_v, vals)
    return out_idx[:, :cap].contiguous(), out_val[:, :cap].contiguous()


def _sort_sparse(A: torch.Tensor, indices: torch.Tensor):
    """Order explicit coordinates ascending (stable), with their values
    (or payload rows) — so the prefix-sum pack emits an idx-sorted sketch
    for any input order."""
    indices = indices.to(torch.int32)
    if indices.ndim == 1:
        order = torch.argsort(indices, stable=True)
        return A[:, order], indices[order]
    order = torch.argsort(indices, dim=1, stable=True)
    gather_A = order.reshape(*order.shape, *([1] * (A.ndim - 2))).expand(A.shape)
    return torch.gather(A, 1, gather_A), torch.gather(indices, 1, order)


def _front_end(A: torch.Tensor, seed, variant: str,
               indices: torch.Tensor | None, want_hist: bool = True,
               use_kernel: bool = True):
    """(h, ranks (D, n), hist0) for a (D, n) block.

    Dense blocks run the fused kernel: with ``want_hist`` the
    hash/rank/histogram kernel (priority), else the hash/rank kernel alone
    (threshold; a single row runs its scalar D = 1 form), and ``hist0`` is
    None.  Sparse blocks hash their explicit coordinates (the positional
    kernels cannot rebuild them) and leave ``hist0`` None."""
    if indices is not None:
        h = hash_unit(seed, indices.to(torch.int32))
        h2 = h if h.ndim == 2 else h[None, :]
        return h, sampling_ranks(weight(A.to(torch.float32), variant), h2), None
    A = A.to(torch.float32).contiguous()
    if want_hist:
        fn = hash_rank_hist if use_kernel else hash_rank_hist_ref
        return fn(A, seed, variant=variant)
    if A.shape[0] == 1:
        fn = hash_rank if use_kernel else hash_rank_ref
        h, rank = fn(A[0], seed, variant=variant)
        return h, rank[None], None
    fn = hash_rank_batched if use_kernel else hash_rank_batched_ref
    h, rank = fn(A, seed, variant=variant)
    return h, rank, None


def _overflow_cut(include: torch.Tensor, scores: torch.Tensor, cap: int, *,
                  use_kernel: bool = True) -> torch.Tensor:
    """Evict the largest-score included entries beyond ``cap`` (threshold
    sampling's overflow event, Lemma 4 probability < ~1e-4).

    The cut is the (cap+1)-st smallest included score; strictly below it
    keeps exactly cap entries (score ties at the cut: DESIGN.md §13 of the
    reference).  The selection runs only when some row overflows: one host
    sync on the row counts decides it."""
    n = include.shape[1]
    if cap + 1 > n:
        return include
    if not bool((include.sum(dim=1) > cap).any()):
        return include
    masked = torch.where(include, scores,
                         torch.full_like(scores, torch.inf))
    sel = kth_smallest_ranks(masked, cap + 1, use_kernel=use_kernel)
    return include & (scores < sel[:, None])


def adaptive_tau_batched(W: torch.Tensor, m: int, *,
                         use_kernel: bool = True) -> torch.Tensor:
    """Per-row inclusion scale of a (D, n) weight block with E[sketch
    size] == min(m, nnz), in linear time.

    The closed form of ``core.threshold.adaptive_tau`` needs only the top
    m weights: the m-th largest weight (the (n-m+1)-st smallest) comes from
    the histogram selection, the (at most m) larger ones are packed and
    sorted, and one masked O(n) pass gives the weight below them.  The op
    order is the reference's (``repro.kernels.sketch_build.ops``), float32
    throughout; tau differs from ``adaptive_tau`` only by the rounding of
    sums over other sets of terms."""
    D, n = W.shape
    nnz = (W > 0).sum(dim=1)
    Wsum = W.sum(dim=1)
    tau_all = _tau_all(W)
    if m >= n:
        return flush_subnormal(tau_all)    # nnz <= n <= m: keep everything
    # m-th largest weight == (n-m+1)-st smallest; zeros sort first
    c_cut = kth_smallest_ranks(W, n - m + 1, use_kernel=use_kernel)
    gt = W > c_cut[:, None]
    g_cnt = gt.sum(dim=1)
    eq_cnt = (W == c_cut[:, None]).sum(dim=1)
    # the top-m weights: those above the cutoff plus copies of the cutoff
    # (the multiset is exact under ties at the cutoff)
    _, buf = pack_kept(gt, W, m)
    js = torch.arange(m, device=W.device)
    buf = torch.where(js[None, :] < g_cnt[:, None], buf, c_cut[:, None])
    w_top = torch.sort(buf, dim=1, descending=True).values
    rest_eq = ((eq_cnt.to(torch.float32) - (m - g_cnt).to(torch.float32))
               * c_cut)
    s_rest = torch.where(W < c_cut[:, None], W,
                         torch.zeros_like(W)).sum(dim=1) + rest_eq
    suffix = s_rest[:, None] + suffix_sums(w_top)
    tau, any_valid = _tau_from_sorted(w_top, suffix, m)
    tau = torch.where(any_valid, tau,
                      torch.where(Wsum > 0, m / Wsum, torch.zeros_like(Wsum)))
    return flush_subnormal(torch.where(nnz <= m, tau_all, tau))


def build_priority_corpus(A, m: int, seed, *, variant: str = "l2",
                          indices=None, device=None) -> Sketch:
    """Batched linear-time Priority Sampling (Algorithm 3) over (D, n).

    Bit-exact against the row-by-row reference: tau is the exact (m+1)-st
    smallest rank and the kept set follows.  ``indices`` gives explicit
    coordinates ((n,) shared or (D, n) per row, any order).  Runs on
    ``device`` (default ``cuda``)."""
    return _build_vector(A, m, seed, method="priority", variant=variant,
                         cap=None, adaptive=True, indices=indices,
                         device=device, use_kernel=True)


def build_threshold_corpus(A, m: int, seed, *, variant: str = "l2",
                           cap: int | None = None, adaptive: bool = True,
                           indices=None, device=None,
                           use_kernel: bool = True) -> Sketch:
    """Batched linear-time Threshold Sampling (Algorithms 1+4) over (D, n).

    Same kept sets and values as the row-by-row ``threshold_sketch``; tau
    may differ by the rounding of the adaptive sums.  ``cap`` defaults to
    ``m + 4 ceil(sqrt(m))``.  Runs on ``device`` (default ``cuda``);
    ``use_kernel=False`` runs the kernels' plain versions there."""
    return _build_vector(A, m, seed, method="threshold", variant=variant,
                         cap=default_capacity(m) if cap is None else cap,
                         adaptive=adaptive, indices=indices, device=device,
                         use_kernel=use_kernel)


def _build_vector(A, m, seed, *, method, variant, cap, adaptive, indices,
                  device, use_kernel) -> Sketch:
    """The d = 1 shim over ``engine.build_payload_corpus``."""
    from repro_torch.engine.build import build_payload_corpus
    dev = resolve_device(device)
    A = torch.atleast_2d(torch.as_tensor(A, dtype=torch.float32, device=dev))
    out = build_payload_corpus(A, m, seed, method=method, variant=variant,
                               cap=cap, adaptive=adaptive, indices=indices,
                               device=dev, use_kernel=use_kernel)
    return Sketch(idx=out.idx, val=out.payload[..., 0], tau=out.tau)
