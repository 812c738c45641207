"""The linear-time batched priority build (DESIGN.md §13 of the reference).

Pipeline per (D, n) block:

1. **Fused hash/weight/rank pass** — one read of the values
   (:func:`hash_rank_hist`), which also emits the level-0 log-domain
   histogram of the rank bits.  Sparse blocks (explicit ``indices``) hash
   the given coordinates with plain tensor ops instead.
2. **Exact k-th smallest rank** — positive float32 values compare like
   their bit patterns, so the (m+1)-st smallest rank (priority tau) is
   resolved by four 8-bit histogram levels: level 0 from step 1, then
   :func:`rank_hist` at shifts 16, 8, 0.  The descent between levels
   (cumulative sum, first bin whose count reaches k, rebase k) is plain
   tensor code on the block's device.
3. **Compaction** — kept entries go to output slot ``cumsum(keep) - 1``
   (coordinates ascend, so the output is idx-sorted without a sort).

Bit-exact against the reference build of ``repro.kernels.sketch_build``.
The threshold build (``adaptive_tau_batched``, ``_overflow_cut``,
``build_threshold_corpus``) and the hash-only front end it uses come with
the next slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import hash_unit
from repro_torch.core.sketches import INVALID_IDX, Sketch, sampling_ranks, weight
from repro_torch.device import resolve_device

from .sketch_build import hash_rank_hist, rank_hist


def kth_smallest_ranks(keys: torch.Tensor, k, *,
                       hist0: torch.Tensor | None = None) -> torch.Tensor:
    """Exact per-row k-th smallest of (D, n) nonnegative float32 keys
    (+inf allowed, no NaN), 1 <= k <= n.  ``hist0`` is the level-0
    histogram when the caller already has it (from :func:`hash_rank_hist`).
    Returns (D,) float32."""
    D, n = keys.shape
    dev = keys.device
    keys = keys.contiguous()
    remaining = torch.broadcast_to(
        torch.as_tensor(k, dtype=torch.int64, device=dev), (D,)).clone()
    prefix = torch.zeros((D,), dtype=torch.int64, device=dev)
    for shift in (24, 16, 8, 0):
        if shift == 24 and hist0 is not None:
            hist = hist0
        else:
            hist = rank_hist(keys, prefix.to(torch.int32), shift=shift)
        csum = torch.cumsum(hist.to(torch.int64), dim=1)
        # first bin whose running count reaches the remaining rank
        d_star = (csum < remaining[:, None]).sum(dim=1)
        below = torch.gather(csum, 1, (d_star - 1).clamp(min=0)[:, None])[:, 0]
        remaining = remaining - torch.where(d_star > 0, below,
                                            torch.zeros_like(below))
        prefix = (prefix << 8) | d_star
    # ranks are nonnegative: the sign bit is 0 and the pattern fits int32
    return prefix.to(torch.int32).view(torch.float32)


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
               indices: torch.Tensor | None):
    """(h, ranks (D, n), hist0) for a (D, n) block.

    Dense blocks run the fused kernel, which also returns the level-0
    histogram; sparse blocks hash their explicit coordinates (the
    positional kernel cannot rebuild them) and leave ``hist0`` None."""
    if indices is not None:
        h = hash_unit(seed, indices.to(torch.int32))
        h2 = h if h.ndim == 2 else h[None, :]
        return h, sampling_ranks(weight(A.to(torch.float32), variant), h2), None
    return hash_rank_hist(A.to(torch.float32).contiguous(), seed,
                          variant=variant)


def build_priority_corpus(A, m: int, seed, *, variant: str = "l2",
                          indices=None, device=None) -> Sketch:
    """Batched linear-time Priority Sampling (Algorithm 3) over (D, n).

    Bit-exact against the row-by-row reference: tau is the exact (m+1)-st
    smallest rank and the kept set follows.  ``indices`` gives explicit
    coordinates ((n,) shared or (D, n) per row, any order).  Runs on
    ``device`` (default ``cuda``)."""
    from repro_torch.engine.build import build_payload_corpus
    dev = resolve_device(device)
    A = torch.atleast_2d(torch.as_tensor(A, dtype=torch.float32, device=dev))
    out = build_payload_corpus(A, m, seed, method="priority", variant=variant,
                               indices=indices, device=dev)
    return Sketch(idx=out.idx, val=out.payload[..., 0], tau=out.tau)
