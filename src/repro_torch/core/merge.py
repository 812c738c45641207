"""Merging coordinated sketches of partitioned data (DESIGN.md §14 of the
reference).

Every partition hashes a coordinate with the same seed, so the sketch of
a vector whose coordinates are split over partitions is recoverable from
the partitions' sketches alone: union the kept entries and re-apply the
rank cutoff.  This is the primitive behind map-reduce sketch construction
(``repro_torch.distributed.partitioned_build``) and partition-merge
ingestion.

- **Priority**: the (m+1)-st smallest rank of the merged vector is among
  the parts' kept ranks and published taus, so the merged tau is an exact
  order statistic of that candidate multiset and the merge is bit-exact
  against ``priority_sketch`` of the merged vector.
- **Threshold**: inclusion is the deterministic test ``h <= tau w`` and
  the merged adaptive tau is at most each part's, so every merged-kept
  entry survives in some part.  Recomputing the adaptive tau needs each
  partition's total weight and nonzero count (:class:`PartitionStats`);
  the kept set is exact and tau equal up to the rounding of its sums.

Partitions must have disjoint supports; a coordinate present in two parts
must carry the same value there and is deduplicated (same seed, index and
value give the same rank).  The union math lives once in
``repro_torch.engine.merge``; this module is the d = 1 shim plus the
statistics and the shared helpers.  The combined (join-correlation) merge
comes with ROADMAP step A7.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from .sketches import (INVALID_IDX, Sketch, default_capacity,
                       flush_subnormal, weight)
from .threshold import _tau_all, _tau_from_sorted, suffix_sums


class PartitionStats(NamedTuple):
    """O(1) per-partition state needed to merge threshold sketches: the
    partition's total sampling weight (the ``W`` of Algorithm 4) and its
    nonzero count, both additive over disjoint partitions."""

    total_weight: torch.Tensor  # float32, scalar or (D,)
    nnz: torch.Tensor           # int32, scalar or (D,)


def partition_stats(A, *, variant: str = "l2", device=None
                    ) -> PartitionStats:
    """Stats of a (n,) vector or (D, n) block of partition rows.  A tensor
    stays on its device; other input goes to ``device`` (default
    ``cuda``)."""
    if isinstance(A, torch.Tensor) and device is None:
        A = A.to(torch.float32)
    else:
        A = torch.as_tensor(A, dtype=torch.float32,
                            device=resolve_device(device))
    W = weight(A, variant)
    return PartitionStats(total_weight=W.sum(dim=-1),
                          nnz=(W > 0).sum(dim=-1).to(torch.int32))


def merge_stats(a: PartitionStats, b: PartitionStats) -> PartitionStats:
    """Stats of the union of two disjoint partitions."""
    return PartitionStats(total_weight=a.total_weight + b.total_weight,
                          nnz=a.nnz + b.nnz)


def assert_no_duplicate_ids(idx, *, context: str) -> None:
    """Raise on duplicate coordinates in a merged, idx-sorted sketch.

    ``dedupe=False`` promises disjoint partitions; when they are not, the
    union counts the shared entries twice and every estimate is biased.
    Merged sketches are idx-sorted, so duplicates are adjacent."""
    arr = np.asarray(idx.detach().cpu() if isinstance(idx, torch.Tensor)
                     else idx)
    arr = arr.reshape(-1, arr.shape[-1])
    dup = (arr[:, :-1] == arr[:, 1:]) & (arr[:, :-1] != INVALID_IDX)
    if bool(dup.any()):
        row, lane = np.argwhere(dup)[0]
        raise ValueError(
            f"{context}: merged sketch contains duplicate id "
            f"{int(arr[row, lane])} — the partitions passed with "
            "dedupe=False were not disjoint; rebuild with dedupe=True or "
            "fix the partitioning")


def _dedup_b(idx_a: torch.Tensor, idx_b: torch.Tensor) -> torch.Tensor:
    """True at b-entries whose coordinate also appears in a (searchsorted
    against a's idx-sorted rows): a's copy stands for the entry."""
    pos = torch.searchsorted(idx_a.contiguous(), idx_b.contiguous())
    pos = pos.clamp(0, idx_a.shape[-1] - 1)
    return (torch.gather(idx_a, -1, pos) == idx_b) & (idx_b != INVALID_IDX)


def _dup_earlier(parts_idx: torch.Tensor) -> torch.Tensor:
    """(P, D, cap) part coordinates -> mask of the entries already present
    in an earlier part (the first occurrence stands for the entry)."""
    dup = [torch.zeros(parts_idx.shape[1:], dtype=torch.bool,
                       device=parts_idx.device)]
    for j in range(1, parts_idx.shape[0]):
        d = torch.zeros_like(dup[0])
        for i in range(j):
            d = d | _dedup_b(parts_idx[i], parts_idx[j])
        dup.append(d)
    return torch.stack(dup)


def _adaptive_tau_union(w_u: torch.Tensor, W: torch.Tensor, nnz: torch.Tensor,
                        m: int) -> torch.Tensor:
    """Adaptive tau (Algorithm 4's closed form) of the merged vector from
    the union's kept weights (D, K) and the partitions' total weight.

    Entries absent from the union were dropped at random, hence uncapped
    under every candidate tau, so they only add suffix mass, which ``W``
    supplies (up to summation order).  Mirrors
    ``repro.core.merge._adaptive_tau_union`` op for op."""
    w_sorted = torch.sort(w_u, dim=1, descending=True).values
    # one zero column so the scan can select k == K (every union entry
    # capped, the remaining mass uncapped)
    w_sorted = F.pad(w_sorted, (0, 1))
    W_rest = torch.clamp(W - w_u.sum(dim=1), min=0.0)
    suffix = suffix_sums(w_sorted) + W_rest[:, None]
    tau, any_valid = _tau_from_sorted(w_sorted, suffix, m)
    tau = torch.where(any_valid, tau,
                      torch.where(W > 0, m / W, torch.zeros_like(W)))
    # nnz <= m: every entry of every partition was kept, so the union is
    # the merged vector and its min nonzero weight is exact
    return flush_subnormal(torch.where(nnz <= m, _tau_all(w_u), tau))


def _stack_for_merge(parts):
    """List of sketches (or a stacked Sketch) -> ((P, D, cap) Sketch,
    squeeze): parts of other capacities are padded to the largest, and
    (P, cap) single-vector parts lift to D = 1."""
    if isinstance(parts, Sketch):
        stacked = parts
    else:
        cap = max(p.idx.shape[-1] for p in parts)

        def pad(p: Sketch) -> Sketch:
            extra = cap - p.idx.shape[-1]
            if extra == 0:
                return p
            return Sketch(F.pad(p.idx, (0, extra), value=INVALID_IDX),
                          F.pad(p.val, (0, extra)), p.tau)

        padded = [pad(p) for p in parts]
        stacked = Sketch(
            idx=torch.stack([p.idx for p in padded]),
            val=torch.stack([p.val for p in padded]),
            tau=torch.stack([torch.as_tensor(p.tau, dtype=torch.float32,
                                             device=p.idx.device)
                             for p in padded]))
    if stacked.idx.ndim == 2:                  # (P, cap) single-vector parts
        return Sketch(stacked.idx[:, None], stacked.val[:, None],
                      stacked.tau.reshape(-1, 1)), True
    return Sketch(stacked.idx, stacked.val,
                  stacked.tau.reshape(stacked.idx.shape[:2])), False


def _fold_stats(stats, adaptive: bool, method: str):
    """PartitionStats with a leading part dim -> the summed ((D,), (D,))
    pair (None for priority, or non-adaptive threshold without stats)."""
    if method != "threshold":
        return None
    if stats is None:
        if adaptive:
            raise ValueError(
                "merging adaptive threshold sketches needs PartitionStats "
                "for every part (tau = m'/W does not expose W); collect "
                "them with partition_stats() at build time")
        return None
    W = torch.as_tensor(stats.total_weight, dtype=torch.float32)
    nnz = torch.as_tensor(stats.nnz, dtype=torch.int32)
    return (W.reshape(W.shape[0], -1).sum(dim=0),
            nnz.reshape(nnz.shape[0], -1).sum(dim=0))


def merge_sketches_many(parts, seed, *, m: int, method: str = "priority",
                        variant: str = "l2", cap: int | None = None,
                        adaptive: bool = True,
                        stats: PartitionStats | None = None,
                        dedupe: bool = True) -> Sketch:
    """Sketch of the union of P disjoint partitions from their sketches.

    ``parts``: a list of same-seed sketches (or a stacked Sketch with a
    leading part dim), (P, cap) single-vector or (P, D, cap) corpus parts.
    The merge is associative and runs as one flat P-way union: one
    selection for tau and one compaction.  ``stats`` stacks every part's
    :func:`partition_stats` along the leading dim (needed for adaptive
    threshold).  ``dedupe=False`` skips the cross-part duplicate scan when
    the caller guarantees disjoint supports; a duplicate in the output then
    raises."""
    from repro_torch.engine.containers import PayloadSketch
    from repro_torch.engine.merge import merge_payload_sketches
    parts, squeeze = _stack_for_merge(parts)
    if method == "priority":
        kw = dict(cap=None, adaptive=True, stats=None)
    elif method == "threshold":
        kw = dict(cap=default_capacity(m) if cap is None else cap,
                  adaptive=adaptive,
                  stats=_fold_stats(stats, adaptive, method))
    else:
        raise ValueError(f"unknown method {method!r}; "
                         "expected 'priority' or 'threshold'")
    lifted = PayloadSketch(idx=parts.idx, payload=parts.val[..., None],
                           tau=parts.tau)
    merged = merge_payload_sketches(lifted, seed, m=m, method=method,
                                    variant=variant, dedupe=dedupe, **kw)
    out = Sketch(merged.idx, merged.payload[..., 0], merged.tau)
    if not dedupe:
        assert_no_duplicate_ids(out.idx,
                                context="merge_sketches_many(dedupe=False)")
    if squeeze:
        return Sketch(out.idx[0], out.val[0], out.tau[0])
    return out


def merge_sketches(a: Sketch, b: Sketch, seed, *, m: int,
                   method: str = "priority", variant: str = "l2",
                   cap: int | None = None, adaptive: bool = True,
                   stats_a: PartitionStats | None = None,
                   stats_b: PartitionStats | None = None) -> Sketch:
    """Sketch of the union of two disjoint partitions from their same-seed
    sketches (single sketches or corpora with a leading batch dim).

    Priority: bit-exact against ``priority_sketch`` of the merged vector.
    Threshold: needs ``stats_a``/``stats_b`` when ``adaptive``; the kept
    set is exact and tau equal up to summation rounding (with
    ``adaptive=False`` the stats are optional: W = m / tau)."""
    if (stats_a is None) != (stats_b is None):
        raise ValueError("pass PartitionStats for both sides or neither")
    stats = None
    if stats_a is not None:
        stats = PartitionStats(
            total_weight=torch.stack([
                torch.as_tensor(stats_a.total_weight, dtype=torch.float32),
                torch.as_tensor(stats_b.total_weight, dtype=torch.float32)]),
            nnz=torch.stack([torch.as_tensor(stats_a.nnz, dtype=torch.int32),
                             torch.as_tensor(stats_b.nnz,
                                             dtype=torch.int32)]))
    return merge_sketches_many([a, b], seed, m=m, method=method,
                               variant=variant, cap=cap, adaptive=adaptive,
                               stats=stats)
