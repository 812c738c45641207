"""Map-reduce sketch construction over coordinate-partitioned corpora
(DESIGN.md §14 of the reference), on one host.

Coordinated sketches merge (``repro_torch.core.merge``), so a corpus whose
coordinates are split over partitions never needs its full vectors in one
place:

- **map**: each partition runs the linear-time builder on its column
  slice, hashing the *global* coordinates (the builders' ``indices``
  path), so the samples stay coordinated across partitions;
- **reduce**: one flat P-way union merge folds the sketches (associative,
  so equal to any pairwise merge tree).  Priority merges are bit-exact
  against the one-shot build; threshold merges fold the additive
  ``PartitionStats`` to recompute the adaptive tau.

The multi-process form (the reference's ``shard_map`` variant) and the
matrix form come with later slices (ROADMAP step A8).
"""
from __future__ import annotations

import torch

from repro_torch.core.merge import (PartitionStats, merge_sketches_many,
                                    partition_stats)
from repro_torch.core.sketches import Sketch, default_capacity
from repro_torch.device import resolve_device


def partition_bounds(n: int, num_partitions: int) -> list:
    """Contiguous [start, stop) column ranges covering ``n`` coordinates."""
    if not 1 <= num_partitions <= n:
        raise ValueError(f"need 1 <= num_partitions <= n, got "
                         f"{num_partitions} for n={n}")
    step = -(-n // num_partitions)
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def tree_merge_sketches(parts, seed, *, m: int, method: str = "priority",
                        variant: str = "l2", cap: int | None = None,
                        adaptive: bool = True,
                        stats: PartitionStats | None = None,
                        dedupe: bool = True) -> Sketch:
    """Fold P partition sketches (a list, or a stacked Sketch with a
    leading part dim) into the merged sketch, as one flat P-way union.
    ``stats`` (leading dim P) is needed for adaptive threshold;
    ``dedupe=False`` skips the duplicate scan for disjoint-by-construction
    partitions."""
    return merge_sketches_many(parts, seed, m=m, method=method,
                               variant=variant, cap=cap, adaptive=adaptive,
                               stats=stats, dedupe=dedupe)


def _build_partition(block, m, seed, *, method, variant, cap, adaptive,
                     indices, device):
    from repro_torch.kernels.sketch_build import (build_priority_corpus,
                                                  build_threshold_corpus)
    if method == "priority":
        return build_priority_corpus(block, m, seed, variant=variant,
                                     indices=indices, device=device)
    if method == "threshold":
        return build_threshold_corpus(block, m, seed, variant=variant,
                                      cap=cap, adaptive=adaptive,
                                      indices=indices, device=device)
    raise ValueError(f"unknown method {method!r}")


def partitioned_sketch_corpus(A, m: int, seed, *, num_partitions: int,
                              method: str = "priority", variant: str = "l2",
                              cap: int | None = None, adaptive: bool = True,
                              device=None) -> Sketch:
    """Map-reduce build on one host: sketch ``num_partitions`` column
    slices of (D, n) independently, then merge.

    Equal to ``sketch_corpus(A, ...)``: bit-exact for priority; for
    threshold the same kept set and tau up to summation rounding.  Only
    one n/P-column slice is built at a time.  Runs on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    A = torch.atleast_2d(torch.as_tensor(A, dtype=torch.float32, device=dev))
    if method == "threshold" and cap is None:
        cap = default_capacity(m)
    parts, stats = [], []
    for s, e in partition_bounds(A.shape[1], num_partitions):
        block = A[:, s:e]
        ids = torch.arange(s, e, dtype=torch.int32, device=dev)
        parts.append(_build_partition(block, m, seed, method=method,
                                      variant=variant, cap=cap,
                                      adaptive=adaptive, indices=ids,
                                      device=dev))
        if method == "threshold":
            stats.append(partition_stats(block, variant=variant))
    st = None
    if stats:
        st = PartitionStats(
            total_weight=torch.stack([x.total_weight for x in stats]),
            nnz=torch.stack([x.nnz for x in stats]))
    # column slices are disjoint by construction: skip the duplicate scan
    return tree_merge_sketches(parts, seed, m=m, method=method,
                               variant=variant, cap=cap, adaptive=adaptive,
                               stats=st, dedupe=False)
