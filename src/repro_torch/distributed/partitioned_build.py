"""Map-reduce sketch construction over coordinate-partitioned corpora
(DESIGN.md §14 of the reference).

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

The matrix form (:func:`partitioned_matrix_sketch`) does the same over
row slices of an (n, d) matrix.  :func:`partitioned_sketch_corpus_sharded`
is the build as one ``torch.distributed`` program (the reference's
``shard_map`` form): a partition a rank, the m-sized sketches
all-gathered (the only communication), the same merge folded on every
rank.
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


def partitioned_sketch_corpus_sharded(A, m: int, seed, *, group=None,
                                      method: str = "priority",
                                      variant: str = "l2",
                                      cap: int | None = None,
                                      adaptive: bool = True,
                                      device=None) -> Sketch:
    """The map-reduce build as one ``torch.distributed`` program over the
    ranks of ``group`` (default: the default process group; ``ValueError``
    when none is initialised).  Every rank passes the whole (D, n) ``A``
    and sketches its own ``n / world`` columns with the linear-time
    builder, hashing their global ids; the (D, cap) sketches (and, for
    threshold, the ``PartitionStats``) are all-gathered, and every rank
    folds the same merge, so the result is replicated.

    ``n`` must divide by the group's size.  Runs on ``device`` (default
    ``cuda``, for NCCL); a gloo group takes ``device="cpu"``.  Equal to
    :func:`partitioned_sketch_corpus` with ``num_partitions = world``."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("partitioned_sketch_corpus_sharded needs an "
                         "initialised torch.distributed process group "
                         "(init_process_group)")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    dev = resolve_device(device)
    A = torch.atleast_2d(torch.as_tensor(A, dtype=torch.float32, device=dev))
    D, n = A.shape
    if n % world != 0:
        raise ValueError(f"n={n} must divide over {world} shards")
    shard_n = n // world
    if method == "threshold" and cap is None:
        cap = default_capacity(m)
    lo = rank * shard_n
    block = A[:, lo:lo + shard_n]
    ids = torch.arange(lo, lo + shard_n, dtype=torch.int32, device=dev)
    sk = _build_partition(block, m, seed, method=method, variant=variant,
                          cap=cap, adaptive=adaptive, indices=ids, device=dev)

    def gather(t):
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t.contiguous(), group=group)
        return torch.stack(out)

    parts = Sketch(gather(sk.idx), gather(sk.val), gather(sk.tau))
    st = None
    if method == "threshold":
        own = partition_stats(block, variant=variant)
        st = PartitionStats(total_weight=gather(own.total_weight),
                            nnz=gather(own.nnz))
    # column slices are disjoint by construction: skip the duplicate scan
    return tree_merge_sketches(parts, seed, m=m, method=method,
                               variant=variant, cap=cap, adaptive=adaptive,
                               stats=st, dedupe=False)


def partitioned_matrix_sketch(A, m: int, seed, *, num_partitions: int,
                              method: str = "priority", variant: str = "l2",
                              cap: int | None = None, adaptive: bool = True,
                              device=None):
    """Map-reduce build of a matrix sketch over ``num_partitions`` row
    slices of an (n, d) matrix (DESIGN.md §15 of the reference).

    Each slice is sketched with the matrix builders hashing its global row
    ids (``row_indices``); one flat P-way union merge
    (``matrix.merge_matrix_sketches``) folds the partition sketches.
    Bit-exact against ``priority_matrix_sketch`` of the whole matrix;
    threshold folds ``matrix_partition_stats`` to recompute the adaptive
    tau (the same kept rows, tau up to summation rounding).  Only one
    n/P-row slice is sketched at a time.  A tensor is sketched on its
    device; other input on ``device`` (default ``cuda``)."""
    from repro_torch.matrix import (matrix_partition_stats,
                                    merge_matrix_sketches,
                                    priority_matrix_sketch,
                                    threshold_matrix_sketch)
    dev = (A.device if isinstance(A, torch.Tensor) and device is None
           else resolve_device(device))
    A = torch.as_tensor(A, dtype=torch.float32, device=dev)
    if A.ndim != 2:
        raise ValueError(f"expected an (n, d) matrix, got shape "
                         f"{tuple(A.shape)}")
    if method not in ("priority", "threshold"):
        raise ValueError(f"unknown method {method!r}")
    parts, stats = [], []
    for s, e in partition_bounds(A.shape[0], num_partitions):
        block = A[s:e]
        ids = torch.arange(s, e, dtype=torch.int32, device=dev)
        if method == "priority":
            parts.append(priority_matrix_sketch(block, m, seed,
                                                variant=variant,
                                                row_indices=ids))
        else:
            parts.append(threshold_matrix_sketch(block, m, seed,
                                                 variant=variant, cap=cap,
                                                 adaptive=adaptive,
                                                 row_indices=ids))
            stats.append(matrix_partition_stats(block, variant=variant))
    st = None
    if stats:
        st = PartitionStats(
            total_weight=torch.stack([x.total_weight for x in stats]),
            nnz=torch.stack([x.nnz for x in stats]))
    # row slices are disjoint by construction: skip the duplicate scan (the
    # merge still raises if the output holds a duplicate id)
    return merge_matrix_sketches(parts, seed, m=m, method=method,
                                 variant=variant, cap=cap, adaptive=adaptive,
                                 stats=st, dedupe=False)
