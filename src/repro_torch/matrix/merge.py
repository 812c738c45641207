"""Merging matrix sketches of row-partitioned matrices (DESIGN.md §14, §15
of the reference).

Every partition hashes a global row id with the same seed, so a row's
sampling rank does not depend on which partition sketched it.  The merged
priority ``tau`` is the (m+1)-st smallest rank of the union candidates
(always among the parts' kept ranks and published taus) and the kept set
follows by comparison: bit-exact against sketching the stacked matrix in
one shot.  Threshold merges recompute the adaptive tau from the union's
kept row weights plus the additive ``PartitionStats``.  The union math is
``engine.merge`` at D = 1; this module stacks the parts and folds the
statistics.
"""
from __future__ import annotations

import torch

from repro_torch.core.merge import PartitionStats, assert_no_duplicate_ids

from .containers import MatrixSketch, matrix_capacity, stack_matrix_sketches


def _stack_parts(parts) -> MatrixSketch:
    """List of single-matrix sketches -> padded (P, cap, ...) tensors."""
    if isinstance(parts, MatrixSketch):
        if parts.row_idx.ndim != 2:
            raise ValueError("a stacked MatrixSketch must be (P, cap, d)")
        return parts
    return stack_matrix_sketches(parts)


def _merge(parts: MatrixSketch, seed, stats, *, m, method, variant, cap,
           adaptive, dedupe) -> MatrixSketch:
    """(P, cap, d) parts -> merged sketch through the payload engine (a
    D = 1 batch of P payload parts; folded stats lift to (1,))."""
    from repro_torch.engine.containers import PayloadSketch
    from repro_torch.engine.merge import merge_payload_sketches
    P = parts.rows.shape[0]
    lifted = PayloadSketch(
        idx=parts.row_idx[:, None, :], payload=parts.rows[:, None],
        tau=torch.as_tensor(parts.tau, dtype=torch.float32,
                            device=parts.rows.device).reshape(P, 1))
    folded = None if stats is None else (stats[0].reshape(1),
                                         stats[1].reshape(1))
    out = merge_payload_sketches(lifted, seed, m=m, method=method,
                                 variant=variant, cap=cap, adaptive=adaptive,
                                 stats=folded, dedupe=dedupe)
    return MatrixSketch(row_idx=out.idx[0], rows=out.payload[0],
                        tau=out.tau[0])


def merge_matrix_sketches(parts, seed, *, m: int, method: str = "priority",
                          variant: str = "l2", cap: int | None = None,
                          adaptive: bool = True,
                          stats: PartitionStats | None = None,
                          dedupe: bool = True) -> MatrixSketch:
    """Matrix sketch of the union of P disjoint row partitions from their
    sketches alone.

    ``parts``: a list of same-seed :class:`MatrixSketch` (or one stacked
    with a leading partition dim) built over disjoint global row-id ranges
    (the builders' ``row_indices``).  ``method="priority"`` is bit-exact
    against ``priority_matrix_sketch`` of the stacked matrix;
    ``method="threshold"`` with ``adaptive=True`` needs ``stats``, every
    part's :func:`matrix_partition_stats` stacked along the leading dim.
    ``dedupe=False`` skips the cross-part duplicate scan for partitions
    disjoint by construction; a duplicate id in the output then raises."""
    stacked = _stack_parts(parts)
    if method not in ("priority", "threshold"):
        raise ValueError(f"unknown method {method!r}; "
                         "expected 'priority' or 'threshold'")
    folded = None
    if method == "threshold":
        if stats is None and adaptive:
            raise ValueError(
                "merging adaptive threshold matrix sketches needs "
                "PartitionStats for every part; collect them with "
                "matrix_partition_stats() at build time")
        if stats is not None:
            dev = stacked.rows.device
            folded = (torch.as_tensor(stats.total_weight, dtype=torch.float32,
                                      device=dev).sum(),
                      torch.as_tensor(stats.nnz, dtype=torch.int32,
                                      device=dev).sum(dtype=torch.int32))
    out = _merge(stacked, seed, folded, m=m, method=method, variant=variant,
                 cap=matrix_capacity(m) if cap is None else cap,
                 adaptive=adaptive, dedupe=dedupe)
    if not dedupe:
        assert_no_duplicate_ids(out.row_idx,
                                context="merge_matrix_sketches(dedupe=False)")
    return out
