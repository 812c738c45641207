"""Matrix sketch container and row-weight conventions (DESIGN.md §15 of the
reference).

A matrix sketch of an (n, d) matrix keeps whole rows under the vector
sketch's fixed-capacity discipline:

- ``row_idx``: int32 (cap,), sorted ascending, ``INVALID_IDX`` padding;
- ``rows``:    float32 (cap, d), zero rows at padding;
- ``tau``:     float32 scalar; a kept row's inclusion probability is
  ``min(1, tau * w_i)`` with ``w_i`` its sampling weight.

The weight is a function of the stored row (:func:`row_weight`), so the
estimator and the merge recompute probabilities and ranks from the
sketch alone.  A leading batch dim (P, cap, ...) stacks sketches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.merge import PartitionStats
from repro_torch.core.sketches import INVALID_IDX, default_capacity
from repro_torch.device import resolve_device
from repro_torch.engine.containers import payload_weight

MATRIX_VARIANTS = ("l2", "uniform")


class MatrixSketch(NamedTuple):
    """Row-sampled sketch of one (n, d) matrix (or a (P, cap, d) batch)."""

    row_idx: torch.Tensor  # int32 (..., cap), sorted ascending, INVALID pad
    rows: torch.Tensor     # float32 (..., cap, d), zero rows at padding
    tau: torch.Tensor      # float32 (...) inclusion scale

    @property
    def capacity(self) -> int:
        return self.row_idx.shape[-1]

    @property
    def dim(self) -> int:
        return self.rows.shape[-1]

    def size(self) -> torch.Tensor:
        """Number of valid (non-padding) sampled rows."""
        return (self.row_idx != INVALID_IDX).sum(dim=-1)


def row_weight(rows: torch.Tensor, variant: str) -> torch.Tensor:
    """Sampling weight of each row, (..., cap, d) -> (..., cap): l2 ->
    ``||A_i||^2`` in the reference build's summation order
    (``engine.payload_weight``), uniform -> 1 on nonzero rows."""
    if variant not in MATRIX_VARIANTS:
        raise ValueError(f"unknown matrix variant {variant!r}; "
                         f"expected one of {MATRIX_VARIANTS}")
    return payload_weight(rows, variant)


def matrix_capacity(m: int) -> int:
    """Threshold row-sampling capacity: the Lemma-4 sizing
    ``m + 4 ceil(sqrt(m))`` of the vector sketches."""
    return default_capacity(m)


def stack_matrix_sketches(sketches) -> MatrixSketch:
    """List of same-d matrix sketches -> one (P, cap, d) batch, capacities
    padded to the largest (INVALID ids, zero rows: both inert)."""
    cap = max(s.row_idx.shape[-1] for s in sketches)

    def pad(s: MatrixSketch) -> MatrixSketch:
        extra = cap - s.row_idx.shape[-1]
        if extra == 0:
            return s
        return MatrixSketch(F.pad(s.row_idx, (0, extra), value=INVALID_IDX),
                            F.pad(s.rows, (0, 0, 0, extra)), s.tau)

    padded = [pad(s) for s in sketches]
    return MatrixSketch(
        row_idx=torch.stack([s.row_idx for s in padded]),
        rows=torch.stack([s.rows for s in padded]),
        tau=torch.stack([torch.as_tensor(s.tau, dtype=torch.float32,
                                         device=s.rows.device)
                         for s in padded]))


def matrix_partition_stats(A, *, variant: str = "l2", device=None
                           ) -> PartitionStats:
    """``PartitionStats`` of a row partition: total row weight and
    nonzero-row count, the O(1) state that makes threshold matrix sketches
    mergeable.  A tensor stays on its device; other input goes to
    ``device`` (default ``cuda``)."""
    if isinstance(A, torch.Tensor) and device is None:
        A = A.to(torch.float32)
    else:
        A = torch.as_tensor(A, dtype=torch.float32,
                            device=resolve_device(device))
    w = row_weight(A, variant)
    return PartitionStats(total_weight=w.sum(dim=-1),
                          nnz=(w > 0).sum(dim=-1).to(torch.int32))
