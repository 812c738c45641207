"""Unbiased ``A^T B`` estimation from coordinated row samples (DESIGN.md
§15 of the reference).

``est = sum_{i in K_A ∩ K_B} a_i b_i^T / min(1, tau_A w^A_i, tau_B w^B_i)``

The inclusion-probability algebra is Algorithm 2's; only the per-match
payload changes from a scalar product to a rank-one outer product, so the
sum is one (d_A, |K|) x (|K|, d_B) product over the matched rows.

:func:`estimate_matrix_product` is the sorted-layout searchsorted join
(the parity oracle of ``kernels/matrix_sketch``).
:func:`estimate_matrix_products` dispatches a batch of pairs by device:
on the card it bucketizes both sides and runs the matrix-product kernel
in one launch (as the reference does on its accelerator); on the CPU it
runs the batched searchsorted join, which is exact.
"""
from __future__ import annotations

import torch

from .containers import MatrixSketch


def estimate_matrix_product(sa: MatrixSketch, sb: MatrixSketch, *,
                            variant: str = "l2") -> torch.Tensor:
    """Unbiased (d_A, d_B) estimate of ``A^T B`` from two same-seed matrix
    sketches (leading batch dims pair up).  ``variant`` must match
    construction: weights are recomputed from the stored rows."""
    from repro_torch.engine.containers import from_matrix
    from repro_torch.engine.estimate import estimate_product
    return estimate_product(from_matrix(sa), from_matrix(sb),
                            variant=variant, reduction="matmul")


def matrix_intersection_size(sa: MatrixSketch,
                             sb: MatrixSketch) -> torch.Tensor:
    """Number of row ids present in both sketches (diagnostic)."""
    from repro_torch.engine.containers import from_matrix
    from repro_torch.engine.estimate import payload_intersection_size
    return payload_intersection_size(from_matrix(sa), from_matrix(sb))


def estimate_matrix_products(SA: MatrixSketch, SB: MatrixSketch, *,
                             variant: str = "l2", n_buckets: int = 512,
                             slots: int = 4) -> torch.Tensor:
    """Batched pairs: (P, cap, d_a) x (P, cap, d_b) stacked sketches ->
    (P, d_a, d_b) estimates of every ``A_p^T B_p``.

    CUDA tensors: both batches are bucketized (``n_buckets`` x ``slots``)
    and one launch of the matrix-product kernel estimates every pair —
    exact up to rare bucket drops.  CPU tensors: the batched searchsorted
    join of :func:`estimate_matrix_product`, exact (``n_buckets`` and
    ``slots`` unused)."""
    if SA.row_idx.device.type == "cuda":
        from repro_torch.kernels.matrix_sketch import (
            bucketize_matrix_sketches, matrix_products_bucketized)
        BA = bucketize_matrix_sketches(SA, n_buckets=n_buckets, slots=slots)
        BB = bucketize_matrix_sketches(SB, n_buckets=n_buckets, slots=slots)
        return matrix_products_bucketized(BA, BB, variant=variant)
    return estimate_matrix_product(SA, SB, variant=variant)
