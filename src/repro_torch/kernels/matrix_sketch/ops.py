"""The bucketized matrix-sketch layout and the batched product entry point.

``BucketizedMatrixSketch`` is the (P, B, S, d) payload layout of
``engine.bucketized`` under the matrix names: row id ``i`` lands in bucket
``hash(i) mod B`` on both sides, so the row-id join of a pair is a
per-bucket S x S compare.  :func:`matrix_products_bucketized` runs the
matrix-product kernel (:func:`matrix_products`) over a batch of pairs in
one launch; its plain version for CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs

__all__ = ["BucketizedMatrixSketch", "bucketize_matrix_sketches",
           "matrix_products_bucketized", "matrix_slot_probs"]


class BucketizedMatrixSketch(NamedTuple):
    """Bucketized batch of matrix sketches (leading dim P)."""

    idx: torch.Tensor      # int32 (P, B, S) row ids, INVALID_IDX padding
    rows: torch.Tensor     # float32 (P, B, S, d) sampled rows, 0 at padding
    tau: torch.Tensor      # float32 (P,)
    dropped: torch.Tensor  # int32 (P,): rows lost to bucket overflow


def bucketize_matrix_sketches(sk, *, n_buckets: int = 512,
                              slots: int = 4) -> BucketizedMatrixSketch:
    """Re-lay a (P, cap, d) matrix-sketch batch (or one (cap, d) sketch,
    lifted to P = 1) into the bucketized kernel layout; bit-equal to the
    reference's.  ``n_buckets >= 2 m`` keeps overflow drops rare."""
    from repro_torch.engine.bucketized import bucketize_payload_sketches
    from repro_torch.engine.containers import from_matrix
    out = bucketize_payload_sketches(from_matrix(sk), n_buckets=n_buckets,
                                     slots=slots)
    return BucketizedMatrixSketch(out.idx, out.payload, out.tau, out.dropped)


def matrix_slot_probs(bc: BucketizedMatrixSketch, *,
                      variant: str = "l2") -> torch.Tensor:
    """Per-slot inclusion probability min(1, tau * w(row)) of a bucketized
    batch; 1.0 at padding slots so the reciprocals stay finite."""
    from repro_torch.engine.bucketized import payload_slot_probs
    from repro_torch.engine.containers import BucketizedPayloads
    return payload_slot_probs(
        BucketizedPayloads(bc.idx, bc.rows, bc.tau, bc.dropped),
        variant=variant)


def matrix_products_bucketized(A: BucketizedMatrixSketch,
                               B: BucketizedMatrixSketch, *,
                               variant: str = "l2") -> torch.Tensor:
    """(P, B, S) x (P, B, S) bucketized matrix-sketch batches -> the
    (P, d_a, d_b) estimate of every ``A_p^T B_p`` in one launch.  Exact
    against the sorted-layout ``estimate_matrix_product`` up to bucket
    overflow drops (counted in ``dropped``)."""
    from repro_torch.engine.bucketized import bucketized_products
    from repro_torch.engine.containers import BucketizedPayloads
    obs.kernel_launch("matrix_sketch.products")
    return bucketized_products(
        BucketizedPayloads(A.idx, A.rows, A.tau, A.dropped),
        BucketizedPayloads(B.idx, B.rows, B.tau, B.dropped),
        variant=variant)
