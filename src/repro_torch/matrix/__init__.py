"""Matrix-product sketching: coordinated row sampling for ``A^T B``
(DESIGN.md §15 of the reference).

Each row of an (n, d) matrix is one entry whose sampling weight is its
squared norm; a sketch keeps m whole rows and their global row ids, and
two same-seed sketches estimate ``A^T B`` without bias by joining the
sampled ids, rescaling by the inclusion probabilities and one small
product over the matched rows.  The builders, the merge and the
bucketized product are the payload engine's d > 1 case
(``repro_torch.engine``).
"""
from .containers import (MatrixSketch, matrix_capacity,
                         matrix_partition_stats, row_weight,
                         stack_matrix_sketches)
from .builders import priority_matrix_sketch, threshold_matrix_sketch
from .estimator import (estimate_matrix_product, estimate_matrix_products,
                        matrix_intersection_size)
from .merge import merge_matrix_sketches
from .variance import (frobenius_error_guarantee, frobenius_variance_bound,
                       jl_frobenius_error, matrix_sketch_bytes)

__all__ = [
    "MatrixSketch", "matrix_capacity", "matrix_partition_stats", "row_weight",
    "stack_matrix_sketches",
    "priority_matrix_sketch", "threshold_matrix_sketch",
    "estimate_matrix_product", "estimate_matrix_products",
    "matrix_intersection_size",
    "merge_matrix_sketches",
    "frobenius_error_guarantee", "frobenius_variance_bound",
    "jl_frobenius_error", "matrix_sketch_bytes",
]
