from .matrix_sketch import matrix_products
from .ops import (BucketizedMatrixSketch, bucketize_matrix_sketches,
                  matrix_products_bucketized, matrix_slot_probs)
from .ref import matrix_products_ref

__all__ = ["BucketizedMatrixSketch", "bucketize_matrix_sketches",
           "matrix_products", "matrix_products_bucketized",
           "matrix_products_ref", "matrix_slot_probs"]
