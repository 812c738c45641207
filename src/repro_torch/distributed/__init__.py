"""Partitioned (map-reduce) sketch construction on one host."""
from .partitioned_build import (partition_bounds, partitioned_matrix_sketch,
                                partitioned_sketch_corpus,
                                tree_merge_sketches)

__all__ = ["partition_bounds", "partitioned_matrix_sketch",
           "partitioned_sketch_corpus", "tree_merge_sketches"]
