"""Partitioned (map-reduce) sketch construction: on one host, and as one
``torch.distributed`` program with a partition a rank."""
from .partitioned_build import (partition_bounds, partitioned_matrix_sketch,
                                partitioned_sketch_corpus,
                                partitioned_sketch_corpus_sharded,
                                tree_merge_sketches)

__all__ = ["partition_bounds", "partitioned_matrix_sketch",
           "partitioned_sketch_corpus", "partitioned_sketch_corpus_sharded",
           "tree_merge_sketches"]
