"""Distributed runtime: partitioned (map-reduce) sketch construction, on
one host and as one ``torch.distributed`` program with a partition a
rank, and SketchDP, sketch-based gradient compression for data-parallel
training (on a ``DeviceMesh``'s data-parallel axes or a group).  The LM
sharding rules and their DTensor placements are
``distributed.sharding``."""
from .grad_compress import (compression_ratio, densify_matrix_mean,
                            densify_mean, init_ef_state,
                            make_sketchdp_grad_fn, matrix_compression_ratio,
                            sketch_gradient, sketch_matrix_gradient)
from .partitioned_build import (partition_bounds, partitioned_matrix_sketch,
                                partitioned_sketch_corpus,
                                partitioned_sketch_corpus_sharded,
                                tree_merge_sketches)

__all__ = ["compression_ratio", "densify_matrix_mean", "densify_mean",
           "init_ef_state", "make_sketchdp_grad_fn",
           "matrix_compression_ratio", "sketch_gradient",
           "sketch_matrix_gradient", "partition_bounds",
           "partitioned_matrix_sketch", "partitioned_sketch_corpus",
           "partitioned_sketch_corpus_sharded", "tree_merge_sketches"]
