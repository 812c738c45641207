"""Core sketching primitives: hashing, the sketch container, threshold
sampling (Algorithms 1+4), priority sampling (Algorithm 3), the
Algorithm 2 estimator and its bounds, batched sketching and the merge of
partition sketches."""
from .hashing import (GOLDEN, UNIT, fold_seed, hash_bucket, hash_sign,
                      hash_u32, hash_unit, mix32)
from .sketches import (INVALID_IDX, Sketch, default_capacity,
                       flush_subnormal, sampling_ranks, select_and_pack,
                       weight)
from .threshold import adaptive_tau, threshold_sketch
from .priority import priority_sketch
from .estimator import estimate_inner_product, intersection_size
from .batched import sketch_corpus
from .merge import (PartitionStats, merge_sketches, merge_sketches_many,
                    merge_stats, partition_stats)
from .variance import (chebyshev_interval, error_guarantee,
                       intersection_norms, linear_sketch_error,
                       rescaled_kept_norms, sketch_size_high_prob,
                       variance_bound)

__all__ = ["GOLDEN", "UNIT", "fold_seed", "hash_bucket", "hash_sign",
           "hash_u32", "hash_unit", "mix32", "INVALID_IDX", "Sketch",
           "default_capacity", "flush_subnormal", "sampling_ranks",
           "select_and_pack", "weight", "adaptive_tau", "threshold_sketch",
           "priority_sketch", "estimate_inner_product", "intersection_size",
           "sketch_corpus", "PartitionStats", "merge_sketches",
           "merge_sketches_many", "merge_stats", "partition_stats",
           "chebyshev_interval", "error_guarantee", "intersection_norms",
           "linear_sketch_error", "rescaled_kept_norms",
           "sketch_size_high_prob", "variance_bound"]
