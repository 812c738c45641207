"""Core sketching primitives: hashing, the sketch container, threshold
sampling (Algorithms 1+4), priority sampling (Algorithm 3), the
Algorithm 2 estimator and its bounds (DP bounds included), batched
sketching, the merge of partition sketches, and the paper's baselines
(JL, CountSketch, MinHash, WMH)."""
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
from .variance import (chebyshev_interval, dp_chebyshev_halfwidth,
                       dp_debias_gap, dp_variance_bound, error_guarantee,
                       intersection_norms, linear_sketch_error,
                       rescaled_kept_norms, sketch_size_high_prob,
                       variance_bound)
from .baselines import (MinHashSketch, WMHSketch, countsketch,
                        countsketch_estimate, jl_estimate, jl_sketch,
                        minhash_estimate, minhash_sketch, wmh_estimate,
                        wmh_sketch)

__all__ = ["GOLDEN", "UNIT", "fold_seed", "hash_bucket", "hash_sign",
           "hash_u32", "hash_unit", "mix32", "INVALID_IDX", "Sketch",
           "default_capacity", "flush_subnormal", "sampling_ranks",
           "select_and_pack", "weight", "adaptive_tau", "threshold_sketch",
           "priority_sketch", "estimate_inner_product", "intersection_size",
           "sketch_corpus", "PartitionStats", "merge_sketches",
           "merge_sketches_many", "merge_stats", "partition_stats",
           "chebyshev_interval", "error_guarantee", "intersection_norms",
           "linear_sketch_error", "rescaled_kept_norms",
           "sketch_size_high_prob", "variance_bound",
           "dp_chebyshev_halfwidth", "dp_debias_gap", "dp_variance_bound",
           "MinHashSketch", "WMHSketch", "countsketch",
           "countsketch_estimate", "jl_estimate", "jl_sketch",
           "minhash_estimate", "minhash_sketch", "wmh_estimate",
           "wmh_sketch"]
