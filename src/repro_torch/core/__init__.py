"""Core sketching primitives: hashing, the sketch container, threshold
sampling (Algorithms 1+4), priority sampling (Algorithm 3), the
Algorithm 2 estimator and its bounds (DP bounds included), batched
sketching and estimation, the merge of partition sketches, join
correlation (Algorithms 5/6), and the paper's baselines (JL, CountSketch,
MinHash, WMH)."""
from .hashing import (GOLDEN, UNIT, fold_seed, hash_bucket, hash_sign,
                      hash_u32, hash_unit, mix32)
from .sketches import (INVALID_IDX, Sketch, default_capacity, densify,
                       flush_subnormal, sampling_ranks, select_and_pack,
                       weight)
from .threshold import adaptive_tau, threshold_sketch
from .priority import priority_sketch
from .estimator import (estimate_inner_product,
                        estimate_inner_product_dense, intersection_size)
from .batched import estimate_all_pairs, estimate_query, sketch_corpus
from .join_correlation import (CombinedSketch, combined_estimates,
                               combined_estimates_matrix,
                               combined_priority_sketch,
                               combined_sketch_corpus,
                               combined_threshold_sketch, correlation_matrix,
                               correlation_from_estimates,
                               empirical_correlation,
                               estimate_join_correlation)
from .merge import (PartitionStats, merge_combined_sketches, merge_sketches,
                    merge_sketches_many, merge_stats, partition_stats)
from .variance import (chebyshev_estimate_ceiling, chebyshev_interval,
                       coverage_fraction, dp_chebyshev_halfwidth,
                       dp_debias_gap, dp_variance_bound, error_guarantee,
                       intersection_norms, linear_sketch_error,
                       pair_estimate_ceiling, rescaled_kept_norms,
                       sketch_size_high_prob, surviving_corpus_bound,
                       variance_bound)
from .baselines import (MinHashSketch, WMHSketch, countsketch,
                        countsketch_estimate, jl_estimate, jl_sketch,
                        minhash_estimate, minhash_sketch, wmh_estimate,
                        wmh_sketch)

__all__ = ["GOLDEN", "UNIT", "fold_seed", "hash_bucket", "hash_sign",
           "hash_u32", "hash_unit", "mix32", "INVALID_IDX", "Sketch",
           "default_capacity", "densify", "flush_subnormal",
           "sampling_ranks",
           "select_and_pack", "weight", "adaptive_tau", "threshold_sketch",
           "priority_sketch", "estimate_inner_product",
           "estimate_inner_product_dense", "intersection_size",
           "estimate_all_pairs", "estimate_query", "sketch_corpus",
           "CombinedSketch", "combined_estimates",
           "combined_estimates_matrix", "combined_priority_sketch",
           "combined_sketch_corpus", "combined_threshold_sketch",
           "correlation_matrix", "correlation_from_estimates",
           "empirical_correlation", "estimate_join_correlation",
           "PartitionStats", "merge_combined_sketches", "merge_sketches",
           "merge_sketches_many", "merge_stats", "partition_stats",
           "chebyshev_interval", "error_guarantee", "intersection_norms",
           "linear_sketch_error", "rescaled_kept_norms",
           "sketch_size_high_prob", "variance_bound",
           "chebyshev_estimate_ceiling", "coverage_fraction",
           "pair_estimate_ceiling", "surviving_corpus_bound",
           "dp_chebyshev_halfwidth", "dp_debias_gap", "dp_variance_bound",
           "MinHashSketch", "WMHSketch", "countsketch",
           "countsketch_estimate", "jl_estimate", "jl_sketch",
           "minhash_estimate", "minhash_sketch", "wmh_estimate",
           "wmh_sketch"]
