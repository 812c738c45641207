"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  ``csrc/`` holds the sources; ``_build`` compiles them with
``nvcc`` at first launch.

- ``sketch_build``: ``hash_rank_hist``, ``rank_hist`` (the linear-time
  priority build);
- ``intersect_estimate``: ``intersect_estimate`` (query vs corpus),
  ``allpairs_estimate`` (the all-pairs matrix and its moments).
"""
from .intersect_estimate import (BucketizedSketch, allpairs_estimate,
                                 allpairs_moments, bucketize,
                                 bucketize_corpus, bucketize_payloads,
                                 estimate_all_pairs_bucketized,
                                 intersect_estimate, query_corpus,
                                 round_up_pow2, slot_inclusion_probs)
from .sketch_build import (build_priority_corpus, hash_rank_hist,
                           kth_smallest_ranks, pack_kept, rank_hist)

KERNELS = (hash_rank_hist, rank_hist, intersect_estimate, allpairs_estimate)

__all__ = ["BucketizedSketch", "allpairs_estimate", "allpairs_moments",
           "bucketize", "bucketize_corpus", "bucketize_payloads",
           "estimate_all_pairs_bucketized", "intersect_estimate",
           "query_corpus", "round_up_pow2", "slot_inclusion_probs",
           "build_priority_corpus", "hash_rank_hist", "kth_smallest_ranks",
           "pack_kept", "rank_hist", "KERNELS"]
