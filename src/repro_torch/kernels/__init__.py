"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  ``csrc/`` holds the sources; ``_build`` compiles them with
``nvcc`` at first launch.

- ``sketch_build``: ``hash_rank_hist``, ``rank_hist`` (the linear-time
  builds);
- ``hash_rank``: ``hash_rank_batched``, ``hash_rank`` (the hash/rank pass
  without the histogram: the threshold build's front end);
- ``intersect_estimate``: ``intersect_estimate`` (query vs corpus),
  ``allpairs_estimate`` (the all-pairs matrix and its moments);
- ``sketch_merge``: ``merge_bucketized`` (the partition merge of two
  bucketized corpora).
"""
from .hash_rank import hash_rank, hash_rank_batched
from .intersect_estimate import (BucketizedSketch, allpairs_estimate,
                                 allpairs_moments, bucketize,
                                 bucketize_corpus, bucketize_payloads,
                                 estimate_all_pairs_bucketized,
                                 intersect_estimate, query_corpus,
                                 round_up_pow2, slot_inclusion_probs)
from .sketch_build import (adaptive_tau_batched, build_priority_corpus,
                           build_threshold_corpus, hash_rank_hist,
                           kth_smallest_ranks, pack_kept, rank_hist)
from .sketch_merge import (merge_bucketized, merge_bucketized_corpora,
                           merged_tau_bucketized)

KERNELS = (hash_rank_hist, rank_hist, hash_rank_batched, hash_rank,
           intersect_estimate, allpairs_estimate, merge_bucketized)

__all__ = ["hash_rank", "hash_rank_batched", "BucketizedSketch",
           "allpairs_estimate", "allpairs_moments", "bucketize",
           "bucketize_corpus", "bucketize_payloads",
           "estimate_all_pairs_bucketized", "intersect_estimate",
           "query_corpus", "round_up_pow2", "slot_inclusion_probs",
           "adaptive_tau_batched", "build_priority_corpus",
           "build_threshold_corpus", "hash_rank_hist", "kth_smallest_ranks",
           "pack_kept", "rank_hist", "merge_bucketized",
           "merge_bucketized_corpora", "merged_tau_bucketized", "KERNELS"]
