"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  ``csrc/`` holds the sources; ``_build`` compiles them with
``nvcc`` at first launch.

- ``sketch_build``: ``hash_rank_hist``, ``radix_select`` (the linear-time
  builds: the hash/rank pass and the exact k-th smallest key; the
  join-correlation combined builds run on ``radix_select``);
- ``hash_rank``: ``hash_rank_batched``, ``hash_rank`` (the hash/rank pass
  without the histogram: the threshold build's front end);
- ``intersect_estimate``: ``intersect_estimate`` (query vs corpus),
  ``allpairs_compact`` and ``allpairs_estimate`` (the all-pairs matrix and
  its moments: each corpus compacted to its occupied slots, then joined);
- ``sketch_merge``: ``merge_bucketized`` (the partition merge of two
  bucketized corpora);
- ``matrix_sketch``: ``matrix_products`` (the batched ``A^T B`` estimates
  of bucketized matrix-sketch pairs);
- ``countsketch``: ``countsketch_scatter`` (a CountSketch table: the
  CountSketch baseline and the bias-aware estimator's tail);
- ``jl_rademacher``: ``jl_rademacher`` (the matrix-free JL projection
  under given row seeds: ``jl_project`` and the JL baseline).
"""
from .hash_rank import hash_rank, hash_rank_batched
from .intersect_estimate import (BucketizedSketch, allpairs_compact,
                                 allpairs_estimate, allpairs_moments,
                                 bucketize,
                                 bucketize_corpus, bucketize_payloads,
                                 estimate_all_pairs_bucketized,
                                 estimate_tile_rows,
                                 intersect_estimate, query_corpus,
                                 round_up_pow2, slot_inclusion_probs)
from .sketch_build import (adaptive_tau_batched,
                           build_combined_priority_corpus,
                           build_combined_threshold_corpus,
                           build_priority_corpus, build_threshold_corpus, hash_rank_hist,
                           kth_smallest_ranks, pack_kept, radix_select)
from .sketch_merge import (merge_bucketized, merge_bucketized_corpora,
                           merged_tau_bucketized)
from .countsketch import countsketch, countsketch_ref, countsketch_scatter
from .jl_rademacher import jl_project, jl_rademacher, jl_ref
# last: matrix_sketch reaches repro_torch.matrix, whose builders import
# the packages above
from .matrix_sketch import (BucketizedMatrixSketch, bucketize_matrix_sketches,
                            matrix_products, matrix_products_bucketized,
                            matrix_slot_probs)

KERNELS = (hash_rank_hist, radix_select, hash_rank_batched, hash_rank,
           intersect_estimate, allpairs_compact, allpairs_estimate,
           merge_bucketized, matrix_products, countsketch_scatter,
           jl_rademacher)

__all__ = ["hash_rank", "hash_rank_batched", "BucketizedSketch",
           "allpairs_compact", "allpairs_estimate", "allpairs_moments",
           "bucketize", "bucketize_corpus", "bucketize_payloads",
           "estimate_all_pairs_bucketized", "estimate_tile_rows",
           "intersect_estimate",
           "query_corpus", "round_up_pow2", "slot_inclusion_probs",
           "adaptive_tau_batched", "build_combined_priority_corpus",
           "build_combined_threshold_corpus", "build_priority_corpus",
           "build_threshold_corpus", "hash_rank_hist", "kth_smallest_ranks",
           "pack_kept", "radix_select", "merge_bucketized",
           "merge_bucketized_corpora", "merged_tau_bucketized",
           "BucketizedMatrixSketch", "bucketize_matrix_sketches",
           "matrix_products", "matrix_products_bucketized",
           "matrix_slot_probs", "countsketch", "countsketch_ref",
           "countsketch_scatter", "jl_project", "jl_rademacher", "jl_ref",
           "KERNELS"]
