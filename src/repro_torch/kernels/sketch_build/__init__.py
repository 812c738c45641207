from .combined import (build_combined_priority_corpus,
                       build_combined_threshold_corpus, union_positions)
from .ops import (adaptive_tau_batched, build_priority_corpus,
                  build_threshold_corpus, kth_smallest_ranks, pack_kept)
from .ref import (NBINS, build_priority_corpus_ref,
                  build_threshold_corpus_ref, hash_rank_hist_ref,
                  kth_smallest_ranks_ref, rank_hist_ref)
from .sketch_build import hash_rank_hist, radix_select

__all__ = ["build_combined_priority_corpus",
           "build_combined_threshold_corpus", "union_positions",
           "adaptive_tau_batched", "build_priority_corpus",
           "build_threshold_corpus", "kth_smallest_ranks", "pack_kept",
           "NBINS", "build_priority_corpus_ref", "build_threshold_corpus_ref",
           "hash_rank_hist_ref", "kth_smallest_ranks_ref", "rank_hist_ref",
           "hash_rank_hist", "radix_select"]
