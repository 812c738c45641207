from .intersect_estimate import (allpairs_compact, allpairs_estimate,
                                 intersect_estimate)
from .ops import (DEFAULT_BUCKET_SEED, BucketizedSketch, allpairs_moments,
                  bucketize, bucketize_corpus, bucketize_payloads,
                  estimate_all_pairs_bucketized, query_corpus, round_up_pow2,
                  slot_inclusion_probs)
from .ref import (MOMENT_CHANNELS, allpairs_compact_ref, allpairs_estimate_ref,
                  allpairs_join_ref, intersect_estimate_ref)

__all__ = ["allpairs_compact", "allpairs_estimate", "intersect_estimate",
           "DEFAULT_BUCKET_SEED", "BucketizedSketch", "allpairs_moments",
           "bucketize", "bucketize_corpus", "bucketize_payloads",
           "estimate_all_pairs_bucketized", "query_corpus", "round_up_pow2",
           "slot_inclusion_probs", "MOMENT_CHANNELS",
           "allpairs_compact_ref", "allpairs_estimate_ref", "allpairs_join_ref",
           "intersect_estimate_ref"]
