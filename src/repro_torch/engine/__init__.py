"""Payload-generic coordinated-sampling engine: one sketch container with
payload shape (cap, d) — d = 1 is a vector — one builder family, one
(P, B, S, d) bucketized layout and one merge."""
from .containers import (PAYLOAD_VARIANTS, BucketizedPayloads, PayloadSketch,
                         from_matrix, from_vector, payload_capacity,
                         payload_weight, to_matrix, to_vector)
from .build import SELECTORS, build_payload_corpus, pack_payloads
from .bucketized import (bucketize_payload_sketches, bucketized_products,
                         merge_bucketized_payloads,
                         merged_tau_bucketized_payloads, payload_slot_probs)
from .estimate import (REDUCTIONS, estimate_product,
                       payload_intersection_size)
from .merge import merge_payload_sketches

__all__ = ["PAYLOAD_VARIANTS", "SELECTORS", "REDUCTIONS",
           "BucketizedPayloads", "PayloadSketch", "from_matrix", "to_matrix",
           "from_vector", "to_vector",
           "payload_capacity", "payload_weight", "build_payload_corpus",
           "pack_payloads", "bucketize_payload_sketches",
           "bucketized_products", "merge_bucketized_payloads",
           "merged_tau_bucketized_payloads", "payload_slot_probs",
           "estimate_product", "payload_intersection_size",
           "merge_payload_sketches"]
