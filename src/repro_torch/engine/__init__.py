"""Payload-generic coordinated-sampling engine: one sketch container with
payload shape (cap, d) — d = 1 is a vector — one builder family, one
(P, B, S, d) bucketized layout and one merge."""
from .containers import (PAYLOAD_VARIANTS, BucketizedPayloads, PayloadSketch,
                         payload_capacity, payload_weight)
from .build import build_payload_corpus, pack_payloads
from .bucketized import (bucketize_payload_sketches,
                         merge_bucketized_payloads,
                         merged_tau_bucketized_payloads, payload_slot_probs)
from .merge import merge_payload_sketches

__all__ = ["PAYLOAD_VARIANTS", "BucketizedPayloads", "PayloadSketch",
           "payload_capacity", "payload_weight", "build_payload_corpus",
           "pack_payloads", "bucketize_payload_sketches",
           "merge_bucketized_payloads", "merged_tau_bucketized_payloads",
           "payload_slot_probs", "merge_payload_sketches"]
