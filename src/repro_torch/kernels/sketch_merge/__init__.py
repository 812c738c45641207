from .ops import merge_bucketized_corpora, merged_tau_bucketized
from .ref import merge_bucketized_ref
from .sketch_merge import merge_bucketized

__all__ = ["merge_bucketized_corpora", "merged_tau_bucketized",
           "merge_bucketized_ref", "merge_bucketized"]
