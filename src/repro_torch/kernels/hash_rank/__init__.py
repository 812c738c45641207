from .hash_rank import hash_rank, hash_rank_batched
from .ref import hash_rank_batched_ref, hash_rank_ref

__all__ = ["hash_rank", "hash_rank_batched", "hash_rank_batched_ref",
           "hash_rank_ref"]
