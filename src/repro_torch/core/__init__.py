"""Core sketching primitives: hashing, the sketch container, priority
sampling (Algorithm 3) and the Algorithm 2 estimator."""
from .hashing import (GOLDEN, UNIT, fold_seed, hash_bucket, hash_sign,
                      hash_u32, hash_unit, mix32)
from .sketches import (INVALID_IDX, Sketch, default_capacity,
                       flush_subnormal, sampling_ranks, select_and_pack,
                       weight)
from .priority import priority_sketch
from .estimator import estimate_inner_product, intersection_size

__all__ = ["GOLDEN", "UNIT", "fold_seed", "hash_bucket", "hash_sign",
           "hash_u32", "hash_unit", "mix32", "INVALID_IDX", "Sketch",
           "default_capacity", "flush_subnormal", "sampling_ranks",
           "select_and_pack", "weight", "priority_sketch",
           "estimate_inner_product", "intersection_size"]
