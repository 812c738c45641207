"""The batched bucketized-corpus merge (DESIGN.md §13/§14 of the
reference), in two steps:

1. **Merged tau** — a per-row rank order statistic: ranks of every slot
   of both sides are recomputed from the stored (idx, val), b-side
   duplicates are masked by the shared-bucket compare, and the (m+1)-st
   smallest of {ranks} ∪ {tau_a, tau_b} comes from ``kth_smallest_ranks``
   — the statistic ``core.merge.merge_sketches`` uses, so the two agree.
2. **Union and compaction in the layout** — :func:`merge_bucketized` (the
   CUDA kernel for CUDA tensors) merges all D rows in one launch.

A caller may pass its own ``tau`` (a threshold merge's adaptive tau): the
kernel does not depend on how tau was chosen.  The payload-generic merged
tau lives in ``engine.bucketized``; :func:`merged_tau_bucketized` is its
d = 1 shim.
"""
from __future__ import annotations

import torch

from repro_torch import obs

from ..intersect_estimate.ops import BucketizedSketch
from .ref import merge_bucketized_ref
from .sketch_merge import merge_bucketized


def merged_tau_bucketized(A: BucketizedSketch, B: BucketizedSketch, seed, *,
                          m: int, variant: str = "l2") -> torch.Tensor:
    """Per-row merged priority tau: the (m+1)-st smallest rank of the
    union candidates (kept ranks of both sides, b-duplicates masked, and
    both published taus)."""
    from repro_torch.engine.bucketized import merged_tau_bucketized_payloads
    from repro_torch.engine.containers import BucketizedPayloads
    return merged_tau_bucketized_payloads(
        BucketizedPayloads(A.idx, A.val[..., None], A.tau, A.dropped),
        BucketizedPayloads(B.idx, B.val[..., None], B.tau, B.dropped),
        seed, m=m, variant=variant)


def merge_bucketized_corpora(A: BucketizedSketch, B: BucketizedSketch,
                             seed, *, m: int, variant: str = "l2",
                             tau: torch.Tensor | None = None,
                             use_kernel: bool = True) -> BucketizedSketch:
    """Row-wise merge of two coordinated (D, B, S) bucketized corpora.

    Row d of the result is the bucketized sketch of the union of the two
    partitions row d was built from (priority semantics unless ``tau`` is
    given).  ``dropped`` adds both inputs' counts and the entries lost
    where a merged bucket needed more than S slots.  ``use_kernel=False``
    asks for the plain version on any device."""
    if A.idx.shape != B.idx.shape:
        raise ValueError(f"corpus shapes differ: {tuple(A.idx.shape)} vs "
                         f"{tuple(B.idx.shape)}")
    obs.kernel_launch("sketch_merge.merge")
    if tau is None:
        tau = merged_tau_bucketized(A, B, seed, m=m, variant=variant)
    tau = torch.as_tensor(tau, dtype=torch.float32, device=A.idx.device)
    merge = merge_bucketized if use_kernel else merge_bucketized_ref
    out_idx, out_val, new_drop = merge(A.idx, A.val, B.idx, B.val,
                                       tau.contiguous(), seed,
                                       variant=variant)
    return BucketizedSketch(out_idx, out_val, tau,
                            A.dropped + B.dropped + new_drop)
