"""Bucketized sketch layout and the estimation entry points.

Layout (DESIGN.md §4 of the reference): entry ``i`` of a sorted sketch
lands in bucket ``hash(i) mod B`` with at most S slots a bucket, in
coordinate order; coordinated sketches share the bucket seed, so a shared
coordinate lands in the same bucket on both sides.  The layout is
bit-identical to ``repro.kernels.intersect_estimate``'s.

Estimation entry points:

- ``query_corpus``                   one query vs a corpus (serving path)
- ``estimate_all_pairs_bucketized``  the (D1, D2) estimate matrix
- ``allpairs_moments``               (D1, D2, 6) co-moment channels

Each launches its CUDA kernel for CUDA tensors and the plain version for
CPU tensors; ``use_kernel=False`` asks for the plain version explicitly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.hashing import hash_bucket
from repro_torch.core.sketches import INVALID_IDX, Sketch

from .intersect_estimate import allpairs_estimate, intersect_estimate
from .ref import allpairs_estimate_ref, intersect_estimate_ref

DEFAULT_BUCKET_SEED = 0xB0C4


class BucketizedSketch(NamedTuple):
    idx: torch.Tensor      # int32 (B, S) or (C, B, S)
    val: torch.Tensor      # float32, same shape
    tau: torch.Tensor      # float32 scalar or (C,)
    dropped: torch.Tensor  # int32 scalar or (C,): bucket-overflow losses


def round_up_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def bucketize_payloads(idx: torch.Tensor, payloads: tuple, *,
                       n_buckets: int = 512, slots: int = 4,
                       bucket_seed: int = DEFAULT_BUCKET_SEED):
    """Re-lay sorted index rows and per-entry payloads into (B, S).

    ``idx``: (cap,) or (C, cap) int32; each payload the same shape.
    Returns ``(out_idx (..., B, S) int32, tuple of (..., B, S) float32
    payloads, dropped (...) int32)``.  Entries beyond S in a bucket are
    dropped and counted; a dropped entry is written nowhere (it never
    clobbers another cell).
    """
    one = idx.ndim == 1
    if one:
        idx = idx[None]
        payloads = tuple(p[None] for p in payloads)
    C, cap = idx.shape
    dev = idx.device
    valid = idx != INVALID_IDX
    b = torch.where(valid, hash_bucket(bucket_seed, idx, n_buckets),
                    n_buckets).to(torch.int64)  # invalid -> sentinel bucket
    order = torch.argsort(b, dim=1, stable=True)
    b_sorted = torch.gather(b, 1, order)
    # position within the bucket = rank - first rank of this bucket value
    first = torch.searchsorted(b_sorted, b_sorted, side="left")
    pos = torch.arange(cap, device=dev)[None, :] - first
    keep = (b_sorted < n_buckets) & (pos < slots)
    cells = n_buckets * slots
    flat = torch.where(keep, b_sorted * slots + pos,
                       torch.full_like(pos, cells))   # extra, discarded cell
    out_idx = torch.full((C, cells + 1), INVALID_IDX, dtype=torch.int32,
                         device=dev)
    out_idx.scatter_(1, flat, torch.gather(idx.to(torch.int32), 1, order))
    outs = []
    for p in payloads:
        out = torch.zeros((C, cells + 1), dtype=torch.float32, device=dev)
        out.scatter_(1, flat, torch.gather(p.to(torch.float32), 1, order))
        outs.append(out[:, :cells].reshape(C, n_buckets, slots).contiguous())
    dropped = (valid.sum(dim=1) - keep.sum(dim=1)).to(torch.int32)
    out_idx = out_idx[:, :cells].reshape(C, n_buckets, slots).contiguous()
    if one:
        return out_idx[0], tuple(o[0] for o in outs), dropped[0]
    return out_idx, tuple(outs), dropped


def bucketize(sketch: Sketch, *, n_buckets: int = 512, slots: int = 4,
              bucket_seed: int = DEFAULT_BUCKET_SEED) -> BucketizedSketch:
    """Re-lay a sorted sketch (or a (C, cap) batch) into (B, S) buckets."""
    out_idx, (out_val,), dropped = bucketize_payloads(
        sketch.idx, (sketch.val,), n_buckets=n_buckets, slots=slots,
        bucket_seed=bucket_seed)
    return BucketizedSketch(out_idx, out_val,
                            torch.as_tensor(sketch.tau, dtype=torch.float32),
                            dropped)


def bucketize_corpus(sketches: Sketch, **kw) -> BucketizedSketch:
    """Bucketize a (C, cap) corpus of sketches."""
    return bucketize(sketches, **kw)


def slot_inclusion_probs(bc: BucketizedSketch, *,
                         variant: str = "l2") -> torch.Tensor:
    """Per-slot inclusion probability min(1, tau * w(val)) of a (C, B, S)
    corpus; 1.0 at padding (w == 0), so an inf tau never gives NaN."""
    from repro_torch.engine.bucketized import payload_slot_probs
    from repro_torch.engine.containers import BucketizedPayloads
    return payload_slot_probs(
        BucketizedPayloads(bc.idx, bc.val[..., None], bc.tau, bc.dropped),
        variant=variant)


def query_corpus(q: BucketizedSketch, corpus: BucketizedSketch, *,
                 use_kernel: bool = True) -> torch.Tensor:
    """(C,) inner-product estimates of one query against a corpus."""
    obs.kernel_launch("intersect_estimate.query")
    if not use_kernel:
        return intersect_estimate_ref(q.idx, q.val, q.tau, corpus.idx,
                                      corpus.val, corpus.tau)
    return intersect_estimate(q.idx, q.val, q.tau, corpus.idx, corpus.val,
                              corpus.tau)


def estimate_all_pairs_bucketized(A: BucketizedSketch, B: BucketizedSketch,
                                  *, variant: str = "l2",
                                  ref_chunk: int | None = None,
                                  use_kernel: bool = True) -> torch.Tensor:
    """(D1, B, S) x (D2, B, S) bucketized corpora -> (D1, D2) estimates
    (on the card: the compaction pass, then one join launch).
    ``ref_chunk`` chunks the plain version's corpus side (intermediates
    (D1, ref_chunk, B))."""
    obs.kernel_launch("intersect_estimate.allpairs")
    a_p = slot_inclusion_probs(A, variant=variant)
    # one corpus against itself (all_pairs) is compacted once on the card
    b_p = a_p if B is A else slot_inclusion_probs(B, variant=variant)
    if not use_kernel:
        return allpairs_estimate_ref(A.idx, A.val, a_p, B.idx, B.val, b_p,
                                     ct=ref_chunk)
    return allpairs_estimate(A.idx, A.val, a_p, B.idx, B.val, b_p)


def allpairs_moments(a_idx, a_val, a_p, b_idx, b_val, b_p, *,
                     ref_chunk: int | None = None,
                     use_kernel: bool = True) -> torch.Tensor:
    """(D1, D2, 6) co-moment channels (``MOMENT_CHANNELS`` order) with
    caller-supplied per-slot inclusion probabilities — the join-correlation
    all-pairs path (DESIGN.md §7, §12 of the reference)."""
    obs.kernel_launch("intersect_estimate.moments")
    if not use_kernel:
        return allpairs_estimate_ref(a_idx, a_val, a_p, b_idx, b_val, b_p,
                                     moments=True, ct=ref_chunk)
    return allpairs_estimate(a_idx, a_val, a_p, b_idx, b_val, b_p,
                             moments=True)
