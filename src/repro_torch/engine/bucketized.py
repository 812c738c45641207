"""Payload-generic bucketized layout (DESIGN.md §18 of the reference).

One (P, B, S, d) bucket layout for every payload dimension: the positions
of the entries ride through ``bucketize_payloads`` as a float32 payload
(exact below 2^24) and the d-dim rows follow with one gather.

The merge of two bucketized batches: d = 1 dispatches to the
``kernels/sketch_merge`` kernel (or its plain version); d > 1 runs the
payload-generalized plain merge here (the same keep masks and slot
positions, payload rows scattered alongside).  The products and matrix
kernels built on this layout come with a later slice (ROADMAP step A9).
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import hash_unit
from repro_torch.core.sketches import INVALID_IDX, sampling_ranks

from .containers import BucketizedPayloads, PayloadSketch, payload_weight


def bucketize_payload_sketches(sk: PayloadSketch, *, n_buckets: int = 512,
                               slots: int = 4) -> BucketizedPayloads:
    """Re-lay a (P, cap, d) payload-sketch batch (or one (cap, d) sketch,
    lifted to P = 1) into the bucketized kernel format."""
    from repro_torch.kernels.intersect_estimate.ops import (
        DEFAULT_BUCKET_SEED, bucketize_payloads)
    if sk.idx.ndim == 1:
        sk = PayloadSketch(sk.idx[None], sk.payload[None],
                           torch.as_tensor(sk.tau,
                                           dtype=torch.float32).reshape(1))
    P, cap = sk.idx.shape
    pos = torch.arange(cap, dtype=torch.float32,
                       device=sk.idx.device).expand(P, cap)
    out_idx, (out_pos,), dropped = bucketize_payloads(
        sk.idx, (pos,), n_buckets=n_buckets, slots=slots,
        bucket_seed=DEFAULT_BUCKET_SEED)
    valid = out_idx != INVALID_IDX
    gather = out_pos.to(torch.int64).reshape(P, -1, 1).expand(
        -1, -1, sk.payload.shape[-1])
    rows = torch.gather(sk.payload.to(torch.float32), 1, gather)
    out_pay = torch.where(valid[..., None],
                          rows.reshape(*out_idx.shape, -1),
                          torch.zeros((), device=rows.device))
    return BucketizedPayloads(out_idx, out_pay,
                              torch.as_tensor(sk.tau, dtype=torch.float32
                                              ).reshape(-1),
                              dropped)


def payload_slot_probs(bc: BucketizedPayloads, *,
                       variant: str = "l2") -> torch.Tensor:
    """Per-slot inclusion probability min(1, tau * w(payload)) of a
    (P, B, S, d) batch; 1.0 at padding (w == 0)."""
    w = payload_weight(bc.payload, variant)                  # (P, B, S)
    tau = torch.as_tensor(bc.tau, dtype=torch.float32).reshape(-1, 1, 1)
    return torch.where(w > 0, torch.clamp(tau * w, max=1.0),
                       torch.ones_like(w))


def merged_tau_bucketized_payloads(A: BucketizedPayloads,
                                   B: BucketizedPayloads, seed, *, m: int,
                                   variant: str = "l2") -> torch.Tensor:
    """Per-row merged priority tau of two (D, B, S, d) batches: the (m+1)-st
    smallest rank of the union candidates (kept ranks of both sides,
    b-duplicates masked, and both published taus)."""
    from repro_torch.kernels.sketch_build.ops import kth_smallest_ranks
    D = A.idx.shape[0]

    def ranks(idx, pay):
        r = sampling_ranks(payload_weight(pay.to(torch.float32), variant),
                           hash_unit(seed, idx))
        return torch.where(idx != INVALID_IDX, r, torch.full_like(r, torch.inf))

    dup = ((B.idx[..., :, None] == A.idx[..., None, :])
           & (A.idx != INVALID_IDX)[..., None, :]).any(dim=-1)
    rb = ranks(B.idx, B.payload)
    rb = torch.where(dup, torch.full_like(rb, torch.inf), rb)
    dev = A.idx.device
    cand = torch.cat(
        [ranks(A.idx, A.payload).reshape(D, -1), rb.reshape(D, -1),
         torch.as_tensor(A.tau, dtype=torch.float32, device=dev).reshape(D, 1),
         torch.as_tensor(B.tau, dtype=torch.float32, device=dev).reshape(D, 1)],
        dim=1)
    return kth_smallest_ranks(cand, m + 1)


def _merge_payloads_oracle(a_idx, a_pay, b_idx, b_pay, tau, seed, *,
                           variant: str):
    """(D, B, S, d) x2 -> (out_idx, out_payload, dropped (D,)): the plain
    merge of ``kernels/sketch_merge`` with the payload rows carried."""
    from repro_torch.kernels.sketch_merge.ref import compact, merge_plan
    a_pay = a_pay.to(torch.float32)
    b_pay = b_pay.to(torch.float32)
    keep, pos = merge_plan(a_idx, payload_weight(a_pay, variant), b_idx,
                           payload_weight(b_pay, variant), tau, seed)
    return compact(keep, pos, a_idx.shape[2],
                   torch.cat([a_idx, b_idx], dim=2).to(torch.int32),
                   torch.cat([a_pay, b_pay], dim=2))


def merge_bucketized_payloads(A: BucketizedPayloads, B: BucketizedPayloads,
                              seed, *, m: int, variant: str = "l2",
                              tau: torch.Tensor | None = None
                              ) -> BucketizedPayloads:
    """Row-wise merge of two coordinated (D, B, S, d) bucketized batches
    (the contract of ``kernels.sketch_merge.merge_bucketized_corpora``).
    d = 1 runs the merge kernel; d > 1 the payload-generic plain merge."""
    if A.idx.shape != B.idx.shape or A.payload.shape != B.payload.shape:
        raise ValueError(f"batch layouts differ: {tuple(A.payload.shape)} "
                         f"vs {tuple(B.payload.shape)}")
    if A.payload.shape[-1] == 1:
        from repro_torch.kernels.intersect_estimate.ops import BucketizedSketch
        from repro_torch.kernels.sketch_merge.ops import \
            merge_bucketized_corpora
        out = merge_bucketized_corpora(
            BucketizedSketch(A.idx, A.payload[..., 0], A.tau, A.dropped),
            BucketizedSketch(B.idx, B.payload[..., 0], B.tau, B.dropped),
            seed, m=m, variant=variant, tau=tau)
        return BucketizedPayloads(out.idx, out.val[..., None], out.tau,
                                  out.dropped)
    if tau is None:
        tau = merged_tau_bucketized_payloads(A, B, seed, m=m, variant=variant)
    tau = torch.as_tensor(tau, dtype=torch.float32, device=A.idx.device)
    out_idx, out_pay, new_drop = _merge_payloads_oracle(
        A.idx, A.payload, B.idx, B.payload, tau, seed, variant=variant)
    return BucketizedPayloads(out_idx, out_pay, tau,
                              A.dropped + B.dropped + new_drop)
