"""Payload-generic bucketized layout (DESIGN.md §18 of the reference).

One (P, B, S, d) bucket layout for every payload dimension: the positions
of the entries ride through ``bucketize_payloads`` as a float32 payload
(exact below 2^24) and the d-dim rows follow with one gather.  The
products, merge and matrix kernels built on this layout come with later
slices (ROADMAP steps A8, A9).
"""
from __future__ import annotations

import torch

from repro_torch.core.sketches import INVALID_IDX

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
