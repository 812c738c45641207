"""Payload-generic unbiased product estimation (Algorithm 2; DESIGN.md
§18 of the reference).

``est = sum_{i in K_a ∩ K_b} a_i b_i^T / min(1, tau_a w^a_i, tau_b w^b_i)``

Both sketch kinds publish ``tau`` such that entry ``i`` survives in both
sketches iff ``h(i) <= min(tau_a w^a_i, tau_b w^b_i)`` (the hash is
shared), so the joint inclusion probability is the same for scalars and
rows: only the per-match payload changes from a scalar product (d = 1,
the paper's inner product) to a rank-one outer product (``A^T B``).

``reduction`` picks the formulation:

- ``"sum"``    — the vector form ``sum(a * b / p)``; d must be 1;
  returns a scalar per sketch;
- ``"matmul"`` — the matrix form ``(a * 1/p)^T @ b``; returns (d_a, d_b);
- ``"auto"``   — ``"sum"`` when both payloads are d = 1, else ``"matmul"``.

The join is a searchsorted of one sorted id row into the other.  Unlike
the reference (single sketches, batched with ``vmap``), any leading batch
dims are taken as they are: (..., cap) ids pair up row by row.  The
matmul runs in float32 (``torch.matmul``; TF32 stays off).
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.sketches import INVALID_IDX

from .containers import PayloadSketch, payload_weight

REDUCTIONS = ("auto", "sum", "matmul")


def _match(a_idx: torch.Tensor, b_idx: torch.Tensor):
    """Join two sorted id rows (same leading dims): (match mask,
    positions in b), both shaped like ``a_idx``."""
    cap_b = b_idx.shape[-1]
    lead = torch.broadcast_shapes(a_idx.shape[:-1], b_idx.shape[:-1])
    a = a_idx.expand(*lead, a_idx.shape[-1]).contiguous()
    b = b_idx.expand(*lead, cap_b).contiguous()
    pos = torch.searchsorted(b, a).clamp(0, cap_b - 1)
    match = (torch.gather(b, -1, pos) == a) & (a != INVALID_IDX)
    return match, pos


def _safe_mul(tau: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """tau * w with inf * 0 -> inf (zero-weight lanes are 'certain')."""
    return torch.where(w > 0, tau * w, torch.full_like(w, torch.inf))


def estimate_product(sa: PayloadSketch, sb: PayloadSketch, *,
                     variant: str = "l2",
                     reduction: str = "auto") -> torch.Tensor:
    """Unbiased estimate of the payload product of two same-seed sketches
    (weights recomputed from the stored payloads with ``variant``, which
    must match construction).  A scalar per sketch under ``"sum"``, a
    (d_a, d_b) matrix per sketch under ``"matmul"``."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}; "
                         f"expected one of {REDUCTIONS}")
    if reduction == "auto":
        reduction = "sum" if (sa.dim == 1 and sb.dim == 1) else "matmul"
    if reduction == "sum" and (sa.dim != 1 or sb.dim != 1):
        raise ValueError(
            "reduction='sum' is the d=1 (vector) formulation; got payload "
            f"dims {sa.dim} x {sb.dim}; use 'matmul'")
    with obs.op("engine.estimate_product") as sp:
        sp.set("reduction", reduction)
        match, pos = _match(sa.idx, sb.idx)
        lead = match.shape[:-1]
        b_pay = torch.gather(
            sb.payload.expand(*lead, *sb.payload.shape[-2:]), -2,
            pos[..., None].expand(*pos.shape, sb.dim))    # aligned with a
        a_pay = sa.payload.expand(*lead, *sa.payload.shape[-2:])
        wa = payload_weight(a_pay, variant)
        wb = payload_weight(b_pay, variant)
        ta = torch.as_tensor(sa.tau, dtype=torch.float32,
                             device=wa.device)[..., None]
        tb = torch.as_tensor(sb.tau, dtype=torch.float32,
                             device=wa.device)[..., None]
        # min(1, tau_a w_a, tau_b w_b); an inf tau gives inf -> 1 on a
        # positive weight; padding lanes are masked below
        p = torch.clamp(torch.minimum(_safe_mul(ta, wa), _safe_mul(tb, wb)),
                        max=1.0)
        one = torch.ones_like(p)
        if reduction == "sum":
            p = torch.where(match, p, one)
            terms = torch.where(match, a_pay[..., 0] * b_pay[..., 0] / p,
                                torch.zeros_like(p))
            return terms.sum(dim=-1)
        coeff = torch.where(match, one / torch.where(match, p, one),
                            torch.zeros_like(p))
        return torch.matmul((a_pay * coeff[..., None]).transpose(-1, -2),
                            b_pay)


def payload_intersection_size(sa: PayloadSketch,
                              sb: PayloadSketch) -> torch.Tensor:
    """Number of ids present in both sketches (diagnostic)."""
    match, _ = _match(sa.idx, sb.idx)
    return match.sum(dim=-1)
