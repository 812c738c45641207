"""Inner product estimation from coordinated sketches (Algorithm 2).

``W = sum_{i in K_a ∩ K_b} a_i b_i / min(1, w(a_i) tau_a, w(b_i) tau_b)``

Sketch indices are sorted ascending, so the intersection is a
searchsorted join.  Same formulation and summation order as
``repro.core.estimator.estimate_inner_product`` (one sum over the
matched terms of ``sa``).
"""
from __future__ import annotations

import math

import torch

from .sketches import INVALID_IDX, Sketch, weight


def _match(a_idx: torch.Tensor, b_idx: torch.Tensor):
    """Join two sorted index arrays; returns (match_mask, positions_in_b)."""
    pos = torch.searchsorted(b_idx.contiguous(), a_idx.contiguous())
    pos = pos.clamp(0, b_idx.shape[-1] - 1)
    match = (torch.gather(b_idx, -1, pos) == a_idx) & (a_idx != INVALID_IDX)
    return match, pos


def _safe_mul(tau: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """tau * w with inf * 0 -> inf (zero-weight lanes are 'certain')."""
    return torch.where(w > 0, tau * w, torch.full_like(w, math.inf))


def estimate_inner_product(sa: Sketch, sb: Sketch, *,
                           variant: str = "l2") -> torch.Tensor:
    """Unbiased estimate of <a, b> from two same-seed sketches."""
    match, pos = _match(sa.idx, sb.idx)
    b_val = torch.gather(sb.val, -1, pos)
    wa = weight(sa.val, variant)
    wb = weight(b_val, variant)
    tau_a = torch.as_tensor(sa.tau, dtype=torch.float32)
    tau_b = torch.as_tensor(sb.tau, dtype=torch.float32)
    p = torch.clamp(torch.minimum(_safe_mul(tau_a, wa), _safe_mul(tau_b, wb)),
                    max=1.0)
    p = torch.where(match, p, torch.ones_like(p))
    terms = torch.where(match, sa.val * b_val / p, torch.zeros_like(p))
    return terms.sum(dim=-1)


def intersection_size(sa: Sketch, sb: Sketch) -> torch.Tensor:
    """Number of indices present in both sketches (diagnostic)."""
    match, _ = _match(sa.idx, sb.idx)
    return match.sum(dim=-1)
