"""Accuracy guarantees (Theorems 1 and 3, Corollary 2, Lemma 4): the
parts of ``repro.core.variance`` that the quickstart and the serving index
use.  The bounds take full vectors (tests, benchmarks); the Chebyshev
interval needs only norms and the sketch size (production use).
"""
from __future__ import annotations

import torch


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _lead(m: int, method: str) -> float:
    return 2.0 / m if method == "threshold" else 2.0 / max(m - 1, 1)


def intersection_norms(a, b):
    """(||a_I||^2, ||b_I||^2, ||a||^2, ||b||^2) with I = supp(a) ∩ supp(b)."""
    a, b = _t(a), _t(b)
    mask = (a != 0) & (b != 0)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    return (torch.where(mask, a * a, zero).sum(),
            torch.where(mask, b * b, zero).sum(),
            (a * a).sum(), (b * b).sum())


def variance_bound(a, b, m: int, *, method: str = "threshold"):
    """Var[W] <= (2/m) max(||a_I||^2 ||b||^2, ||a||^2 ||b_I||^2)  (Thm 1);
    2/(m-1) for priority sampling (Thm 3)."""
    aI2, bI2, a2, b2 = intersection_norms(a, b)
    return _lead(m, method) * torch.maximum(aI2 * b2, a2 * bI2)


def error_guarantee(a, b, m: int, delta: float = 0.1, *,
                    method: str = "threshold"):
    """Corollary 2: with probability 1-delta, |W - <a,b>| <=
    sqrt(Var/delta)."""
    return torch.sqrt(variance_bound(a, b, m, method=method) / delta)


def linear_sketch_error(a, b, m: int, delta: float = 0.1):
    """The linear-sketch comparison scale eps ||a|| ||b||,
    eps = sqrt(2/(delta m))."""
    a, b = _t(a), _t(b)
    return torch.sqrt(2.0 / (delta * m) * (a * a).sum() * (b * b).sum())


def sketch_size_high_prob(m: int, delta: float = 0.01) -> float:
    """Lemma 4: P[|K_a| > m + sqrt(m/delta)] <= delta (threshold)."""
    return m + (m / delta) ** 0.5


def chebyshev_interval(estimate, a_norm2, b_norm2, m: int,
                       delta: float = 0.05, *, method: str = "priority"):
    """Conservative interval using ||a_I|| <= ||a||: half-width
    sqrt(lead a2 b2 / delta)."""
    half = torch.sqrt(_lead(m, method) * _t(a_norm2) * _t(b_norm2) / delta)
    return estimate - half, estimate + half


def rescaled_kept_norms(val, tau, *, sample_ndim: int = 2):
    """Per-sketch (G, N) summaries (DESIGN.md §17 of the reference): over
    the trailing ``sample_ndim`` axes of ``val`` (2 for (B, S), 1 for a flat
    sketch), ``G = sqrt(sum a^2 / p^2)`` with ``p = min(1, tau a^2)`` and
    ``N = sqrt(sum a^2)``; padding (0) contributes nothing."""
    val = _t(val)
    w = val * val
    axes = tuple(range(val.ndim - sample_ndim, val.ndim))
    tau = _t(tau).to(val.device)
    tau = tau.reshape(tuple(tau.shape) + (1,) * sample_ndim)
    p = torch.where(w > 0, torch.clamp(tau * w, max=1.0),
                    torch.ones_like(w))
    return torch.sqrt((w / (p * p)).sum(dim=axes)), torch.sqrt(w.sum(dim=axes))
