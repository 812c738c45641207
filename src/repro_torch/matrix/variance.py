"""Frobenius-norm accuracy guarantees for the matrix-product estimator
(a port of ``repro.matrix.variance``).

Summing the vector bound (Theorems 1/3) over the (j, k) output entries
gives Frobenius norms:

    E ||est - A^T B||_F^2  <=  (2/m) max(||A_I||_F^2 ||B||_F^2,
                                         ||A||_F^2 ||B_I||_F^2)

with ``I`` the rows where both matrices are nonzero.  Linear sketches (JL
or CountSketch at equal bytes) compare at ``eps ||A||_F ||B||_F`` with the
full norms.  Inputs are (n, d) tensors; every helper computes in the
input's dtype on its device (pass float64 for the exact side of a check).
"""
from __future__ import annotations

import torch


def intersection_frobenius(A: torch.Tensor, B: torch.Tensor):
    """(||A_I||_F^2, ||B_I||_F^2, ||A||_F^2, ||B||_F^2) with
    I = {i : A_i != 0 and B_i != 0} (rows)."""
    mask = (A != 0).any(dim=1) & (B != 0).any(dim=1)
    a2 = (A * A).sum()
    b2 = (B * B).sum()
    aI2 = torch.where(mask[:, None], A * A, torch.zeros_like(A)).sum()
    bI2 = torch.where(mask[:, None], B * B, torch.zeros_like(B)).sum()
    return aI2, bI2, a2, b2


def frobenius_variance_bound(A: torch.Tensor, B: torch.Tensor, m: int, *,
                             method: str = "threshold") -> torch.Tensor:
    """(2/m) max(||A_I||_F^2 ||B||_F^2, ||A||_F^2 ||B_I||_F^2); priority
    uses 2/(m-1), like Theorem 3."""
    aI2, bI2, a2, b2 = intersection_frobenius(A, B)
    lead = 2.0 / m if method == "threshold" else 2.0 / max(m - 1, 1)
    return lead * torch.maximum(aI2 * b2, a2 * bI2)


def frobenius_error_guarantee(A: torch.Tensor, B: torch.Tensor, m: int,
                              delta: float = 0.1, *,
                              method: str = "threshold") -> torch.Tensor:
    """With probability 1 - delta, ``||est - A^T B||_F <= sqrt(bound /
    delta)`` (Markov on the squared Frobenius error, Corollary 2)."""
    return torch.sqrt(frobenius_variance_bound(A, B, m, method=method)
                      / delta)


def jl_frobenius_error(A: torch.Tensor, B: torch.Tensor, k: int,
                       delta: float = 0.1) -> torch.Tensor:
    """Comparison scale of a k-row linear sketch: eps ||A||_F ||B||_F with
    eps = sqrt(2 / (delta k)), the matrix analogue of Eq. (1)."""
    a2 = (A * A).sum()
    b2 = (B * B).sum()
    return torch.sqrt(2.0 / (delta * k) * a2 * b2)


def matrix_sketch_bytes(m: int, d: int) -> int:
    """Storage of one matrix sketch: m rows of d float32 values plus one
    int32 row id each."""
    return m * (4 * d + 4)

