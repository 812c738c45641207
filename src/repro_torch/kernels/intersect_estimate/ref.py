"""Plain PyTorch versions of the bucketized intersection estimators.

Same arithmetic as the CUDA kernels and as ``repro.kernels
.intersect_estimate.ref``: the query estimator uses the divide form
``q*c / min(pq, pc)``, the all-pairs estimator the reciprocal-max form
``va*vb*max(1/pa, 1/pb)`` with padding remapped to -1 / -2 (the two are not
bit-identical).  ``ct`` chunks the corpus side of the all-pairs version so
its intermediates are (D1, ct, B), not (D1, D2, B).
"""
from __future__ import annotations

import torch

from repro_torch.core.sketches import INVALID_IDX

MOMENT_CHANNELS = ("n", "sum_x", "sum_y", "xy", "sum_x2", "sum_y2")


def intersect_estimate_ref(q_idx, q_val, q_tau, c_idx, c_val, c_tau
                           ) -> torch.Tensor:
    """(B, S) query vs (C, B, S) corpus -> (C,) estimates."""
    qv = q_val.to(torch.float32)
    cv = c_val.to(torch.float32)
    pq = torch.clamp(q_tau * (qv * qv), max=1.0)                  # (B, S)
    pc = torch.clamp(c_tau.reshape(-1, 1, 1) * (cv * cv), max=1.0)
    # (C, B, Sq, Sc) equality of query slot sq with corpus slot sc
    eq = ((q_idx[None, :, :, None] == c_idx[:, :, None, :])
          & (q_idx != INVALID_IDX)[None, :, :, None])
    p = torch.minimum(pq[None, :, :, None], pc[:, :, None, :])
    p = torch.where(eq, p, torch.ones_like(p))
    terms = qv[None, :, :, None] * cv[:, :, None, :] / p
    terms = torch.where(eq, terms, torch.zeros_like(terms))
    return terms.sum(dim=(1, 2, 3))


def _allpairs_block(a_idx, av, ar, b_idx, bv, br, moments: bool):
    D1, B, S = a_idx.shape
    D2 = b_idx.shape[0]
    n_ch = len(MOMENT_CHANNELS) if moments else 1
    acc = [torch.zeros((D1, D2), dtype=torch.float32, device=av.device)
           for _ in range(n_ch)]
    for sq in range(S):
        ai = a_idx[:, :, sq][:, None, :]                          # (D1, 1, B)
        va = av[:, :, sq][:, None, :]
        ra = ar[:, :, sq][:, None, :]
        for sc in range(S):
            bi = b_idx[:, :, sc][None, :, :]                      # (1, D2, B)
            vb = bv[:, :, sc][None, :, :]
            rb = br[:, :, sc][None, :, :]
            eq = ai == bi                                         # (D1, D2, B)
            if moments:
                inv = torch.where(eq, torch.maximum(ra, rb),
                                  torch.zeros((), device=av.device))
                acc[0] += inv.sum(dim=2)
                acc[1] += (va * inv).sum(dim=2)
                acc[2] += (vb * inv).sum(dim=2)
                acc[3] += (va * vb * inv).sum(dim=2)
                acc[4] += (va * va * inv).sum(dim=2)
                acc[5] += (vb * vb * inv).sum(dim=2)
            else:
                terms = va * vb * torch.maximum(ra, rb)
                acc[0] += torch.where(eq, terms,
                                      torch.zeros((), device=av.device)
                                      ).sum(dim=2)
    return torch.stack(acc, dim=-1) if moments else acc[0]


def allpairs_estimate_ref(a_idx, a_val, a_p, b_idx, b_val, b_p, *,
                          moments: bool = False,
                          ct: int | None = None) -> torch.Tensor:
    """(D1, B, S) x (D2, B, S) corpora with per-slot inclusion
    probabilities -> (D1, D2) estimates, or (D1, D2, 6) co-moment channels
    (``MOMENT_CHANNELS`` order) when ``moments``.  ``ct`` chunks D2."""
    av = a_val.to(torch.float32)
    bv = b_val.to(torch.float32)
    ar = 1.0 / a_p
    br = 1.0 / b_p
    a_idx = torch.where(a_idx == INVALID_IDX, -1, a_idx)
    b_idx = torch.where(b_idx == INVALID_IDX, -2, b_idx)
    D2 = b_idx.shape[0]
    ct = D2 if not ct else ct
    return torch.cat([_allpairs_block(a_idx, av, ar, b_idx[j:j + ct],
                                      bv[j:j + ct], br[j:j + ct], moments)
                      for j in range(0, D2, ct)], dim=1)
