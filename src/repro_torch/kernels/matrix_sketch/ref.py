"""Plain PyTorch version of the batched matrix-product kernel
(``csrc/matrix_sketch.cu``).

Same contract and per-pair arithmetic as ``repro.kernels.matrix_sketch``
(``pair_product_body``): padding ids are remapped to -1 on the A side and
-2 on the B side so they never match, each slot pair (sa, sb) of a bucket
contributes ``max(1/p_a, 1/p_b) * a_row ⊗ b_row`` where the ids are
equal, and the S x S slot pairs are summed in the reference's order, one
batched (d_a, B) x (B, d_b) float32 product each.  The A side may have a
leading dim of 1 (one query against every pair's B side).
"""
from __future__ import annotations

import torch

from repro_torch.core.sketches import INVALID_IDX


def matrix_products_ref(a_idx, a_rows, a_p, b_idx, b_rows, b_p
                        ) -> torch.Tensor:
    """(Pa, B, S) ids, (Pa, B, S, d_a) rows and (Pa, B, S) inclusion
    probabilities (1.0 at padding) for A with Pa in {1, P}; the same with
    (P, ...) and d_b for B -> (P, d_a, d_b) float32 estimates."""
    S = a_idx.shape[-1]
    P = b_idx.shape[0]
    ai = torch.where(a_idx == INVALID_IDX, -1, a_idx).expand(P, -1, -1)
    bi = torch.where(b_idx == INVALID_IDX, -2, b_idx)
    arows = a_rows.to(torch.float32).expand(P, -1, -1, -1)
    brows = b_rows.to(torch.float32)
    ar = (1.0 / a_p).expand(P, -1, -1)
    br = 1.0 / b_p
    acc = torch.zeros((P, arows.shape[-1], brows.shape[-1]),
                      dtype=torch.float32, device=brows.device)
    for sa in range(S):
        for sb in range(S):
            eq = ai[:, :, sa] == bi[:, :, sb]                     # (P, B)
            c = torch.where(eq, torch.maximum(ar[:, :, sa], br[:, :, sb]),
                            torch.zeros_like(br[:, :, sb]))
            acc = acc + torch.bmm(
                (arows[:, :, sa, :] * c[..., None]).transpose(1, 2),
                brows[:, :, sb, :])
    return acc
