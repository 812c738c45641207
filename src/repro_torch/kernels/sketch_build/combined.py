"""Linear-time batched build of the join-correlation combined sketches
(``repro.kernels.sketch_build.combined``).

The legacy builders of ``repro_torch.core.join_correlation`` take three
full argsorts and two sorts a row (Algorithm 6).  Here each family's rank
order is resolved by the exact selection (:func:`kth_smallest_ranks`, B2
on the card): one selection over the stacked (3D, n) family ranks gives
each family's (m+1)-th smallest rank; the ranks below it are packed and
sorted, (3D, m+1); a searchsorted against them gives every entry's
position in each family's order, and q_i = min_f pos_f(i); m' (the
(m+1)-th smallest q) is a second selection.  Algorithm 5's bisection is
already linear: only its top-k packing becomes the overflow cut (B2) and
the prefix-sum pack.

Bit-equal to the reference's linear-time build
(``build_combined_*_corpus``), whose kept sets may differ from the legacy
builders' where ones-family ranks tie at the cut: tied entries get one
searchsorted position here, consecutive argsort positions there.
``use_kernel=False`` runs the kernels' plain versions on any device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.join_correlation import (CombinedSketch,
                                               _family_ranks, _threshold_core,
                                               _threshold_sample)
from repro_torch.core.sketches import default_capacity
from repro_torch.device import resolve_device

from .ops import _overflow_cut, kth_smallest_ranks, pack_kept


def _block(A, device) -> torch.Tensor:
    dev = resolve_device(device)
    return torch.atleast_2d(torch.as_tensor(A, dtype=torch.float32,
                                            device=dev))


def union_positions(ranks: torch.Tensor, m: int, *, use_kernel: bool = True):
    """(3, D, n) family ranks -> (q (D, n) float32, tops (3, D, m+1)).

    ``tops`` holds each family's m+1 smallest ranks in ascending order
    (the ranks below the (m+1)-th smallest, padded with copies of it: the
    multiset is exact under ties); q is an entry's smallest position over
    the three families' orders (positions past the tracked head are m+1,
    which the min caps).  Needs n >= m + 1."""
    F, D, n = ranks.shape
    K = m + 1
    flat = ranks.reshape(F * D, n)
    cuts = kth_smallest_ranks(flat, K, use_kernel=use_kernel)
    lt = flat < cuts[:, None]
    _, buf = pack_kept(lt, flat, K)
    js = torch.arange(K, device=ranks.device)
    buf = torch.where(js[None, :] < lt.sum(dim=1)[:, None], buf,
                      cuts[:, None])
    tops = torch.sort(buf, dim=1).values
    pos = torch.searchsorted(tops, flat, side="left", out_int32=True)
    q = pos.reshape(F, D, n).amin(dim=0).to(torch.float32)
    return q, tops.reshape(F, D, K)


def build_combined_priority_corpus(A, m: int, seed, *, device=None,
                                   use_kernel: bool = True
                                   ) -> CombinedSketch:
    """Batched linear-time Algorithm 6 over (D, n) (module docstring):
    capacity m, taus +inf and every nonzero kept where a row has at most
    m nonzeros.  Runs on ``device`` (default ``cuda``)."""
    A = _block(A, device)
    D, n = A.shape
    scale, w1, ranks = _family_ranks(A, seed)
    keep_all = (w1 > 0).sum(dim=1) <= m
    if n < m + 1:
        # nnz <= n <= m: the keep-all branch always applies
        taus = torch.full((3, D), math.inf, device=A.device)
        include = w1 > 0
    else:
        q, tops = union_positions(ranks, m, use_kernel=use_kernel)
        mp = kth_smallest_ranks(q, m + 1, use_kernel=use_kernel)
        at = mp.to(torch.int64).clamp(0, m)[None, :, None].expand(3, D, 1)
        fam = torch.gather(tops, 2, at)[..., 0]
        taus = torch.where(keep_all[None], torch.full_like(fam, math.inf),
                           fam)
        include = (w1 > 0) & (ranks < taus[..., None]).any(dim=0)
        include = torch.where(keep_all[:, None], w1 > 0, include)
    kidx, kval = pack_kept(include, A, m)
    return CombinedSketch(kidx, kval, taus[0], taus[1], taus[2], scale)


def build_combined_threshold_corpus(A, m: int, seed, *, device=None,
                                    use_kernel: bool = True
                                    ) -> CombinedSketch:
    """Batched Algorithm 5 over (D, n): the adaptive m' bisection, then
    the overflow cut and the prefix-sum pack at ``m + 4 ceil(sqrt(m))``.
    Runs on ``device`` (default ``cuda``)."""
    A = _block(A, device)
    cap = default_capacity(m)
    scale, w1, umax, mp, W = _threshold_core(A, m)
    include, scores = _threshold_sample(A, seed, w1, umax, mp)
    keep = _overflow_cut(include, scores, cap, use_kernel=use_kernel)
    kidx, kval = pack_kept(keep, A, cap)
    return CombinedSketch(kidx, kval, mp / W[0], mp / W[1], mp / W[2], scale)
