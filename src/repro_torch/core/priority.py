"""Priority Sampling (Algorithm 3).

Rank ``R_i = h(i) / w_i``; keep the ``m`` smallest ranks and publish
``tau`` = the (m+1)-st smallest rank (+inf when the vector has at most
``m`` nonzeros).  ``backend="reference"`` finds tau with ``torch.topk``
over all n ranks (the parity oracle, and what ``SketchIndex.add`` uses);
``backend="kernel"`` routes through the linear-time build
(``repro_torch.kernels.sketch_build``): the fused hash/rank/histogram
kernel and the histogram descent.  Both return the same bits.
"""
from __future__ import annotations

import math

import torch

from .hashing import hash_unit
from .sketches import Sketch, sampling_ranks, select_and_pack, weight


def priority_sketch(a: torch.Tensor, m: int, seed, *, variant: str = "l2",
                    indices: torch.Tensor | None = None,
                    backend: str = "reference") -> Sketch:
    """Fixed-size-m sketch of a dense vector ``a`` (or sparse
    ``(indices, a)``: the nonzero values and their coordinates).  Runs on
    ``a``'s device."""
    if backend == "kernel":
        from repro_torch.kernels.sketch_build import build_priority_corpus
        sk = build_priority_corpus(a.to(torch.float32)[None, :], m, seed,
                                   variant=variant, indices=indices,
                                   device=a.device)
        return Sketch(idx=sk.idx[0], val=sk.val[0], tau=sk.tau[0])
    if backend != "reference":
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'reference' or 'kernel'")
    n = a.shape[0]
    dev = a.device
    idx = (torch.arange(n, dtype=torch.int32, device=dev) if indices is None
           else indices.to(device=dev, dtype=torch.int32))
    a32 = a.to(torch.float32)
    ranks = sampling_ranks(weight(a32, variant), hash_unit(seed, idx))
    k = m + 1
    if n < k:
        ranks_p = torch.cat([ranks, torch.full((k - n,), math.inf,
                                               device=dev)])
    else:
        ranks_p = ranks
    tau = torch.topk(ranks_p, k, largest=False, sorted=True).values[m]
    include = ranks < tau
    kidx, kval = select_and_pack(ranks, include, idx, a32, cap=m)
    return Sketch(idx=kidx, val=kval, tau=tau.to(torch.float32))
