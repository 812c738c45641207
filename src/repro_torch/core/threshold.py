"""Threshold Sampling (Algorithm 1) with adaptive threshold selection
(Algorithm 4).

Entry ``i`` is kept iff ``h(i) <= tau * w_i`` where ``w_i`` is the
sampling weight (``a_i^2``, ``|a_i|`` or ``1[a_i != 0]``) and
``tau = m'/W``.  Algorithm 4's ``m'`` makes the expected sketch size
``sum_i min(1, tau w_i)`` equal ``min(m, nnz)``; as in
``repro.core.threshold`` it is found in closed form: with exactly ``k``
entries capped at probability 1, ``tau_k = (m - k) / suffix_k`` (the
weight below the k largest), and the valid ``k`` is the first one whose
next entry is uncapped and whose previous one is capped.

``backend="reference"`` sorts all n weights (the parity oracle);
``backend="kernel"`` routes through the linear-time build
(``repro_torch.kernels.sketch_build.build_threshold_corpus``): the
hash/rank kernel, a histogram selection of the top-m weights and the
prefix-sum pack.  The kept sets are the same; tau may differ by the
rounding of sums taken over other sets of terms.

**Summation order.**  The suffix sums are float32 scans in the order of
the reference's own ``jnp.cumsum`` on the CPU (XLA's: sequential within
blocks of 16, the block totals scanned the same way and added), so they
give the reference's bits on any device — :func:`suffix_sums`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .hashing import hash_unit
from .sketches import (Sketch, default_capacity, flush_subnormal,
                       sampling_ranks, select_and_pack, weight)

_SCAN_BLOCK = 16


def _cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumsum along the last axis, in XLA's CPU order."""
    K = x.shape[-1]
    if K <= _SCAN_BLOCK:
        cols = [x[..., 0]]
        for i in range(1, K):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    nb = -(-K // _SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * _SCAN_BLOCK - K)).reshape(
        *x.shape[:-1], nb, _SCAN_BLOCK)
    within = _cumsum_f32(blocks)
    totals = _cumsum_f32(within[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]],
                       dim=-1)
    out = within + before[..., None]
    return out.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :K]


def suffix_sums(x: torch.Tensor) -> torch.Tensor:
    """``suffix[..., k] = sum(x[..., k:])`` in float32, summed from the
    smallest end (the reversed cumsum of the reference)."""
    return _cumsum_f32(x.flip(-1)).flip(-1)


def _tau_from_sorted(w_sorted: torch.Tensor, suffix: torch.Tensor, m: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The closed form over descending weights ``w_sorted`` (..., K) and
    their suffix sums: (tau of the first valid k, whether one is valid)."""
    K = w_sorted.shape[-1]
    ks_i = torch.arange(K, device=w_sorted.device)
    ks = ks_i.to(torch.float32)
    tau_k = torch.where(suffix > 0,
                        (m - ks) / torch.where(suffix > 0, suffix,
                                               torch.ones_like(suffix)),
                        torch.full_like(suffix, torch.inf))
    # XLA flushes a subnormal quotient; so does the port
    tau_k = flush_subnormal(tau_k)
    not_capped_next = tau_k * w_sorted < 1.0
    w_prev = torch.cat([w_sorted[..., :1], w_sorted[..., :-1]], dim=-1)
    capped_prev = torch.where(ks_i > 0, tau_k * w_prev >= 1.0 - 1e-6,
                              torch.ones_like(not_capped_next))
    valid = not_capped_next & capped_prev & (m - ks > 0)
    k_star = torch.argmax(valid.to(torch.int32), dim=-1, keepdim=True)
    return (torch.gather(tau_k, -1, k_star)[..., 0],
            valid.any(dim=-1))


def _tau_all(w: torch.Tensor) -> torch.Tensor:
    """1 / (min nonzero weight): every entry capped (+inf without one)."""
    w_min_nz = torch.where(w > 0, w, torch.full_like(w, torch.inf)).amin(-1)
    return torch.where(torch.isfinite(w_min_nz), 1.0 / w_min_nz,
                       torch.full_like(w_min_nz, torch.inf))


def adaptive_tau(w: torch.Tensor, m: int) -> torch.Tensor:
    """Inclusion scale ``tau`` with E[sketch size] == min(m, nnz), from
    nonnegative weights ``w`` (..., n) by one descending sort of all n.
    ``nnz <= m`` keeps everything (tau = 1 / min nonzero weight); when no
    k is valid (rounding) the plain scale m / W is the fallback."""
    nnz = (w > 0).sum(-1)
    W = w.sum(-1)
    w_sorted = torch.sort(w, dim=-1, descending=True).values
    tau, any_valid = _tau_from_sorted(w_sorted, suffix_sums(w_sorted), m)
    tau = torch.where(any_valid, tau,
                      torch.where(W > 0, m / W, torch.zeros_like(W)))
    return flush_subnormal(torch.where(nnz <= m, _tau_all(w), tau))


def threshold_sketch(a: torch.Tensor, m: int, seed, *, variant: str = "l2",
                     cap: int | None = None, adaptive: bool = True,
                     indices: torch.Tensor | None = None,
                     backend: str = "reference") -> Sketch:
    """Algorithm 1 (+ Algorithm 4 when ``adaptive``) of a dense vector
    ``a`` (or sparse ``(indices, a)``).  ``adaptive=False`` uses the plain
    scale m / W.  ``cap`` (default ``m + 4 ceil(sqrt(m))``) bounds the
    size; on overflow the entries of smallest rank h / w are kept.  Runs on
    ``a``'s device."""
    if backend == "kernel":
        from repro_torch.kernels.sketch_build import build_threshold_corpus
        sk = build_threshold_corpus(a.to(torch.float32)[None, :], m, seed,
                                    variant=variant, cap=cap,
                                    adaptive=adaptive, indices=indices,
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
    w = weight(a32, variant)
    if adaptive:
        tau = adaptive_tau(w, m)
    else:
        W = w.sum()
        tau = flush_subnormal(torch.where(W > 0, m / W, torch.zeros_like(W)))
    h = hash_unit(seed, idx)
    include = (w > 0) & (h <= tau * w)
    if cap is None:
        cap = default_capacity(m)
    kidx, kval = select_and_pack(sampling_ranks(w, h), include, idx, a32,
                                 cap)
    return Sketch(idx=kidx, val=kval, tau=tau.to(torch.float32))
