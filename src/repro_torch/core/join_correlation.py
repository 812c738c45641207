"""Join-correlation estimation from combined sketches (Section 4 of the
paper; ``repro.core.join_correlation``).

The post-join Pearson correlation of two columns is a rational function of
six inner products of the derived vectors (1_a, a, a^2) x (1_b, b, b^2)
(Eq. 9).  The optimized sampling sketches (Algorithms 5 and 6) keep one
sample set, chosen with the largest of the three families' probabilities,
and one tau a family; all six estimates come from that one sketch.

Weights and ranks use ``a / max|a|`` (a^4 overflows float32 beyond ~3e9),
and the taus live in that normalized space beside ``scale``; probabilities
do not depend on the scale.

**Flush to zero.**  XLA flushes float32 subnormals and reads subnormal
inputs as zero; PyTorch keeps them.  The normalized weights, the
per-family probabilities and a subnormal input are flushed here wherever
the reference's value would be 0, so a heavy-tailed column (most of its
``(a/scale)^4`` below the normal range) keeps the reference's sample.

Two priority routes keep different sets when ones-family ranks tie at
the cut (the 24-bit hash unit makes ties common at n = 2^18):
:func:`combined_priority_sketch` (three stable argsorts, the reference's
legacy builder) and ``kernels.build_combined_priority_corpus`` (one
selection and searchsorted positions, the reference's linear-time build).
Each is bit-equal to its own reference route.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

from .batched import _every_pair
from .hashing import hash_unit
from .sketches import (INVALID_IDX, default_capacity, flush_subnormal,
                       select_and_pack)

BISECT_ITERS = 50   # Algorithm 5's bisection steps on m'


class CombinedSketch(NamedTuple):
    """Algorithms 5/6 sketch: one sample, three per-family taus."""

    idx: torch.Tensor       # int32[..., cap], sorted ascending
    val: torch.Tensor       # float32[..., cap], original-scale values
    tau_ones: torch.Tensor  # float32[...], normalized-space inclusion scales
    tau_val: torch.Tensor
    tau_sq: torch.Tensor
    scale: torch.Tensor     # float32[...], the max |a| of normalization

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]

    def size(self) -> torch.Tensor:
        return (self.idx != INVALID_IDX).sum(dim=-1)


def _normalized_weights(A: torch.Tensor):
    """(..., n) -> (scale (...,), w_ones, w_val, w_sq (..., n)): the three
    families' weights on ``A / max|A|``, with XLA's flush to zero."""
    A = flush_subnormal(A)
    scale = torch.clamp(A.abs().amax(dim=-1), min=1e-30)
    an = flush_subnormal(A / scale[..., None])
    w_ones = (A != 0).to(torch.float32)
    w_val = flush_subnormal(an * an)
    w_sq = flush_subnormal(w_val * w_val)
    return scale, w_ones, w_val, w_sq


def _ranks_of(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The legacy builders' ranks: ``h / max(w, 1e-30)``, +inf where w is
    0 (weights are at most 1, so a rank is never subnormal)."""
    return torch.where(w > 0, h / torch.clamp(w, min=1e-30),
                       torch.full_like(w, math.inf))


def _family_ranks(A: torch.Tensor, seed):
    """(D, n) -> (scale (D,), w_ones (D, n), ranks (3, D, n)) in family
    order ones, val, sq."""
    scale, w1, wv, ws = _normalized_weights(A)
    h = hash_unit(seed, torch.arange(A.shape[-1], dtype=torch.int32,
                                     device=A.device))[None]
    return scale, w1, torch.stack([_ranks_of(h, w) for w in (w1, wv, ws)])


def _threshold_core(A: torch.Tensor, m: int):
    """Algorithm 5's adaptive m' for each row of a (D, n) block: the
    bisection on ``sum(min(1, m' u_max)) == min(m, nnz)``, float32 as the
    reference.  -> (scale, w_ones, u_max, m', (W_ones, W_val, W_sq))."""
    scale, w1, wv, ws = _normalized_weights(A)
    nnz = w1.sum(dim=1)
    W = [torch.clamp(x, min=1e-30) for x in (nnz, wv.sum(dim=1),
                                             ws.sum(dim=1))]
    umax = torch.maximum(
        flush_subnormal(w1 / W[0][:, None]),
        torch.maximum(flush_subnormal(wv / W[1][:, None]),
                      flush_subnormal(ws / W[2][:, None])))
    target = torch.clamp(nnz, max=float(m))
    lo = torch.zeros_like(nnz)
    hi = torch.clamp(W[0], min=1.0)  # m' = nnz: every entry certain
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        too_small = torch.clamp(mid[:, None] * umax, max=1.0).sum(dim=1) \
            < target
        lo = torch.where(too_small, mid, lo)
        hi = torch.where(too_small, hi, mid)
    return scale, w1, umax, 0.5 * (lo + hi), W


def _threshold_sample(A: torch.Tensor, seed, w1, umax, mp):
    """Algorithm 5's inclusion test and the overflow scores of each row."""
    h = hash_unit(seed, torch.arange(A.shape[-1], dtype=torch.int32,
                                     device=A.device))[None]
    T = torch.clamp(mp[:, None] * umax, max=1.0)
    include = (w1 > 0) & (h <= T)
    scores = torch.where(w1 > 0, h / torch.clamp(umax, min=1e-30),
                         torch.full_like(umax, math.inf))
    return include, scores


def _legacy_threshold(A: torch.Tensor, m: int, seed) -> CombinedSketch:
    scale, w1, umax, mp, W = _threshold_core(A, m)
    include, scores = _threshold_sample(A, seed, w1, umax, mp)
    idx = torch.arange(A.shape[-1], dtype=torch.int32,
                       device=A.device).expand(A.shape)
    kidx, kval = select_and_pack(scores, include, idx, A,
                                 default_capacity(m))
    return CombinedSketch(kidx, kval, mp / W[0], mp / W[1], mp / W[2], scale)


def _legacy_priority(A: torch.Tensor, m: int, seed) -> CombinedSketch:
    """Algorithm 6 with the exact-m' closed form on each row of (D, n):
    with pos_f(i) the position of i in family f's rank order (stable) and
    q_i = min_f pos_f(i), m' = sorted(q)[m] and each family's tau is its
    m'-th smallest rank."""
    D, n = A.shape
    dev = A.device
    scale, w1, ranks = _family_ranks(A, seed)
    nnz = (w1 > 0).sum(dim=1)
    ar = torch.arange(n, dtype=torch.int32, device=dev).expand(3, D, n)
    order = torch.argsort(ranks, dim=-1, stable=True)
    pos = torch.empty((3, D, n), dtype=torch.int32,
                      device=dev).scatter_(-1, order, ar)
    q = pos.amin(dim=0)
    mp = torch.sort(q, dim=-1).values[:, min(m, n - 1)]
    at = mp.clamp(0, n - 1).to(torch.int64)[None, :, None].expand(3, D, 1)
    fam = torch.gather(torch.sort(ranks, dim=-1).values, -1, at)[..., 0]
    keep_all = nnz <= m
    taus = torch.where(keep_all[None], torch.full_like(fam, math.inf), fam)
    include = (w1 > 0) & (ranks < taus[..., None]).any(dim=0)
    include = torch.where(keep_all[:, None], w1 > 0, include)
    scores = ranks.amin(dim=0)
    kidx, kval = select_and_pack(scores, include, ar[0], A, cap=m)
    return CombinedSketch(kidx, kval, taus[0], taus[1], taus[2], scale)


def _one_row(fn, a, *args) -> CombinedSketch:
    a = torch.as_tensor(a, dtype=torch.float32)
    return CombinedSketch(*(f[0] for f in fn(a[None], *args)))


def combined_threshold_sketch(a: torch.Tensor, m: int, seed
                              ) -> CombinedSketch:
    """Algorithm 5 with adaptive m' (bisection so E[size] == min(m, nnz)),
    packed at ``m + 4 ceil(sqrt(m))`` by lowest score.  Runs on ``a``'s
    device."""
    return _one_row(_legacy_threshold, a, m, seed)


def combined_priority_sketch(a: torch.Tensor, m: int, seed
                             ) -> CombinedSketch:
    """Algorithm 6 with the exact-m' closed form (the legacy route: three
    stable argsorts and two sorts), packed at ``m``.  Runs on ``a``'s
    device."""
    return _one_row(_legacy_priority, a, m, seed)


# ----------------------------------------------------------------------------
# Estimation
# ----------------------------------------------------------------------------


def _inclusion_scale(s: CombinedSketch, val: torch.Tensor) -> torch.Tensor:
    """``max(tau_ones, w_v tau_val, w_sq tau_sq)`` in normalized space for
    values ``val`` (..., cap) of sketch ``s`` (taus (...,))."""
    vn = val / s.scale[..., None]
    wv = flush_subnormal(vn * vn)
    wsq = flush_subnormal(wv * wv)

    def safe(tau, w):
        tau = tau[..., None]
        return torch.where(w > 0, tau * w,
                           torch.where(torch.isinf(tau),
                                       torch.full_like(w, math.inf),
                                       torch.zeros_like(w)))

    return torch.maximum(safe(s.tau_ones, torch.ones_like(wv)),
                         torch.maximum(safe(s.tau_val, wv),
                                       safe(s.tau_sq, wsq)))


def _join(a_idx: torch.Tensor, b_idx: torch.Tensor):
    """Sorted (..., cap) id rows -> (match, positions in b)."""
    pos = torch.searchsorted(b_idx.contiguous(), a_idx.contiguous())
    pos = pos.clamp(0, b_idx.shape[-1] - 1)
    match = (torch.gather(b_idx, -1, pos) == a_idx) & (a_idx != INVALID_IDX)
    return match, pos


def combined_estimates(sa: CombinedSketch, sb: CombinedSketch) -> dict:
    """All six inner products of Eq. (9) from a pair of combined sketches
    (or from row-aligned batches of them: fields (..., cap) and (...,))."""
    match, pos = _join(sa.idx, sb.idx)
    av = sa.val
    bv = torch.gather(sb.val, -1, pos)
    p = torch.clamp(torch.minimum(_inclusion_scale(sa, av),
                                  _inclusion_scale(sb, bv)), max=1.0)
    p = torch.where(match, p, torch.ones_like(p))
    zero = torch.zeros_like(p)

    def est(fa, gb):
        return torch.where(match, fa * gb / p, zero).sum(dim=-1)

    ones = torch.where(match, torch.ones_like(p), zero)
    return {"n": est(ones, ones), "sum_x": est(av, ones),
            "sum_y": est(ones, bv), "xy": est(av, bv),
            "sum_x2": est(av * av, ones), "sum_y2": est(ones, bv * bv)}


def correlation_from_estimates(e: dict, eps: float = 1e-12) -> torch.Tensor:
    """Eq. (8)/(9): the Pearson correlation from the six estimates,
    clipped to [-1, 1]."""
    num = e["n"] * e["xy"] - e["sum_x"] * e["sum_y"]
    vx = torch.clamp(e["n"] * e["sum_x2"] - e["sum_x"] * e["sum_x"], min=eps)
    vy = torch.clamp(e["n"] * e["sum_y2"] - e["sum_y"] * e["sum_y"], min=eps)
    return torch.clamp(num / torch.sqrt(vx * vy), -1.0, 1.0)


def estimate_join_correlation(sa: CombinedSketch, sb: CombinedSketch
                              ) -> torch.Tensor:
    return correlation_from_estimates(combined_estimates(sa, sb))


def empirical_correlation(sa, sb) -> torch.Tensor:
    """Correlation of the matched sample values (the [52]-style estimator
    of the uniform-sampling baselines, Section 5.1.3); ``sa``/``sb`` are
    any sketches with ``idx`` and ``val``."""
    match, pos = _join(sa.idx, sb.idx)
    x = sa.val
    y = torch.gather(sb.val, -1, pos)
    w = match.to(torch.float32)
    n = torch.clamp(w.sum(dim=-1), min=1.0)
    mx = (w * x).sum(dim=-1) / n
    my = (w * y).sum(dim=-1) / n
    dx, dy = x - mx[..., None], y - my[..., None]
    cov = (w * dx * dy).sum(dim=-1)
    vx = torch.clamp((w * (dx * dx)).sum(dim=-1), min=1e-12)
    vy = torch.clamp((w * (dy * dy)).sum(dim=-1), min=1e-12)
    return torch.clamp(cov / torch.sqrt(vx * vy), -1.0, 1.0)


# ----------------------------------------------------------------------------
# All pairs (correlation discovery across D columns)
# ----------------------------------------------------------------------------


def combined_sketch_corpus(A, m: int, seed, *, method: str = "priority",
                           backend: str = "reference",
                           device=None) -> CombinedSketch:
    """Sketch every row of A: (D, n) -> CombinedSketch with leading dim D.

    ``backend="reference"`` runs the legacy builders (Algorithm 6's
    argsorts, Algorithm 5 packed by top scores) on every row;
    ``backend="kernel"`` the linear-time batched build
    (``repro_torch.kernels.build_combined_*_corpus``: the selection kernel
    instead of the argsorts, a prefix-sum pack).  Runs on ``device``
    (default ``cuda``)."""
    if method not in ("priority", "threshold"):
        raise ValueError(f"unknown method {method!r}")
    dev = resolve_device(device)
    A = torch.atleast_2d(torch.as_tensor(A, dtype=torch.float32, device=dev))
    if backend == "kernel":
        from repro_torch.kernels.sketch_build.combined import (
            build_combined_priority_corpus, build_combined_threshold_corpus)
        build = (build_combined_priority_corpus if method == "priority"
                 else build_combined_threshold_corpus)
        return build(A, m, seed, device=dev)
    if backend != "reference":
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'reference' or 'kernel'")
    if method == "priority":
        return _legacy_priority(A, m, seed)
    return _legacy_threshold(A, m, seed)


def _bucketized_moment_inputs(S: CombinedSketch, n_buckets: int, slots: int):
    """Bucketize a combined-sketch corpus with each entry's inclusion
    probability ``min(1, inclusion scale)`` as a payload; empty slots get
    p = 1.  -> (idx, val, p (D, B, S), dropped (D,))."""
    from repro_torch.kernels.intersect_estimate import bucketize_payloads
    p = torch.clamp(_inclusion_scale(S, S.val), max=1.0)
    oi, (ov, op), dropped = bucketize_payloads(
        S.idx, (S.val, p), n_buckets=n_buckets, slots=slots)
    return oi, ov, torch.where(oi == INVALID_IDX, torch.ones_like(op),
                               op), dropped


def combined_estimates_matrix(SA: CombinedSketch, SB: CombinedSketch, *,
                              backend: str = "reference",
                              n_buckets: int = 512, slots: int = 4) -> dict:
    """The six Eq. (9) inner products for every pair of a (D1,) x (D2,)
    combined-sketch corpus; each value is a (D1, D2) tensor.

    ``backend="kernel"`` bucketizes both corpora and runs the all-pairs
    moments kernel (B5, one join for the whole matrix);
    ``backend="reference"`` the per-pair searchsorted join (chunked over
    SA's rows)."""
    if backend == "kernel":
        from repro_torch.kernels.intersect_estimate import (
            MOMENT_CHANNELS, allpairs_moments)
        a = _bucketized_moment_inputs(SA, n_buckets, slots)[:3]
        b = a if SB is SA else \
            _bucketized_moment_inputs(SB, n_buckets, slots)[:3]
        out = allpairs_moments(*a, *b)
        return {k: out[..., c] for c, k in enumerate(MOMENT_CHANNELS)}
    if backend != "reference":
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'reference' or 'kernel'")
    return _every_pair(SA, SB, combined_estimates)


def correlation_matrix(SA: CombinedSketch, SB: CombinedSketch | None = None,
                       *, backend: str = "reference", n_buckets: int = 512,
                       slots: int = 4) -> torch.Tensor:
    """(D1, D2) post-join Pearson correlation estimates — the discovery
    workload of Section 1; one join of the moments kernel under
    ``backend="kernel"``."""
    SB = SA if SB is None else SB
    return correlation_from_estimates(combined_estimates_matrix(
        SA, SB, backend=backend, n_buckets=n_buckets, slots=slots))
