"""Bias-aware head/tail estimation (DESIGN.md §20 of the reference;
Bias-Aware Sketches, arXiv 1610.07718; CountSketches and the Median of
Three, arXiv 2102.02193), as ``repro.private.biasaware``.

On Zipfian inputs a few heavy coordinates dominate the estimator variance.
The bias-aware sketch keeps the top-``h`` coordinates by magnitude of the
original vector **exactly** (the head) and a coordinated sample of the
residual (the head zeroed) with the remaining ``m - h`` budget.  The
estimator has four termwise-unbiased parts: head ∩ head (exact), the two
head x tail cross terms (one-sided Horvitz-Thompson) and tail x tail
(Algorithm 2 on the residual sketches).  The head is a function of the
data, never of the realized kept set, so the estimator is unbiased for any
head size.

The CountSketch tail fallback replaces the sampled tail with ``reps``
CountSketch tables of the residual, built by the CountSketch kernel
(``kernels.countsketch``, one launch a table) and estimated by the median
of the per-table products (cross terms decode median-of-k point queries).
The median is robust to heavy collisions but not unbiased.

The head/tail bookkeeping is host numpy in float64, as in the reference;
the sketches and tables are built on ``device`` (default ``cuda``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import (INVALID_IDX, Sketch, estimate_inner_product,
                              priority_sketch, threshold_sketch)
from repro_torch.core.hashing import _MASK, fold_seed, hash_bucket, hash_sign
from repro_torch.core.sketches import weight
from repro_torch.device import resolve_device

from .release import _host


def _weight64(x: np.ndarray, variant: str) -> np.ndarray:
    """The sampling weight of float32 values (flushed as the sketches
    flush it), in float64."""
    return _host(weight(torch.as_tensor(np.asarray(x, np.float32)),
                        variant)).astype(np.float64)


class BiasAwareSketch(NamedTuple):
    """Exact head + coordinated tail sample of the residual."""

    head_idx: np.ndarray   # int64 (h,) sorted ascending
    head_val: np.ndarray   # f32 (h,)
    tail: Sketch           # residual sketch, budget m - h
    variant: str

    @property
    def head_size(self) -> int:
        return int(np.sum(self.head_idx >= 0))


def head_split(a: np.ndarray, h: int):
    """Deterministic top-``h``-by-magnitude split of a dense vector:
    ``(head_idx sorted, head_val, residual)``.  Selection is always by
    ``a_i^2``, ties by ascending coordinate (stable argsort); zero values
    never enter the head."""
    a = np.asarray(a, np.float32)
    h = int(min(h, a.shape[0]))
    if h == 0:
        return (np.empty((0,), np.int64), np.empty((0,), np.float32),
                a.copy())
    w = a.astype(np.float64) ** 2
    head = np.sort(np.argsort(-w, kind="stable")[:h].astype(np.int64))
    head_val = a[head]
    live = head_val != 0
    head, head_val = head[live], head_val[live]
    resid = a.copy()
    resid[head] = 0.0
    return head, head_val, resid


def bias_aware_sketch(a: np.ndarray, m: int, seed, *, h: int = 16,
                      kind: str = "priority", variant: str = "l2",
                      adaptive: bool = True, backend: str = "reference",
                      device=None) -> BiasAwareSketch:
    """The head/tail sketch at total budget ``m`` (``h`` exact head entries
    + an ``m - h`` coordinated sample of the residual on ``device``).
    ``h=0`` is the plain sketch bit for bit."""
    if not 0 <= h < m:
        raise ValueError(f"need 0 <= h < m, got h={h}, m={m}")
    head_idx, head_val, resid = head_split(a, h)
    r = torch.as_tensor(resid, device=resolve_device(device))
    mt = m - h
    if kind == "priority":
        tail = priority_sketch(r, mt, seed, variant=variant, backend=backend)
    elif kind == "threshold":
        tail = threshold_sketch(r, mt, seed, variant=variant,
                                adaptive=adaptive, backend=backend)
    else:
        raise ValueError(f"unknown kind {kind!r}; "
                         "expected 'priority'|'threshold'")
    return BiasAwareSketch(head_idx=head_idx, head_val=head_val, tail=tail,
                           variant=variant)


def _tail_lookup(head_idx: np.ndarray, head_val: np.ndarray,
                 other_head_idx: np.ndarray, tail: Sketch,
                 variant: str) -> float:
    """``sum_i v_i * tail_b[i] / p_b(i)`` over head coordinates of one
    side not in the other side's head: the one-sided HT cross term."""
    if head_idx.size == 0:
        return 0.0
    in_other = np.isin(head_idx, other_head_idx, assume_unique=True)
    hi = head_idx[~in_other]
    hv = head_val[~in_other]
    if hi.size == 0:
        return 0.0
    t_idx = _host(tail.idx).astype(np.int64)
    t_val = _host(tail.val).astype(np.float64)
    tau = float(tail.tau)
    w = _weight64(t_val, variant)
    with np.errstate(over="ignore", invalid="ignore"):  # inf tau * 0 pad
        p = np.where(w > 0, np.minimum(1.0, tau * w), 1.0)
    pos = np.searchsorted(t_idx, hi)
    pos = np.clip(pos, 0, max(t_idx.size - 1, 0))
    found = (t_idx[pos] == hi) & (hi != INVALID_IDX)
    return float(np.sum(np.where(found, hv * t_val[pos] / p[pos], 0.0)))


def _head_product(ia: np.ndarray, va: np.ndarray, ib: np.ndarray,
                  vb: np.ndarray) -> float:
    """Exact ``sum`` of head_a x head_b products (both sorted)."""
    if not (ia.size and ib.size):
        return 0.0
    pos = np.clip(np.searchsorted(ib, ia), 0, ib.size - 1)
    match = ib[pos] == ia
    return float(np.sum(np.where(
        match, va.astype(np.float64) * vb[pos].astype(np.float64), 0.0)))


def estimate_bias_aware(sa: BiasAwareSketch, sb: BiasAwareSketch) -> float:
    """The four-part head/tail estimator; unbiased for any head size,
    exact on head ∩ head."""
    if sa.variant != sb.variant:
        raise ValueError("sketches must share a weight variant")
    est = _head_product(sa.head_idx, sa.head_val, sb.head_idx, sb.head_val)
    est += _tail_lookup(sa.head_idx, sa.head_val.astype(np.float64),
                        sb.head_idx, sb.tail, sa.variant)
    est += _tail_lookup(sb.head_idx, sb.head_val.astype(np.float64),
                        sa.head_idx, sa.tail, sa.variant)
    # tail x tail: Algorithm 2 on the residual sketches (a coordinate of
    # head_b is zero in residual_b, so it cannot be counted twice)
    est += float(estimate_inner_product(sa.tail, sb.tail,
                                        variant=sa.variant))
    return est


def head_tail_variance_bound(a, b, m: int, h: int, *, variant: str = "l2",
                             method: str = "priority") -> float:
    """Full-vector variance of the bias-aware estimator: head ∩ head
    contributes 0; each cross term is a one-sided HT sum ``sum v_i^2 r_i^2
    (1 - p)/p`` over the partner's modeled tail inclusion; tail x tail is
    Theorem 1/3 on the residuals at budget ``m - h``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ha, va, ra = head_split(a, h)
    hb, vb, rb = head_split(b, h)
    mt = m - h
    m_eff = mt if method == "threshold" else max(mt - 1, 1)

    def tail_p(resid):
        w = _weight64(resid, variant)
        W = w.sum()
        tau = m_eff / W if W > 0 else np.inf
        return np.where(w > 0, np.minimum(1.0, tau * w), 1.0)

    pa, pb = tail_p(ra), tail_p(rb)
    only_a = ha[~np.isin(ha, hb, assume_unique=True)]
    only_b = hb[~np.isin(hb, ha, assume_unique=True)]
    cross_ab = float(np.sum(a[only_a] ** 2 * rb[only_a] ** 2
                            * (1.0 - pb[only_a]) / pb[only_a]))
    cross_ba = float(np.sum(b[only_b] ** 2 * ra[only_b] ** 2
                            * (1.0 - pa[only_b]) / pa[only_b]))
    maskI = (ra != 0) & (rb != 0)
    raI2 = float(np.sum(np.where(maskI, ra * ra, 0.0)))
    rbI2 = float(np.sum(np.where(maskI, rb * rb, 0.0)))
    lead = 2.0 / max(m_eff, 1)
    tail_tail = lead * max(raI2 * float(np.sum(rb * rb)),
                           float(np.sum(ra * ra)) * rbI2)
    return cross_ab + cross_ba + tail_tail


# ---------------------------------------------------------------------------
# CountSketch tail fallback (median of k; arXiv 2102.02193)
# ---------------------------------------------------------------------------


class BiasAwareCSSketch(NamedTuple):
    """Exact head + ``k`` CountSketch tables of the residual."""

    head_idx: np.ndarray   # int64 (h,) sorted
    head_val: np.ndarray   # f32 (h,)
    tables: np.ndarray     # f32 (k, mt) CountSketch tables
    seed: int              # base seed; rep j hashes under seed + 7919 j
    universe: int


def _cs_seeds(seed: int, rep: int):
    """Rep ``rep``'s bucket and sign seeds: the base ``seed + 7919 rep``
    wraps in 32 bits, as the reference's uint32 arithmetic does."""
    s = (int(seed) + 7919 * int(rep)) & _MASK
    return int(fold_seed(s, 1)), int(fold_seed(s, 2))


def bias_aware_cs_sketch(a: np.ndarray, m: int, seed: int, *, h: int = 16,
                         reps: int = 3, variant: str = "l2",
                         device=None) -> BiasAwareCSSketch:
    """Head + ``reps`` CountSketch tables of the residual, each of width
    ``(m - h) // reps`` (equal total budget), one CountSketch kernel launch
    a table on ``device``."""
    from repro_torch.kernels.countsketch import countsketch as cs_kernel
    if reps < 1:
        raise ValueError("reps must be >= 1")
    mt = (m - h) // reps
    if mt < 1:
        raise ValueError(f"budget m={m} too small for h={h}, reps={reps}")
    head_idx, head_val, resid = head_split(a, h)
    r = torch.as_tensor(resid, device=resolve_device(device))
    tables = np.stack([_host(cs_kernel(r, mt, *_cs_seeds(seed, j)))
                       for j in range(reps)])
    return BiasAwareCSSketch(head_idx=head_idx, head_val=head_val,
                             tables=tables, seed=int(seed),
                             universe=int(np.asarray(a).shape[0]))


def _cs_point_queries(sk: BiasAwareCSSketch,
                      coords: np.ndarray) -> np.ndarray:
    """Median-of-k decode of residual values at ``coords``."""
    if coords.size == 0:
        return np.empty((0,), np.float64)
    cj = torch.as_tensor(np.asarray(coords, np.int32))
    reps, mt = sk.tables.shape
    ests = np.empty((reps, coords.size), np.float64)
    for j in range(reps):
        sb, ss = _cs_seeds(sk.seed, j)
        buckets = _host(hash_bucket(sb, cj, mt)).astype(np.int64)
        signs = _host(hash_sign(ss, cj)).astype(np.float64)
        ests[j] = signs * sk.tables[j, buckets]
    return np.median(ests, axis=0)


def estimate_bias_aware_cs(sa: BiasAwareCSSketch,
                           sb: BiasAwareCSSketch) -> float:
    """Head ∩ head exact + point-query cross terms + the median of the k
    per-table products for the tail (robust, not unbiased)."""
    if sa.tables.shape != sb.tables.shape or sa.seed != sb.seed:
        raise ValueError("CS sketches must share table shape and seed")
    est = _head_product(sa.head_idx, sa.head_val, sb.head_idx, sb.head_val)
    a_only = ~np.isin(sa.head_idx, sb.head_idx, assume_unique=True)
    b_only = ~np.isin(sb.head_idx, sa.head_idx, assume_unique=True)
    va = sa.head_val[a_only].astype(np.float64)
    vb = sb.head_val[b_only].astype(np.float64)
    est += float(np.sum(va * _cs_point_queries(sb, sa.head_idx[a_only])))
    est += float(np.sum(vb * _cs_point_queries(sa, sb.head_idx[b_only])))
    est += float(np.median(np.sum(sa.tables.astype(np.float64)
                                  * sb.tables.astype(np.float64), axis=1)))
    return est
