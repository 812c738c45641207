"""Baseline sketches from the paper's evaluation (Section 5), as in
``repro.core.baselines``.

- JL / AMS: a Rademacher projection, ``S(a) = Pi a / sqrt(m)``, with Pi
  hashed where it is used (never stored) by the JL kernel
  (``kernels.jl_rademacher``) under the row seeds ``fold_seed(seed, 0) +
  r``.  O(Nm) work, O(m) memory.
- CountSketch / Fast-AGMS: one repetition, a signed bucket scatter on the
  CountSketch kernel (``kernels.countsketch``), bucket and sign streams
  ``fold_seed(seed, 1)`` and ``fold_seed(seed, 2)``.  O(N).
- MinHash (MH): k unweighted min-hash samples; the union size is
  estimated from the min hash values.
- WMH: weighted MinHash by Ioffe-style consistent weighted sampling on
  the squared weights ``a_i^2``.  O(Nm).

Every function runs on its input's device (the kernels for CUDA tensors,
their plain versions for CPU tensors).  As in the reference, which runs
under XLA's flush-to-zero, a subnormal input is not in MinHash's support
and a subnormal square is a zero WMH weight (flushed explicitly here).
KMV is ``priority_sketch(variant="uniform")`` and End-Biased is
``threshold_sketch(variant="l1")``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .hashing import _MASK, fold_seed, hash_unit
from .sketches import flush_subnormal

# ----------------------------------------------------------------------------
# Johnson-Lindenstrauss / AMS
# ----------------------------------------------------------------------------


def jl_sketch(a: torch.Tensor, m: int, seed) -> torch.Tensor:
    """``S(a) = Pi a / sqrt(m)`` with Pi in {+-1}^{m x n}; row r hashes
    under ``fold_seed(seed, 0) + r``."""
    from repro_torch.kernels.jl_rademacher import jl_rademacher
    from repro_torch.kernels.jl_rademacher.ref import sqrt_m
    a = torch.as_tensor(a).to(torch.float32).contiguous()
    rows = torch.arange(m, dtype=torch.int64, device=a.device)
    row_seeds = (int(fold_seed(seed, 0)) + rows) & _MASK
    return jl_rademacher(a, row_seeds) / sqrt_m(m)


def jl_estimate(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    return torch.dot(sa, sb)


# ----------------------------------------------------------------------------
# CountSketch / Fast-AGMS
# ----------------------------------------------------------------------------


def countsketch(a: torch.Tensor, m: int, seed) -> torch.Tensor:
    """(n,) -> (m,) CountSketch table under ``seed``'s two streams."""
    from repro_torch.kernels.countsketch import countsketch as cs_kernel
    return cs_kernel(torch.as_tensor(a), m, fold_seed(seed, 1),
                     fold_seed(seed, 2))


def countsketch_estimate(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    return torch.dot(sa, sb)


# ----------------------------------------------------------------------------
# MinHash (unweighted, k repetitions)
# ----------------------------------------------------------------------------


class MinHashSketch(NamedTuple):
    idx: torch.Tensor    # int32[k] argmin index per repetition
    val: torch.Tensor    # f32[k] vector value at that index
    minv: torch.Tensor   # f32[k] the min hash value (union-size estimation)


def _rep_seeds(seed, stream: int, k: int) -> list:
    """Repetition j's seed ``fold_seed(seed, stream) + j`` (32-bit)."""
    base = int(fold_seed(seed, stream))
    return [(base + j) & _MASK for j in range(k)]


def minhash_sketch(a: torch.Tensor, k: int, seed, *,
                   rep_block: int = 32) -> MinHashSketch:
    """k repetitions, ``rep_block`` of them hashed at a time."""
    a = torch.as_tensor(a).to(torch.float32)
    n = a.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=a.device)
    support = flush_subnormal(a) != 0
    seeds = _rep_seeds(seed, 3, k)
    ii = []
    mins = []
    for j0 in range(0, k, rep_block):
        h = torch.stack([hash_unit(s, idx) for s in seeds[j0:j0 + rep_block]])
        h = torch.where(support[None], h, torch.full_like(h, math.inf))
        i = torch.argmin(h, dim=1)
        ii.append(i)
        mins.append(torch.gather(h, 1, i[:, None])[:, 0])
    i = torch.cat(ii)
    return MinHashSketch(i.to(torch.int32), a[i], torch.cat(mins))


def minhash_estimate(sa: MinHashSketch, sb: MinHashSketch) -> torch.Tensor:
    k = sa.idx.shape[0]
    match = sa.idx == sb.idx
    # union size from the min of the min hash values: E[min] = 1/(U+1)
    w = torch.minimum(sa.minv, sb.minv)
    u_est = torch.clamp(k / w.sum() - 1.0, min=1.0)
    s = torch.where(match, sa.val * sb.val, torch.zeros_like(sa.val)).sum()
    return u_est / k * s


# ----------------------------------------------------------------------------
# Weighted MinHash via consistent weighted sampling (Ioffe-style)
# ----------------------------------------------------------------------------


class WMHSketch(NamedTuple):
    idx: torch.Tensor   # int32[k]
    val: torch.Tensor   # f32[k]
    wsum: torch.Tensor  # scalar ||a||_2^2 (for union estimation)


def wmh_sketch(a: torch.Tensor, k: int, seed, *,
               rep_block: int = 8) -> WMHSketch:
    """CWS samples with weights ``w_i = a_i^2`` (the paper's WMH
    weighting), ``rep_block`` repetitions at a time."""
    a = torch.as_tensor(a).to(torch.float32)
    n = a.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=a.device)
    w = flush_subnormal(a * a)
    pos = w > 0
    logw = torch.where(pos, torch.log(torch.where(pos, w, torch.ones_like(w))),
                       torch.full_like(w, -math.inf))
    streams = [_rep_seeds(seed, 4 + t, k) for t in range(5)]
    ii = []
    for j0 in range(0, k, rep_block):
        js = range(j0, min(j0 + rep_block, k))
        u = [torch.stack([hash_unit(streams[t][j], idx) for j in js])
             for t in range(5)]
        r = -torch.log(u[0]) - torch.log(u[1])      # Gamma(2, 1)
        c = -torch.log(u[2]) - torch.log(u[3])      # Gamma(2, 1)
        beta = u[4]
        t = torch.floor(logw[None] / r + beta)
        logy = r * (t - beta)
        log_aq = torch.log(c) - (logy + r)          # rank = c / (y e^r)
        log_aq = torch.where(pos[None], log_aq,
                             torch.full_like(log_aq, math.inf))
        ii.append(torch.argmin(log_aq, dim=1))
    i = torch.cat(ii)
    return WMHSketch(i.to(torch.int32), a[i], w.sum())


def wmh_estimate(sa: WMHSketch, sb: WMHSketch) -> torch.Tensor:
    k = sa.idx.shape[0]
    match = sa.idx == sb.idx
    wa = sa.val * sa.val
    wb = sb.val * sb.val
    # P[coordinated CWS samples collide at i] = min(wa_i, wb_i) / U with
    # U = sum_i max(wa_i, wb_i); from the collision rate J,
    # U = (Wa + Wb) / (1 + J), since sum min + sum max = Wa + Wb
    j_hat = match.to(torch.float32).mean()
    u_est = (sa.wsum + sb.wsum) / (1.0 + j_hat)
    one = torch.ones_like(wa)
    denom = torch.where(match, torch.minimum(wa, wb), one)
    s = torch.where(match, sa.val * sb.val / denom,
                    torch.zeros_like(wa)).sum()
    return u_est / k * s
