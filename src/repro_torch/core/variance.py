"""Accuracy guarantees (Theorems 1 and 3, Corollary 2, Lemma 4), the
discovery bounds (the per-pair estimate ceilings, the shard-loss bound
and coverage) and the DP-release variance accounting: the parts of
``repro.core.variance`` that the quickstart, the serving index, discovery
and the private mode use.  The bounds take full vectors (tests,
benchmarks); the Chebyshev intervals and ceilings need only norms and the
sketch size (production use).  All in float32, as the reference computes
them.
"""
from __future__ import annotations

import torch


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _lead(m: int, method: str) -> float:
    return 2.0 / m if method == "threshold" else 2.0 / max(m - 1, 1)


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: torch's float32 ``sqrt`` on
    the CPU is not (its vector path); one rounding of the float64 root
    is."""
    return torch.sqrt(x.double()).float()


# XLA's CPU compiler sums a reduced axis of more than this many elements
# as a reduce-window of this size (tree_reduction_rewriter)
_XLA_WINDOW = 32


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of the reference's (XLA CPU)
    reduction: up to ``_XLA_WINDOW`` elements one after another; beyond,
    the axis padded with zeros to a multiple of the window (half the
    padding before it, the rest after), each window summed in order, and
    the window sums summed the same way."""
    n = x.shape[-1]
    if n > _XLA_WINDOW:
        pad = -n % _XLA_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        return _sum_last(_sum_last(
            x.reshape(x.shape[:-1] + (-1, _XLA_WINDOW))))
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(n):
        acc = acc + x[..., i]
    return acc


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


def surviving_corpus_bound(surv_a2, surv_b2, lost_a2, lost_b2, m: int,
                           delta: float = 0.05, *,
                           method: str = "priority"):
    """Widened error bound of an estimate that lost some coordinate
    partitions (shards), DESIGN.md §16 of the reference.  Inputs are
    per-partition squared norms along the last axis (surviving and lost;
    leading axes broadcast).  The surviving partitions' independent
    sketches add their Theorem 1/3 variances (``lead a2_p b2_p`` each), so
    Chebyshev gives ``sampling = sqrt(lead / delta sum_p a2_p b2_p)``; the
    lost coordinates' inner product is at most ``lost = sqrt(sum lost_a2)
    sqrt(sum lost_b2)`` (Cauchy-Schwarz).  -> ``(sampling, lost, sampling
    + lost)``: with probability ``1 - delta`` the degraded estimate is
    within the last of the full answer."""
    surv_a2, surv_b2, lost_a2, lost_b2 = (
        _t(x) for x in (surv_a2, surv_b2, lost_a2, lost_b2))
    sampling = _sqrt32(_lead(m, method) / delta
                       * _sum_last(surv_a2 * surv_b2))
    lost = _sqrt32(_sum_last(lost_a2)) * _sqrt32(_sum_last(lost_b2))
    return sampling, lost, sampling + lost


def pair_estimate_ceiling(g_a, n_a, g_b, n_b):
    """Admissible ceiling on the sampling estimate of any pair of sketches
    with rescaled / plain kept norms ``(g_a, n_a)``, ``(g_b, n_b)``
    (:func:`rescaled_kept_norms`): ``min(G_a G_b, G_a N_b + N_a G_b)``.
    The estimate sums ``a_i b_i max(1/p_a, 1/p_b)`` over the matches, and
    ``max(x, y)`` is at most ``x y`` and ``x + y`` for ``x, y >= 1``, so
    Cauchy-Schwarz bounds every realization, not only the mean: a pruning
    certificate that loses nothing.  Inputs broadcast (tile maxima give
    tile ceilings)."""
    g_a, n_a, g_b, n_b = (_t(x) for x in (g_a, n_a, g_b, n_b))
    return torch.minimum(g_a * g_b, g_a * n_b + n_a * g_b)


def chebyshev_estimate_ceiling(n_a, n_b, m: int, delta: float = 0.05, *,
                               method: str = "priority"):
    """Probabilistic ceiling on an estimate: with probability at least
    ``1 - delta`` a pair's ``|est| <= N_a N_b (1 + sqrt(lead / delta))``
    (Cauchy-Schwarz on the true product plus the Chebyshev deviation of
    the conservative Theorem 1/3 bound).  Tighter than
    :func:`pair_estimate_ceiling` when ``G >> N``, but a true top-k pair is
    pruned with probability up to ``delta``."""
    return _t(n_a) * _t(n_b) * (1.0 + (_lead(m, method) / delta) ** 0.5)


def coverage_fraction(surv_mass, lost_mass):
    """Share of the (squared-norm) mass the surviving shards serve,
    ``surv / (surv + lost)`` summed over the last axis; 1.0 where there is
    no mass at all."""
    surv = _sum_last(_t(surv_mass))
    lost = _sum_last(_t(lost_mass))
    total = surv + lost
    ok = total > 0
    return torch.where(ok, surv / torch.where(ok, total,
                                              torch.ones_like(total)),
                       torch.ones_like(total))


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


# ---------------------------------------------------------------------------
# DP-release variance accounting (DESIGN.md §20 of the reference)
# ---------------------------------------------------------------------------


def _dp_moments(a, b, m, *, q, noise_scale, clamp, p_floor, tau=None,
                method="threshold", variant="l2"):
    """Per-coordinate moments of the DP release mechanism for the release
    of ``a``'s sketch: ``(p, z, sigma2, b)``.  ``tau=None`` models the
    inclusion scale as ``m_eff / W`` (``m`` for threshold, ``m - 1`` for
    priority); the realized sketch ``tau`` gives the exact moments."""
    from .sketches import weight
    a = _t(a)
    b = _t(b).to(a.device)
    w = weight(a, variant)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    if tau is None:
        m_eff = m if method == "threshold" else max(m - 1, 1)
        W = w.sum()
        tau = torch.where(W > 0, m_eff / W, zero)
    tau = _t(tau).to(a.device)
    p = torch.where(w > 0, torch.clamp(tau * w, max=1.0), zero)
    p_eff = torch.clamp(p, p_floor, 1.0)
    z = torch.where(p > 0, torch.clamp(a, -clamp, clamp) / p_eff, zero)
    sigma2 = 2.0 * noise_scale * noise_scale   # Var of Laplace(b) = 2 b^2
    return p, z, sigma2, b


def dp_variance_bound(a, b, m, *, q, noise_scale, clamp, p_floor,
                      universe=None, capacity=0, tau=None,
                      method: str = "threshold", variant: str = "l2",
                      mode: str = "dense"):
    """Variance of the debiased DP estimator, the private twin of
    :func:`variance_bound` (full vectors; ``noise_scale`` is the release's
    per-slot Laplace scale, ``DPParams.noise_scale(capacity)``).

    ``mode="dense"``: ``a`` released, ``b`` known — per coordinate
    ``b_i^2 (p_i (z_i^2 + sigma^2) / q - p_i^2 z_i^2)``, plus
    ``capacity sigma^2 ||b||^2 / (q^2 universe)`` for the decoys.
    ``mode="pair"``: both released from independently seeded sketches —
    ``S_a S_b - mu_a^2 mu_b^2`` with ``S = p (z^2 + sigma^2) / q``,
    ``mu = p z``, plus a decoy-collision bound."""
    p, z, sigma2, b = _dp_moments(a, b, m, q=q, noise_scale=noise_scale,
                                  clamp=clamp, p_floor=p_floor, tau=tau,
                                  method=method, variant=variant)
    b2 = (b * b).sum()
    if mode == "dense":
        var = (b * b * (p * (z * z + sigma2) / q - p * p * z * z)).sum()
        if universe:
            var = var + capacity * sigma2 * b2 / (q * q * universe)
        return var
    if mode != "pair":
        raise ValueError(f"unknown mode {mode!r}; expected 'dense'|'pair'")
    pb_, zb, _, _ = _dp_moments(b, a, m, q=q, noise_scale=noise_scale,
                                clamp=clamp, p_floor=p_floor, tau=None,
                                method=method, variant=variant)
    Sa = p * (z * z + sigma2) / q
    Sb = pb_ * (zb * zb + sigma2) / q
    var = (Sa * Sb - (p * z) ** 2 * (pb_ * zb) ** 2).sum()
    if universe:
        Z2 = (clamp / p_floor) ** 2
        var = var + 2.0 * capacity * capacity * sigma2 * (Z2 + sigma2) \
            / (q ** 4 * universe)
    return var


def dp_debias_gap(a, b, m, *, clamp, p_floor, tau=None,
                  method: str = "threshold", variant: str = "l2",
                  mode: str = "dense"):
    """Deterministic residual bias of the DP estimator: ``|sum_i b_i (p_i
    z_i - a_i)|`` (dense), nonzero only where a value was clamped at ``C``
    or a probability floored at ``p_floor``."""
    p, z, _, b = _dp_moments(a, b, m, q=1.0, noise_scale=0.0, clamp=clamp,
                             p_floor=p_floor, tau=tau, method=method,
                             variant=variant)
    a = _t(a)
    if mode == "dense":
        return (b * (p * z - a)).sum().abs()
    if mode != "pair":
        raise ValueError(f"unknown mode {mode!r}; expected 'dense'|'pair'")
    pb_, zb, _, _ = _dp_moments(b, a, m, q=1.0, noise_scale=0.0,
                                clamp=clamp, p_floor=p_floor, tau=None,
                                method=method, variant=variant)
    return (p * z * pb_ * zb - a * b).sum().abs()


def dp_chebyshev_halfwidth(a_norm2, b_norm2, m: int, *, q, noise_scale,
                           clamp, p_floor, capacity=0, universe=None,
                           delta: float = 0.05, method: str = "priority"):
    """Norm-only band for private serving, the DP twin of
    :func:`chebyshev_interval`: with ``z_i^2 p_i <= max(||a||^2 / m_eff,
    C^2 / p_floor)``,

        ``Var <= (max(a2/m_eff, C^2/p_floor) + sigma^2) b2 / q
                 + capacity sigma^2 b2 / (q^2 universe)``

    and the half-width is ``sqrt(Var / delta)``."""
    m_eff = m if method == "threshold" else max(m - 1, 1)
    a2 = _t(a_norm2)
    b2 = _t(b_norm2)
    sigma2 = 2.0 * noise_scale * noise_scale
    K = torch.maximum(a2 / m_eff, _t(clamp * clamp / p_floor))
    var = (K + sigma2) * b2 / q
    if universe:
        var = var + capacity * sigma2 * b2 / (q * q * universe)
    return torch.sqrt(var / delta)
