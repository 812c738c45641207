"""Estimator-quality self-monitoring (a copy of ``repro.obs.quality``,
DESIGN.md §19 of the reference).

The paper's closed-form variance bounds (Theorems 1/3) make *accuracy*
monitorable in production: a deployment can keep comparing realized
estimator behaviour against the predicted Chebyshev envelope.  Three
surfaces:

1. **Ingest health** (:meth:`QualityMonitor.observe_ingest`): the last
   tau and an EWMA of each batch's mean finite tau (a drifting tau means
   the corpus weight profile, and with it every inclusion probability, is
   moving), bucket-overflow drops (silent estimator bias: the one failure
   the unbiasedness proofs do not cover) and ingest row counts.
2. **Canary pairs** (:class:`CanaryMonitor`): pinned (query vector,
   indexed target) pairs with known true inner products.  Each check
   re-estimates every pair through the live index and folds the realized
   ``|error|`` against the Theorem 1/3 Chebyshev half-width
   ``sqrt(2 / (m - 1) ||a||^2 ||b||^2 / delta)`` into an error-budget
   ratio; a ratio above 1 more often than ``delta`` of the checks means
   the deployed estimator breaks its own certificate (a lost shard
   biasing reads, say).
3. **Durability and degraded-serving health**: degraded-read coverage,
   WAL replay length, recovery age and snapshot quarantines land in the
   same registry (fed by :mod:`repro_torch.serve.resilience`).

4. **Training telemetry** (:meth:`QualityMonitor.observe_gns`): the
   gradient noise scale that ``repro_torch.train.telemetry`` assembles
   from sketched per-shard gradients.

Host numpy at the boundary.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .metrics import MetricsRegistry

EWMA_ALPHA = 0.1


def chebyshev_halfwidth(a_norm2: float, b_norm2: float, m: int,
                        delta: float = 0.05) -> float:
    """Theorem 1/3 Chebyshev half-width: ``Var <= 2/(m-1) ||a||^2
    ||b||^2``, so ``|est - <a,b>| <= sqrt(Var / delta)`` with probability
    at least ``1 - delta`` (the scalar twin of
    :func:`repro_torch.core.variance.chebyshev_interval`)."""
    var = 2.0 / max(m - 1, 1) * float(a_norm2) * float(b_norm2)
    return math.sqrt(var / delta)


class QualityMonitor:
    """Rolling estimator-health gauges over one metrics registry."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._tau_ewma: Optional[float] = None
        self._g_tau_last = registry.gauge(
            "repro_quality_tau_last", "tau of the most recently built row")
        self._g_tau_ewma = registry.gauge(
            "repro_quality_tau_ewma",
            f"EWMA (alpha={EWMA_ALPHA}) of ingested taus — drift here "
            "means the corpus weight profile is moving")
        self._c_rows = registry.counter(
            "repro_quality_ingest_rows_total", "rows sketched at ingest")
        self._c_overflow = registry.counter(
            "repro_quality_overflow_entries_total",
            "sketch entries lost to bucket overflow (silent estimator "
            "bias; should stay ~0 under the n_buckets >= 2m sizing)")
        self._c_overflow_rows = registry.counter(
            "repro_quality_overflow_rows_total",
            "ingested rows that dropped at least one entry")
        self._g_coverage = registry.gauge(
            "repro_quality_coverage",
            "squared-mass coverage of the most recent read on this "
            "surface (1.0 = fully healthy)", labelnames=("surface",))

    def observe_ingest(self, tau, dropped=None) -> None:
        """Fold one ingest batch's taus (array-like) and overflow drops
        into the rolling gauges (float64, as the reference)."""
        tau = np.atleast_1d(np.asarray(tau, np.float64))
        if tau.size:
            finite = tau[np.isfinite(tau)]
            self._g_tau_last.set(float(tau[-1]))
            if finite.size:
                mean = float(finite.mean())
                self._tau_ewma = mean if self._tau_ewma is None else \
                    (1 - EWMA_ALPHA) * self._tau_ewma + EWMA_ALPHA * mean
                self._g_tau_ewma.set(self._tau_ewma)
            self._c_rows.inc(tau.size)
        if dropped is not None:
            dropped = np.atleast_1d(np.asarray(dropped, np.int64))
            total = int(dropped.sum())
            if total:
                self._c_overflow.inc(total)
                self._c_overflow_rows.inc(int((dropped > 0).sum()))

    def observe_coverage(self, coverage: float, surface: str) -> None:
        """``repro_quality_coverage{surface}``: the share of the answer
        the surviving shards served in the surface's latest read."""
        self._g_coverage.labels(surface).set(float(coverage))

    # -- training telemetry --------------------------------------------

    def observe_gns(self, gns: float, big2: float, small2: float,
                    mean_halfwidth: float) -> None:
        """Gradient-noise-scale telemetry (``train.telemetry``): the GNS
        point estimate plus the mean Chebyshev CI half-width of the
        pairwise sketch estimates it was assembled from."""
        r = self.registry
        r.gauge("repro_train_gns",
                "gradient noise scale (critical batch size) estimate"
                ).set(float(gns))
        r.gauge("repro_train_gns_big_norm2",
                "estimated ||mean gradient||^2").set(float(big2))
        r.gauge("repro_train_gns_small_norm2",
                "mean per-shard ||gradient||^2").set(float(small2))
        r.gauge("repro_train_gns_ci_halfwidth",
                "mean Chebyshev half-width of the pairwise inner-product "
                "estimates feeding the GNS").set(float(mean_halfwidth))


# ---------------------------------------------------------------------------
# Canary-pair monitoring
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CanaryPair:
    """One pinned probe: a held-out query vector, the name of an indexed
    target, the exact inner product, and the half-width the realized
    error is budgeted against."""
    label: str
    vector: np.ndarray
    target: str
    true_value: float
    halfwidth: float


@dataclass(frozen=True)
class CanaryReading:
    label: str
    estimate: float
    true_value: float
    halfwidth: float
    error: float
    budget_ratio: float      # |error| / halfwidth; > 1 = budget blown

    @property
    def violated(self) -> bool:
        return self.budget_ratio > 1.0


class CanaryMonitor:
    """Re-estimates pinned pairs through a live index and publishes the
    error-budget SLO gauges.

    ``index`` is anything with ``query(vector)`` returning either
    ``[(name, estimate), ...]`` (:class:`~repro_torch.serve.SketchIndex`,
    :class:`~repro_torch.serve.ShardedSketchIndex`) or an object with
    ``names``/``estimates`` (the
    :class:`~repro_torch.serve.resilience.DegradedResult` of a
    :class:`~repro_torch.serve.resilience.ResilientSketchIndex`):
    degraded reads are the regime the canaries exist to catch.

    The SLO: each check's ``budget_ratio = |est - true| / halfwidth``
    should exceed 1 in at most a ``delta`` share of checks (the Chebyshev
    guarantee itself).  Every check failing after a shard loss is the
    injected-fault signature.
    """

    def __init__(self, index, pairs: Sequence[CanaryPair], *,
                 registry: MetricsRegistry, every: int = 1,
                 query_kwargs: Optional[dict] = None):
        if not pairs:
            raise ValueError("need at least one canary pair")
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.index = index
        self.pairs = list(pairs)
        self.every = every
        # extra keywords for index.query, e.g. {"mode": "bias_aware"} to
        # canary a non-plain serving mode
        self.query_kwargs = dict(query_kwargs or {})
        self._tick = 0
        r = registry
        self._g_ratio = r.gauge(
            "repro_canary_error_budget_ratio",
            "worst |error| / Chebyshev-half-width over the canary pairs "
            "at the last check (> 1 = certificate violated)")
        self._g_pair = r.gauge(
            "repro_canary_budget_ratio", "per-canary error-budget ratio",
            labelnames=("canary",))
        self._g_ok = r.gauge(
            "repro_canary_slo_ok",
            "1 when every canary was inside its error budget at the "
            "last check, else 0")
        self._c_checks = r.counter(
            "repro_canary_checks_total", "canary sweeps performed")
        self._c_violations = r.counter(
            "repro_canary_violations_total",
            "canary readings whose realized error exceeded the "
            "predicted Chebyshev half-width")

    @classmethod
    def from_vectors(cls, index, canaries, *, registry: MetricsRegistry,
                     m: Optional[int] = None, delta: float = 0.05,
                     every: int = 1, halfwidth_fn=None,
                     query_kwargs: Optional[dict] = None) -> "CanaryMonitor":
        """Pinned pairs from raw vectors: ``canaries`` is ``[(label,
        query_vector, target_name, target_vector), ...]``; the exact
        product and the half-width are computed here once (float64) and
        the target vector is not kept.  ``m`` defaults to ``index.m``.

        ``halfwidth_fn(a_norm2, b_norm2, m, delta)`` replaces the
        Theorem 1/3 half-width: the DP and bias-aware modes have wider or
        tighter accounted bounds
        (:func:`repro_torch.core.dp_chebyshev_halfwidth` is the DP one).
        ``query_kwargs`` go to ``index.query``."""
        m = index.m if m is None else m
        hw = chebyshev_halfwidth if halfwidth_fn is None else halfwidth_fn
        pairs = []
        for label, qv, target, tv in canaries:
            qv = np.asarray(qv, np.float64)
            tv = np.asarray(tv, np.float64)
            pairs.append(CanaryPair(
                label=str(label), vector=qv.astype(np.float32),
                target=target, true_value=float(qv @ tv),
                halfwidth=float(hw(
                    float(qv @ qv), float(tv @ tv), m, delta))))
        return cls(index, pairs, registry=registry, every=every,
                   query_kwargs=query_kwargs)

    def _estimates(self, vector: np.ndarray) -> dict:
        res = self.index.query(vector, **self.query_kwargs)
        if hasattr(res, "estimates"):          # a DegradedResult
            return dict(zip(res.names, np.asarray(res.estimates).tolist()))
        return {name: float(est) for name, est in res}

    def check(self) -> list:
        """One canary sweep: the readings, with the SLO gauges and
        counters updated."""
        readings = []
        worst = 0.0
        violations = 0
        for pair in self.pairs:
            est = self._estimates(pair.vector)[pair.target]
            err = abs(est - pair.true_value)
            ratio = err / max(pair.halfwidth, 1e-30)
            readings.append(CanaryReading(
                label=pair.label, estimate=float(est),
                true_value=pair.true_value, halfwidth=pair.halfwidth,
                error=float(err), budget_ratio=float(ratio)))
            self._g_pair.labels(pair.label).set(ratio)
            worst = max(worst, ratio)
            violations += ratio > 1.0
        self._g_ratio.set(worst)
        self._g_ok.set(0.0 if violations else 1.0)
        self._c_checks.inc()
        if violations:
            self._c_violations.inc(violations)
        return readings

    def maybe_check(self) -> Optional[list]:
        """:meth:`check` on every ``every``-th call, else ``None``."""
        self._tick += 1
        if self._tick % self.every:
            return None
        return self.check()


# ---------------------------------------------------------------------------
# Durability: WAL and snapshot health (fed by repro_torch.serve.resilience)
# ---------------------------------------------------------------------------


def observe_recovery(registry: MetricsRegistry, *, replayed_ops: int,
                     dropped_tail: int, snapshot_mtime: Optional[float],
                     now: Optional[float] = None) -> None:
    """Publish one recovery's health: the WAL replay length, the corrupt
    tail records dropped, and the age of the snapshot it started from
    (``None``: a recovery without a snapshot, published as -1)."""
    now = time.time() if now is None else now
    registry.counter("repro_recovery_total", "index recoveries").inc()
    registry.gauge("repro_recovery_replayed_ops",
                   "journal records replayed by the last recovery"
                   ).set(replayed_ops)
    registry.gauge("repro_recovery_dropped_tail",
                   "corrupt/truncated WAL tail records dropped by the "
                   "last recovery").set(dropped_tail)
    age = -1.0 if snapshot_mtime is None else max(now - snapshot_mtime, 0.0)
    registry.gauge("repro_recovery_snapshot_age_seconds",
                   "age of the snapshot the last recovery loaded "
                   "(-1 = recovered without a snapshot)").set(age)
