"""repro_torch.obs: the port's observability facade (a copy of
``repro.obs``, DESIGN.md §19 of the reference).

One process-wide switch over three pillars:

- :mod:`repro_torch.obs.metrics`: a thread-safe registry of labeled
  counter / gauge / histogram families with Prometheus-text and
  JSON-snapshot exporters;
- :mod:`repro_torch.obs.tracing`: context-manager spans in a bounded
  ring with a Chrome ``trace_event`` JSONL exporter;
- :mod:`repro_torch.obs.quality`: estimator health: tau, overflow and
  coverage gauges, the canary error-budget SLO, WAL and recovery health.

**The disabled path is the default and it is free.**  Every call site
goes through the accessors below (``obs.counter(name, help,
labelnames).labels(value).inc(n)``, ``obs.span(...)``, ``obs.op(...)``);
while disabled they return shared stateless no-op singletons, so an
instrumented call costs one module-attribute read and a bool test and
allocates nothing.

Enable with :func:`enable` or by exporting ``REPRO_OBS=1`` before the
import.  Call sites resolve through the accessor on every call, so an
enable / disable flip takes effect at once.  The reference's
``engine_op`` (a counter of JAX retraces) has no counterpart here: the
port's engine entry points are eager and use :func:`op`.
"""
from __future__ import annotations

import os
import threading

from .metrics import (  # noqa: F401  (re-exported)
    DEFAULT_BUCKETS,
    NOOP_COUNTER,
    NOOP_GAUGE,
    NOOP_HISTOGRAM,
    NOOP_METRIC,
    MetricsRegistry,
    exponential_buckets,
)
from .tracing import NOOP_SPAN, Span, Tracer  # noqa: F401

_ENABLED = False
_REGISTRY = MetricsRegistry()
_TRACER = Tracer()
_QUALITY = None            # made on first use: quality imports numpy
_QUALITY_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# Switch
# ---------------------------------------------------------------------------


def enable() -> None:
    """Turn observability on process-wide (idempotent)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn observability off; what was recorded stays until
    :func:`reset`."""
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Drop every family, span and the quality monitor."""
    global _QUALITY
    _REGISTRY.reset()
    _TRACER.clear()
    with _QUALITY_LOCK:
        _QUALITY = None


# ---------------------------------------------------------------------------
# Accessors: the only API instrumented call sites use
# ---------------------------------------------------------------------------


def registry() -> MetricsRegistry:
    """The live registry (real even while disabled, for exporters and
    tests; *recording* goes through the accessors, which the switch
    gates)."""
    return _REGISTRY


def tracer() -> Tracer:
    return _TRACER


def quality_monitor():
    """The process's :class:`~repro_torch.obs.quality.QualityMonitor`,
    made on first use and bound to :func:`registry` (dropped by
    :func:`reset`).  It records whatever the switch says: callers test
    :func:`enabled` first."""
    global _QUALITY
    q = _QUALITY
    if q is None:
        with _QUALITY_LOCK:
            if _QUALITY is None:
                from .quality import QualityMonitor
                _QUALITY = QualityMonitor(_REGISTRY)
            q = _QUALITY
    return q


def counter(name: str, help: str = "", labelnames=()):
    """Counter family, or the shared no-op while disabled."""
    if not _ENABLED:
        return NOOP_COUNTER
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()):
    """Gauge family, or the shared no-op while disabled."""
    if not _ENABLED:
        return NOOP_GAUGE
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=(), buckets=None):
    """Histogram family, or the shared no-op while disabled."""
    if not _ENABLED:
        return NOOP_HISTOGRAM
    return _REGISTRY.histogram(name, help, labelnames, buckets)


def span(name: str):
    """Plain tracing span (no metrics), or the shared no-op span."""
    if not _ENABLED:
        return NOOP_SPAN
    return _TRACER.span(name)


class _Op:
    """Timed operation: one span plus the shared labeled families
    ``repro_op_total/seconds/errors_total{op=...}``.  Made only while
    enabled."""

    __slots__ = ("name", "_span")

    def __init__(self, name: str):
        self.name = name
        self._span = _TRACER.span(name)

    def __enter__(self) -> Span:
        return self._span.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._span.__exit__(exc_type, exc, tb)
        r = _REGISTRY
        r.counter("repro_op_total", "operations by dotted span name",
                  ("op",)).labels(self.name).inc()
        r.histogram("repro_op_seconds", "operation latency",
                    ("op",)).labels(self.name).observe(self._span.dur)
        if exc_type is not None:
            r.counter("repro_op_errors_total", "operations that raised",
                      ("op",)).labels(self.name).inc()
        return False


def op(name: str):
    """Timed span that also records count, latency and errors under the
    ``repro_op_*{op=name}`` families: the instrumentation of the serve
    and engine entry points."""
    if not _ENABLED:
        return NOOP_SPAN
    return _Op(name)


def kernel_launch(kernel: str, n: int = 1) -> None:
    """Count kernel-wrapper dispatches:
    ``repro_kernel_launches_total{kernel=...}``."""
    if _ENABLED:
        _REGISTRY.counter(
            "repro_kernel_launches_total",
            "dispatches through the kernel wrappers",
            ("kernel",)).labels(kernel).inc(n)


# ---------------------------------------------------------------------------
# Exposition
# ---------------------------------------------------------------------------


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def prometheus_text() -> str:
    return _REGISTRY.prometheus_text()


def export_chrome(path: str) -> int:
    return _TRACER.export_chrome(path)


def __getattr__(name: str):
    # the numpy-speaking quality symbols resolve lazily, so that
    # `import repro_torch.obs` stays stdlib-only for the kernel wrappers
    if name in ("QualityMonitor", "CanaryMonitor", "CanaryPair",
                "CanaryReading", "chebyshev_halfwidth", "observe_recovery"):
        from . import quality as _q
        return getattr(_q, name)
    raise AttributeError(
        f"module 'repro_torch.obs' has no attribute {name!r}")


if os.environ.get("REPRO_OBS", "").strip().lower() in ("1", "true", "on"):
    enable()
