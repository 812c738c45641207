"""The port's observability subset: one switch, timed spans, counters.

A standalone copy of the part of ``repro.obs`` that the serving slice
uses, so the port never imports the JAX package:

- :func:`enabled` — the ``REPRO_OBS`` switch (``enable``/``disable``);
- :func:`op` — a timed span that also counts
  ``repro_op_total{op=...}`` and ``repro_op_errors_total{op=...}`` and
  sums ``repro_op_seconds{op=...}``;
- :func:`kernel_launch` — ``repro_kernel_launches_total{kernel=...}``;
- :func:`counter` — a plain named counter (the serving boundary's
  rejection counts);
- :func:`gauge` — a named value that ``set`` overwrites (the serving
  index's ``repro_biasaware_head_fraction`` and
  ``repro_dp_epsilon_spent``);
- :func:`quality_monitor` — the ingest half of ``repro.obs.quality``'s
  ``QualityMonitor``: ``SketchIndex.add`` / ``add_many`` fold each
  batch's taus and bucket-overflow drops into ``repro_quality_tau_last``,
  ``repro_quality_tau_ewma``, ``repro_quality_ingest_rows_total``,
  ``repro_quality_overflow_entries_total`` and
  ``repro_quality_overflow_rows_total``.

While disabled every accessor returns a shared no-op object, so an
instrumented call site costs one bool test.  The metric registry is a
flat dict of ``(name, label) -> number``; :func:`snapshot` copies it and
:func:`spans` lists the recorded spans.  The Prometheus exporter and the
rest of ``repro.obs.quality`` (canaries, coverage, recovery) are not
ported yet.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

_ENABLED = False
_LOCK = threading.Lock()
_METRICS: dict = {}
_SPANS: list = []
_MAX_SPANS = 4096


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Drop every recorded metric and span, and the quality monitor."""
    global _QUALITY
    with _LOCK:
        _METRICS.clear()
        _SPANS.clear()
        _QUALITY = None


def _add(name: str, label: str, n: float) -> None:
    with _LOCK:
        _METRICS[(name, label)] = _METRICS.get((name, label), 0) + n


def snapshot() -> dict:
    """``{(metric name, label): value}`` copy of the registry."""
    with _LOCK:
        return dict(_METRICS)


def spans() -> list:
    """Recorded spans as ``(name, start seconds, duration seconds,
    attributes)`` tuples, oldest first (a bounded ring)."""
    with _LOCK:
        return list(_SPANS)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, key, value) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _Op:
    """Timed operation: one span plus the ``repro_op_*{op=name}`` metrics."""

    __slots__ = ("name", "attrs", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.attrs: dict = {}
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def set(self, key, value) -> None:
        self.attrs[key] = value

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        with _LOCK:
            _SPANS.append((self.name, self._t0, dur, self.attrs))
            if len(_SPANS) > _MAX_SPANS:
                del _SPANS[0]
        _add("repro_op_total", self.name, 1)
        _add("repro_op_seconds", self.name, dur)
        if exc_type is not None:
            _add("repro_op_errors_total", self.name, 1)
        return False


def op(name: str):
    """Timed span for a serve or engine entry point (no-op when off)."""
    if not _ENABLED:
        return NOOP_SPAN
    return _Op(name)


def kernel_launch(kernel: str, n: int = 1) -> None:
    """Count a kernel-wrapper dispatch."""
    if _ENABLED:
        _add("repro_kernel_launches_total", kernel, n)


def counter(name: str, label: str = "", n: float = 1) -> None:
    """Add ``n`` to the counter ``name{label}`` (no-op when off)."""
    if _ENABLED:
        _add(name, label, n)


class _NoopGauge:
    __slots__ = ()

    def set(self, value) -> None:
        pass


NOOP_GAUGE = _NoopGauge()


class _Gauge:
    """``set`` overwrites the registry's value of ``name``."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def set(self, value) -> None:
        with _LOCK:
            _METRICS[(self.name, "")] = float(value)


def gauge(name: str, help: str = ""):
    """The gauge ``name`` (``help`` documents it; no-op object when off)."""
    if not _ENABLED:
        return NOOP_GAUGE
    return _Gauge(name)


EWMA_ALPHA = 0.1


class QualityMonitor:
    """Ingest health, as ``repro.obs.quality.QualityMonitor``: the last
    tau, an EWMA (alpha ``EWMA_ALPHA``) of each batch's mean finite tau
    (a drifting tau means the corpus weight profile is moving), the rows
    ingested, and the entries and rows lost to bucket overflow."""

    def __init__(self):
        self._tau_ewma = None

    def observe_ingest(self, tau, dropped=None) -> None:
        """Fold one ingest batch's taus (array-like) and overflow drops
        into the registry (float64, as the reference)."""
        tau = np.atleast_1d(np.asarray(tau, np.float64))
        if tau.size:
            finite = tau[np.isfinite(tau)]
            with _LOCK:
                _METRICS[("repro_quality_tau_last", "")] = float(tau[-1])
                if finite.size:
                    mean = float(finite.mean())
                    self._tau_ewma = mean if self._tau_ewma is None else \
                        (1 - EWMA_ALPHA) * self._tau_ewma + EWMA_ALPHA * mean
                    _METRICS[("repro_quality_tau_ewma", "")] = self._tau_ewma
            _add("repro_quality_ingest_rows_total", "", tau.size)
        if dropped is not None:
            dropped = np.atleast_1d(np.asarray(dropped, np.int64))
            total = int(dropped.sum())
            if total:
                _add("repro_quality_overflow_entries_total", "", total)
                _add("repro_quality_overflow_rows_total", "",
                     int((dropped > 0).sum()))


_QUALITY = None


def quality_monitor() -> QualityMonitor:
    """The process's :class:`QualityMonitor` (made at first use, dropped
    by :func:`reset`).  It records whatever the switch says: callers test
    :func:`enabled` first."""
    global _QUALITY
    with _LOCK:
        if _QUALITY is None:
            _QUALITY = QualityMonitor()
        return _QUALITY


if os.environ.get("REPRO_OBS", "").strip().lower() in ("1", "true", "on"):
    enable()
