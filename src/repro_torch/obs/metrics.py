"""Metrics registry: counters, gauges, histograms with labeled families
(a copy of ``repro.obs.metrics``, DESIGN.md §19 of the reference).

Stdlib only, so the registry sits under every subsystem, the kernel
wrappers included.  Three metric kinds:

- **Counter**: a monotone float accumulator (``inc``); rates derive from
  scrape deltas.
- **Gauge**: last write wins (``set``/``inc``/``dec``): taus, coverage,
  shards down.
- **Histogram**: fixed *exponential* buckets chosen at family creation
  (``base * growth**k``): cumulative bucket counts, ``sum`` and ``count``
  in the Prometheus style.  ``observe`` is a linear scan over about a
  dozen floats and allocates nothing.

Families are named; label *values* select a child metric inside the
family (``family.labels("serve")``).  Children are made on first use
under the family lock and cached.  Exposition is pull-based:
:meth:`MetricsRegistry.snapshot` (a JSON-able dict) and
:meth:`MetricsRegistry.prometheus_text` (Prometheus text format v0.0.4).

Thread safety: one lock per registry guards family creation, one per
family its children, and each child carries its own lock for mutation,
so the sharded fan-out's worker threads never race an exposition pass.

The *disabled* path lives in ``repro_torch.obs``: call sites go through
its accessors, which return the shared no-op singletons
(:data:`NOOP_COUNTER` et al.) while observability is off, so a disabled
call allocates nothing and touches no registry state.
"""
from __future__ import annotations

import threading
from typing import Iterable, Optional, Sequence

# 1us .. ~4200s in x4 steps: spans every latency this repo produces, from
# a no-op counter bump to a full-corpus rebuild, in 12 fixed buckets
DEFAULT_BUCKETS = tuple(1e-6 * 4.0 ** k for k in range(12))

_INF = float("inf")


def exponential_buckets(base: float, growth: float, count: int) -> tuple:
    """``(base * growth**k for k < count)`` — the only bucket shape the
    registry supports (fixed at family creation)."""
    if base <= 0 or growth <= 1 or count < 1:
        raise ValueError("need base > 0, growth > 1, count >= 1")
    return tuple(base * growth ** k for k in range(count))


def _label_key(values: Sequence[str]) -> tuple:
    return tuple(str(v) for v in values)


class _Child:
    """One (family, label-values) metric instance."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0


class Counter(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc {amount})")
        with self._lock:
            self.value += amount


class Gauge(_Child):
    __slots__ = ()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount


class Histogram:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple):
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0
        buckets = self.buckets
        n = len(buckets)
        while i < n and v > buckets[i]:
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1


class Family:
    """A named metric family; label values address child metrics."""

    def __init__(self, name: str, kind: type, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[tuple] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = buckets
        self._lock = threading.Lock()
        self._children: dict = {}
        if not self.labelnames:
            # unlabeled family: the sole child exists up front so the
            # steady-state path is one attribute read, no dict probe
            self._default = self._make()
        else:
            self._default = None

    def _make(self):
        if self.kind is Histogram:
            return Histogram(self.buckets)
        return self.kind()

    def labels(self, *values: str):
        """Child metric for these label values (created on first use)."""
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{len(values)} value(s)")
        key = _label_key(values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make())
        return child

    # unlabeled conveniences -------------------------------------------
    def _only(self):
        if self._default is None:
            raise ValueError(f"{self.name} is labeled "
                             f"{self.labelnames}; use .labels(...)")
        return self._default

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def observe(self, value: float) -> None:
        self._only().observe(value)

    @property
    def value(self) -> float:
        return self._only().value

    def items(self):
        if self._default is not None:
            yield (), self._default
        # snapshot the dict under the lock; children are never removed
        with self._lock:
            children = list(self._children.items())
        yield from children


_KIND_NAMES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class MetricsRegistry:
    """Process-local registry of metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict = {}

    def _family(self, name: str, kind: type, help: str,
                labelnames: Sequence[str], buckets=None) -> Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind is not kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{_KIND_NAMES[fam.kind]}, not {_KIND_NAMES[kind]}")
            if tuple(labelnames) != fam.labelnames:
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{fam.labelnames}, not {tuple(labelnames)}")
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind, help, labelnames, buckets)
                self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Family:
        return self._family(name, Counter, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Family:
        return self._family(name, Gauge, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> Family:
        buckets = DEFAULT_BUCKETS if buckets is None else tuple(buckets)
        if list(buckets) != sorted(buckets) or len(buckets) < 1:
            raise ValueError("histogram buckets must be ascending and "
                             "non-empty")
        return self._family(name, Histogram, help, labelnames, buckets)

    def reset(self) -> None:
        """Drop every family (tests / fresh measurement windows)."""
        with self._lock:
            self._families.clear()

    # -- exposition -----------------------------------------------------

    def families(self):
        with self._lock:
            return list(self._families.values())

    def snapshot(self) -> dict:
        """JSON-able dump: ``{name: {"kind", "help", "labels",
        "series": [{"labels": {...}, ...per-kind fields}]}}``."""
        out = {}
        for fam in self.families():
            series = []
            for key, child in fam.items():
                labels = dict(zip(fam.labelnames, key))
                if isinstance(child, Histogram):
                    with child._lock:
                        series.append({
                            "labels": labels,
                            "count": child.count,
                            "sum": child.sum,
                            "buckets": list(zip(
                                [*child.buckets, _INF],
                                list(child.counts))),
                        })
                else:
                    series.append({"labels": labels, "value": child.value})
            out[fam.name] = {"kind": _KIND_NAMES[fam.kind],
                             "help": fam.help,
                             "labels": list(fam.labelnames),
                             "series": series}
        return out

    def value(self, name: str, *labelvalues: str) -> float:
        """Read one counter/gauge value (0.0 when never touched) —
        test/introspection convenience, not a hot-path API."""
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        if not labelvalues and fam._default is not None:
            return fam._default.value
        child = fam._children.get(_label_key(labelvalues))
        return 0.0 if child is None else child.value

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines = []
        for fam in self.families():
            kind = _KIND_NAMES[fam.kind]
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {kind}")
            for key, child in fam.items():
                base = _fmt_labels(fam.labelnames, key)
                if isinstance(child, Histogram):
                    with child._lock:
                        cum = 0
                        for le, n in zip([*child.buckets, _INF],
                                         child.counts):
                            cum += n
                            le_s = "+Inf" if le == _INF else repr(le)
                            lines.append(
                                f"{fam.name}_bucket"
                                f"{_merge_labels(base, ('le', le_s))} {cum}")
                        lines.append(f"{fam.name}_sum{base} {child.sum!r}")
                        lines.append(f"{fam.name}_count{base} {child.count}")
                else:
                    v = child.value
                    v_s = repr(v) if v != int(v) else str(int(v))
                    lines.append(f"{fam.name}{base} {v_s}")
        return "\n".join(lines) + "\n"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape(v)}"' for n, v in zip(names, values))
    return "{" + inner + "}"


def _merge_labels(base: str, extra: tuple) -> str:
    pair = f'{extra[0]}="{extra[1]}"'
    if not base:
        return "{" + pair + "}"
    return base[:-1] + "," + pair + "}"


# ---------------------------------------------------------------------------
# Shared no-op singletons (the disabled path; see repro_torch.obs)
# ---------------------------------------------------------------------------


class _NoopMetric:
    """Absorbs every metric call without allocating or recording.

    One shared instance stands in for every counter/gauge/histogram while
    observability is disabled: methods take positional floats and return
    None, ``labels`` returns the same singleton, so a disabled call chain
    (``obs.counter(...).labels(...).inc()``) touches only pre-existing
    objects: zero allocations per call.
    """

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def labels(self, *values: str) -> "_NoopMetric":
        return self

    @property
    def value(self) -> float:
        return 0.0


NOOP_METRIC = _NoopMetric()
NOOP_COUNTER = NOOP_METRIC
NOOP_GAUGE = NOOP_METRIC
NOOP_HISTOGRAM = NOOP_METRIC
