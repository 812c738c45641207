"""The port's observability package (``repro_torch.obs``) on the CPU: the
reference's observability tests (``tests/test_obs.py``) run against the
port (the disabled path's shared no-ops and zero allocation, the
registry, the tracer and its Chrome export, the quality monitor, the
canaries, recovery health, the serve hooks), and the port held against
the live ``repro.obs``: the ingest quality metrics fed the same batches,
and the whole registry after the same ingest, query, recovery and
degraded-read workload (the same families, label names, label values
and counter / gauge values, ``*_seconds`` values aside).  The
reference's ``engine_op`` (JAX retrace counts) and its training
telemetry are not ported, nor are their two tests."""
import json
import os
import re
import threading
import tracemalloc

import numpy as np
import pytest

from _torch_common import sparse_block
from _torch_common import release_jax_executables  # noqa: F401

import repro.obs as jobs
import repro.serve as J
import repro_torch.serve as T
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.obs.quality import QualityMonitor as JQualityMonitor
from repro_torch import obs
from repro_torch.obs.metrics import (NOOP_COUNTER, NOOP_GAUGE,
                                     NOOP_HISTOGRAM, MetricsRegistry,
                                     exponential_buckets)
from repro_torch.obs.quality import (CanaryMonitor, QualityMonitor,
                                     chebyshev_halfwidth, observe_recovery)
from repro_torch.obs.tracing import NOOP_SPAN, Tracer
from repro_torch.serve import SketchIndex

CPU = "cpu"
GAUGES = ("repro_quality_tau_last", "repro_quality_tau_ewma")
COUNTERS = ("repro_quality_ingest_rows_total",
            "repro_quality_overflow_entries_total",
            "repro_quality_overflow_rows_total")


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends with both packages' observability
    disabled and empty."""
    for o in (obs, jobs):
        o.disable()
        o.reset()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset()


@pytest.fixture
def both_enabled():
    jobs.enable()
    obs.enable()


def _assert_same(read_ref) -> dict:
    """The five ingest metrics of both sides: gauges within 1e-12
    relative, counters equal.  Returns the port's values."""
    got = {}
    value = obs.registry().value
    for name in GAUGES:
        got[name] = value(name)
        assert got[name] == pytest.approx(read_ref(name), rel=1e-12,
                                          abs=0.0), name
    for name in COUNTERS:
        got[name] = value(name)
        assert got[name] == read_ref(name), name
    return got


# ---------------------------------------------------------------------------
# the ingest quality metrics against the reference (as before the package)
# ---------------------------------------------------------------------------


def test_quality_monitor_matches_reference_on_raw_batches(both_enabled):
    """Arrays, scalars, an all-inf batch (no EWMA step), an empty batch,
    drops given and not given."""
    ref = JQualityMonitor(JMetricsRegistry())
    mon = obs.quality_monitor()
    assert obs.quality_monitor() is mon
    rng = np.random.default_rng(5)
    batches = [(rng.random(17) * 1e-3, rng.integers(0, 3, 17)),
               (np.float32(2.5e-4), 0), (np.array([np.inf, np.inf]), [0, 4]),
               (np.array([], np.float32), None),
               (rng.random(9).astype(np.float32), None),
               (np.array([0.7, np.inf, 1e-5]), np.array([0, 0, 1]))]
    for tau, dropped in batches:
        ref.observe_ingest(tau, dropped)
        mon.observe_ingest(tau, dropped)
    got = _assert_same(ref.registry.value)
    assert got["repro_quality_ingest_rows_total"] == 17 + 1 + 2 + 9 + 3
    obs.reset()
    assert obs.snapshot() == {}
    assert obs.quality_monitor() is not mon


def _ingest(index, vecs):
    """add_many of 24 rows, six dense adds, a sparse add, and a sparse
    add of 10 nonzeros (fewer than m: tau = inf, kept out of the EWMA)."""
    index.add_many([f"v{d}" for d in range(24)], vecs[:24])
    for d in range(24, 30):
        index.add(f"v{d}", vecs[d])
    nz = np.flatnonzero(vecs[30])
    index.add("v30", indices=nz, values=vecs[30][nz])
    index.add("few", indices=nz[:10], values=vecs[30][nz[:10]])


@pytest.mark.parametrize("case", ["no_overflow", "overflow"])
def test_index_ingest_metrics_match_reference(both_enabled, case):
    """The same add / add_many calls through both indexes: without bucket
    overflow (8 slots a bucket) and with it (slots = 1 drops entries)."""
    cfg = dict(m=64, n_buckets=128, slots=8 if case == "no_overflow" else 1,
               initial_capacity=8)
    vecs = sparse_block(np.random.default_rng(16), 31, 3000, 300)
    j = J.SketchIndex(**cfg)
    t = SketchIndex(**cfg, device=CPU)
    _ingest(j, vecs)
    _ingest(t, vecs)
    got = _assert_same(jobs.registry().value)
    assert got["repro_quality_ingest_rows_total"] == 32
    assert got["repro_quality_tau_last"] == np.inf
    assert np.isfinite(got["repro_quality_tau_ewma"])
    dropped = got["repro_quality_overflow_entries_total"]
    assert (dropped == 0) == (case == "no_overflow")
    assert dropped == t.total_dropped == j.total_dropped


def test_index_records_no_quality_metrics_while_disabled():
    assert not obs.enabled()
    t = SketchIndex(m=16, n_buckets=64, slots=2, device=CPU)
    t.add("a", np.ones(64, np.float32))
    t.add_many(["b"], np.ones((1, 64), np.float32))
    assert obs.snapshot() == {}


# ---------------------------------------------------------------------------
# disabled path: shared singletons, zero allocation
# ---------------------------------------------------------------------------


def test_disabled_accessors_return_shared_singletons():
    assert obs.counter("repro_x_total") is NOOP_COUNTER
    assert obs.gauge("repro_x") is NOOP_GAUGE
    assert obs.histogram("repro_x_seconds") is NOOP_HISTOGRAM
    assert obs.span("anything") is NOOP_SPAN
    assert obs.op("anything") is NOOP_SPAN
    # the no-ops take the whole recording API, labels chains included
    NOOP_COUNTER.labels("a", "b").inc(3)
    NOOP_GAUGE.labels("x").set(1.0)
    NOOP_HISTOGRAM.observe(0.5)
    with obs.op("noop") as sp:
        sp.set("k", "v")
    assert not obs.enabled()


def test_disabled_records_nothing():
    obs.counter("repro_never_total", "x").inc()
    obs.kernel_launch("never.kernel")
    with obs.op("never.op"):
        pass
    assert obs.snapshot() == {}
    assert obs.tracer().events() == []


def test_disabled_hot_loop_allocates_nothing():
    """A hot loop through every accessor while disabled allocates nothing
    a call (shared singletons, no closures, no format strings)."""
    def hot():
        for _ in range(1000):
            obs.counter("repro_hot_total").inc()
            obs.kernel_launch("hot.kernel")
            with obs.op("hot.op") as sp:
                sp.set("k", 1)
    hot()  # warm up: interned ints, bytecode, method caches
    tracemalloc.start()
    base, _ = tracemalloc.get_traced_memory()
    hot()
    now, _ = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    # tracemalloc's own bookkeeping is a small constant; an allocation a
    # call over 3000 accessor hits would be tens of kilobytes
    assert now - base < 2048, f"disabled path allocated {now - base} bytes"


def test_enable_disable_flip_without_stale_handles():
    obs.counter("repro_flip_total").inc()      # disabled: dropped
    obs.enable()
    obs.counter("repro_flip_total", "flips").inc()
    assert obs.registry().value("repro_flip_total") == 1.0
    obs.disable()
    obs.counter("repro_flip_total").inc()      # disabled again: dropped
    assert obs.registry().value("repro_flip_total") == 1.0


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram_record():
    obs.enable()
    obs.counter("repro_c_total", "a counter").inc()
    obs.counter("repro_c_total").inc(2.5)
    obs.gauge("repro_g", "a gauge").set(7.0)
    h = obs.histogram("repro_h_seconds", "a histogram")
    h.observe(1e-5)
    h.observe(10.0)
    r = obs.registry()
    assert r.value("repro_c_total") == 3.5
    assert r.value("repro_g") == 7.0
    snap = obs.snapshot()
    assert snap["repro_h_seconds"]["series"][0]["count"] == 2


def test_labeled_families_are_independent_series():
    obs.enable()
    fam = obs.counter("repro_l_total", "labeled", ("op",))
    fam.labels("a").inc()
    fam.labels("b").inc(2)
    r = obs.registry()
    assert r.value("repro_l_total", "a") == 1.0
    assert r.value("repro_l_total", "b") == 2.0


def test_kind_and_label_mismatch_raise():
    obs.enable()
    obs.counter("repro_kind_total", "x")
    with pytest.raises(ValueError, match="kind"):
        obs.registry().gauge("repro_kind_total")
    with pytest.raises(ValueError, match="label"):
        obs.registry().counter("repro_kind_total", labelnames=("x",))


def test_prometheus_text_exposition():
    obs.enable()
    obs.counter("repro_p_total", "help text", ("op",)).labels("q\\x").inc()
    obs.gauge("repro_pg", "a gauge").set(1.5)
    obs.histogram("repro_ph", "h", buckets=(1.0, 2.0)).observe(1.5)
    text = obs.prometheus_text()
    assert "# HELP repro_p_total help text" in text
    assert "# TYPE repro_p_total counter" in text
    assert 'repro_p_total{op="q\\\\x"} 1' in text       # escaped backslash
    assert "repro_pg 1.5" in text
    assert 'repro_ph_bucket{le="2.0"} 1' in text        # cumulative buckets
    assert 'repro_ph_bucket{le="+Inf"} 1' in text
    assert "repro_ph_count 1" in text


def test_exponential_buckets():
    b = exponential_buckets(1.0, 2.0, 4)
    assert b == (1.0, 2.0, 4.0, 8.0)
    with pytest.raises(ValueError):
        exponential_buckets(1.0, 1.0, 4)


def test_registry_counts_from_many_threads():
    """The sharded fan-out records from worker threads: with more threads
    than cores and a short switch interval, no increment is lost and
    every child is made once."""
    import sys
    obs.enable()
    n_threads = 2 * (os.cpu_count() or 8)

    def work(t):
        for k in range(400):
            obs.counter("repro_mt_total", "x", ("surface",)).labels(
                f"s{k % 4}").inc()
            obs.histogram("repro_mt_seconds", "h").observe(1e-4 * t)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    r = obs.registry()
    assert [r.value("repro_mt_total", f"s{s}") for s in range(4)] == \
        [100.0 * n_threads] * 4
    assert obs.snapshot()["repro_mt_seconds"]["series"][0]["count"] == \
        400 * n_threads


# ---------------------------------------------------------------------------
# tracing: balance, parenting, export
# ---------------------------------------------------------------------------


def test_span_nesting_records_parents():
    obs.enable()
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    ev = obs.tracer().events()
    inner = next(e for e in ev if e.name == "inner")
    outer = next(e for e in ev if e.name == "outer")
    assert inner.parent_id == outer.span_id
    assert outer.parent_id is None
    assert obs.tracer().active_depth() == 0


def test_spans_nest_per_thread():
    """A span opened on one thread never parents another thread's."""
    obs.enable()
    barrier = threading.Barrier(4)

    def work(t):
        with obs.span(f"outer{t}"):
            barrier.wait()
            with obs.span(f"inner{t}"):
                pass
    with obs.span("main"):
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    ev = {e.name: e for e in obs.tracer().events()}
    for t in range(4):
        assert ev[f"inner{t}"].parent_id == ev[f"outer{t}"].span_id
        assert ev[f"outer{t}"].parent_id is None
    assert obs.tracer().active_depth() == 0


def test_spans_balanced_across_exceptions():
    """A raising body still pops its span, marks it failed and counts the
    error."""
    obs.enable()
    with pytest.raises(RuntimeError):
        with obs.op("serve.fail"):
            raise RuntimeError("boom")
    assert obs.tracer().active_depth() == 0
    ev = obs.tracer().events()
    assert len(ev) == 1 and ev[0].ok is False
    assert ev[0].attrs.get("error") == "RuntimeError"
    r = obs.registry()
    assert r.value("repro_op_errors_total", "serve.fail") == 1.0
    assert r.value("repro_op_total", "serve.fail") == 1.0
    with obs.op("serve.next"):
        pass
    assert obs.tracer().active_depth() == 0


def test_op_records_count_latency_error_families():
    obs.enable()
    with obs.op("serve.thing") as sp:
        sp.set("rows", 3)
    snap = obs.snapshot()
    assert obs.registry().value("repro_op_total", "serve.thing") == 1.0
    series = snap["repro_op_seconds"]["series"][0]
    assert series["count"] == 1 and series["sum"] >= 0.0
    assert "repro_op_errors_total" not in snap


def test_ring_buffer_bounds_and_counts_drops():
    t = Tracer(capacity=4)
    for i in range(10):
        with t.span(f"s{i}"):
            pass
    assert len(t.events()) == 4
    assert t.spans_started == 10 and t.spans_finished == 10
    assert t.spans_dropped == 6
    assert [e.name for e in t.events()] == ["s6", "s7", "s8", "s9"]


def test_chrome_trace_export(tmp_path):
    obs.enable()
    with obs.span("outer") as sp:
        sp.set("rows", 5)
        with obs.span("inner"):
            pass
    path = tmp_path / "trace.jsonl"
    n = obs.export_chrome(str(path))
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert n == len(lines) == 2
    for ev in lines:
        assert ev["ph"] == "X" and ev["ts"] >= 0 and ev["dur"] >= 0
    outer = next(e for e in lines if e["name"] == "outer")
    inner = next(e for e in lines if e["name"] == "inner")
    assert outer["args"]["rows"] == 5
    assert inner["args"]["parent_id"] == outer["args"]["span_id"]


# ---------------------------------------------------------------------------
# quality: ingest, recovery, canary SLO
# ---------------------------------------------------------------------------


def test_quality_ingest_tau_and_overflow():
    r = MetricsRegistry()
    q = QualityMonitor(r)
    q.observe_ingest([0.5, 0.3], [0, 2])
    q.observe_ingest(0.1, 0)
    assert r.value("repro_quality_tau_last") == pytest.approx(0.1)
    assert r.value("repro_quality_ingest_rows_total") == 3
    assert r.value("repro_quality_overflow_entries_total") == 2
    assert r.value("repro_quality_overflow_rows_total") == 1
    q.observe_ingest(np.inf)   # keep-everything rows spare the EWMA
    assert np.isfinite(r.value("repro_quality_tau_ewma"))


def test_observe_recovery_gauges():
    r = MetricsRegistry()
    observe_recovery(r, replayed_ops=7, dropped_tail=1,
                     snapshot_mtime=90.0, now=100.0)
    assert r.value("repro_recovery_total") == 1
    assert r.value("repro_recovery_replayed_ops") == 7
    assert r.value("repro_recovery_dropped_tail") == 1
    assert r.value("repro_recovery_snapshot_age_seconds") == 10.0
    observe_recovery(r, replayed_ops=0, dropped_tail=0, snapshot_mtime=None)
    assert r.value("repro_recovery_snapshot_age_seconds") == -1.0


def test_chebyshev_halfwidth_formula():
    assert chebyshev_halfwidth(4.0, 9.0, 101, 0.05) == pytest.approx(
        np.sqrt(2.0 / 100 * 36.0 / 0.05))
    assert chebyshev_halfwidth(4.0, 9.0, 101, 0.05) == \
        jobs.chebyshev_halfwidth(4.0, 9.0, 101, 0.05)


def test_canary_healthy_index_within_budget():
    rng = np.random.default_rng(5)
    n, m = 512, 256
    idx = SketchIndex(m=m, n_buckets=1024, seed=11, device=CPU)
    V = rng.normal(size=(4, n)).astype(np.float32)
    idx.add_many([f"v{i}" for i in range(4)], V)
    qv = rng.normal(size=n).astype(np.float32)
    r = MetricsRegistry()
    mon = CanaryMonitor.from_vectors(
        idx, [("c0", qv, "v0", V[0])], registry=r, m=m)
    readings = mon.check()
    assert len(readings) == 1 and not readings[0].violated
    assert r.value("repro_canary_slo_ok") == 1.0
    assert r.value("repro_canary_checks_total") == 1


def test_canary_maybe_check_rate_limits():
    rng = np.random.default_rng(6)
    idx = SketchIndex(m=32, n_buckets=64, seed=11, device=CPU)
    v = rng.normal(size=128).astype(np.float32)
    idx.add("v0", v)
    r = MetricsRegistry()
    mon = CanaryMonitor.from_vectors(idx, [("c", v, "v0", v)],
                                     registry=r, every=3)
    assert mon.maybe_check() is None
    assert mon.maybe_check() is None
    assert mon.maybe_check() is not None
    assert r.value("repro_canary_checks_total") == 1


@pytest.mark.parametrize("side", ["port", "ref"])
def test_canary_flags_injected_shard_loss(side):
    """Half the shards of a resilient index killed: degraded reads cover
    half the all-ones target's mass, so the realized error (n / 2) blows
    through the half-width that certified the healthy estimator, and the
    error-budget gauge flips.  The same on both packages."""
    L = T if side == "port" else J
    kw = {"device": CPU} if side == "port" else {}
    n, shards, m = 1024, 4, 256
    idx = L.ResilientSketchIndex(
        n, num_shards=shards, m=m, n_buckets=512, seed=11,
        retry=L.RetryPolicy(attempts=1, deadline=None),
        sleep=lambda s: None, **kw)
    ones = np.ones(n, np.float32)
    idx.add("target", ones)
    r = MetricsRegistry()
    mon = CanaryMonitor.from_vectors(
        idx, [("ones", ones, "target", ones)], registry=r, m=m)
    healthy = mon.check()[0]
    assert not healthy.violated and healthy.error < 1e-3
    assert r.value("repro_canary_slo_ok") == 1.0

    idx.kill_shard(1)
    idx.kill_shard(3)
    degraded = mon.check()[0]
    assert degraded.error == pytest.approx(n / 2, rel=1e-3)
    assert degraded.violated
    assert r.value("repro_canary_slo_ok") == 0.0
    assert r.value("repro_canary_error_budget_ratio") > 1.0
    assert r.value("repro_canary_violations_total") == 1
    assert r.value("repro_canary_budget_ratio", "ones") > 1.0


# ---------------------------------------------------------------------------
# enabled: the serve hooks feed the registry
# ---------------------------------------------------------------------------


def test_sketch_index_hooks_record():
    obs.enable()
    rng = np.random.default_rng(7)
    idx = SketchIndex(m=32, n_buckets=64, seed=11, device=CPU)
    V = rng.normal(size=(3, 128)).astype(np.float32)
    idx.add_many([f"v{i}" for i in range(3)], V)
    idx.query(rng.normal(size=128).astype(np.float32))
    idx.all_pairs()
    r = obs.registry()
    assert r.value("repro_op_total", "serve.index.add_many") == 1.0
    assert r.value("repro_op_total", "serve.index.query") == 1.0
    assert r.value("repro_op_total", "serve.index.all_pairs") == 1.0
    assert r.value("repro_quality_ingest_rows_total") == 3
    snap = obs.snapshot()
    kernels = {s["labels"]["kernel"]
               for s in snap["repro_kernel_launches_total"]["series"]}
    assert "intersect_estimate.query" in kernels
    assert "intersect_estimate.allpairs" in kernels
    assert obs.tracer().active_depth() == 0


def test_discovery_scanstats_fold_into_registry():
    from repro_torch.serve import DiscoveryEngine
    obs.enable()
    rng = np.random.default_rng(8)
    idx = SketchIndex(m=32, n_buckets=64, seed=11, device=CPU)
    D = 24
    V = rng.normal(size=(D, 128)).astype(np.float32)
    idx.add_many([f"v{i}" for i in range(D)], V)
    eng = DiscoveryEngine(idx, tile=8)
    res = eng.top_pairs(k=5)
    r = obs.registry()
    assert r.value("repro_discovery_scans_total", "pairs") == 1.0
    assert r.value("repro_discovery_tiles_total", "pairs") == \
        res.stats.tiles_total
    assert r.value("repro_discovery_tiles_pruned_total", "pairs") == \
        res.stats.tiles_pruned
    assert r.value("repro_discovery_kernel_launches_total", "pairs") == \
        res.stats.kernel_launches
    assert r.value("repro_op_total", "serve.discovery.top_pairs") == 1.0


def test_validation_rejects_counted():
    obs.enable()
    idx = SketchIndex(m=16, n_buckets=32, seed=1, device=CPU)
    idx.add("a", np.ones(32, np.float32))
    with pytest.raises(ValueError):
        idx.add("a", np.ones(32, np.float32))
    with pytest.raises(ValueError):
        idx.add("b", np.full(32, np.nan, np.float32))
    r = obs.registry()
    assert r.value("repro_validation_rejects_total", "duplicate_name") == 1.0
    assert r.value("repro_validation_rejects_total", "nonfinite") == 1.0
    assert obs.tracer().active_depth() == 0   # failed adds popped cleanly


def test_durable_snapshot_recover_health(tmp_path):
    from repro_torch.serve import DurableSketchIndex
    obs.enable()
    rng = np.random.default_rng(9)
    kw = dict(m=32, n_buckets=64, seed=3, device=CPU)
    dur = DurableSketchIndex(str(tmp_path), **kw)
    dur.add("a", rng.normal(size=128).astype(np.float32))
    dur.snapshot()
    dur.add("b", rng.normal(size=128).astype(np.float32))
    dur.journal.close()
    DurableSketchIndex.recover(str(tmp_path), **kw)
    r = obs.registry()
    assert r.value("repro_snapshots_total") == 1.0
    assert r.value("repro_wal_appends_total", "add") >= 2.0
    assert r.value("repro_recovery_total") == 1.0
    assert r.value("repro_recovery_replayed_ops") == 1.0   # "b" replayed
    assert r.value("repro_recovery_snapshot_age_seconds") >= 0.0
    assert r.value("repro_op_total", "serve.durable.snapshot") == 1.0
    assert r.value("repro_op_total", "serve.durable.recover") == 1.0


# ---------------------------------------------------------------------------
# the whole registry against the reference's after the same workload
# ---------------------------------------------------------------------------

PARTS = ("ingest", "query", "recovery", "degraded")


def _workload(side: str, part: str, tmp: str) -> None:
    """One part of the shared workload through one package, its
    observability enabled."""
    L = T if side == "port" else J
    kw = {"device": CPU} if side == "port" else {}
    rng = np.random.default_rng(41)
    V = sparse_block(rng, 12, 1024, 200)
    q = rng.normal(size=1024).astype(np.float32)
    cfg = dict(m=48, n_buckets=96, slots=2, seed=5)
    if part in ("ingest", "query"):
        idx = L.SketchIndex(**cfg, **kw)
        idx.add_many([f"v{d}" for d in range(8)], V[:8])
        idx.add("v8", V[8])
        nz = np.flatnonzero(V[9])
        idx.add("v9", indices=nz, values=V[9][nz])
        with pytest.raises(ValueError):
            idx.add("v9", V[9])
        with pytest.raises(ValueError):
            idx.add("bad", np.full(1024, np.nan, np.float32))
        if part == "query":
            idx.query(q)
            idx.query(q, top_k=3)
            idx.all_pairs()
    elif part == "recovery":
        d = os.path.join(tmp, side)
        dur = L.DurableSketchIndex(d, **cfg, **kw)
        dur.add_many([f"v{d}" for d in range(4)], V[:4])
        dur.snapshot()
        dur.add("v4", V[4])
        newest = dur.snapshot()
        dur.add("v5", V[5])
        dur.journal.close()
        with open(os.path.join(newest, "val.npy"), "r+b") as f:
            f.seek(-3, os.SEEK_END)
            byte = f.read(1)
            f.seek(-3, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0x21]))
        with open(dur.journal.path, "a") as f:
            f.write('{"seq": 99, "op": "add", "crc"')
        L.DurableSketchIndex.recover(d, **cfg, **kw).journal.close()
    else:
        def flaky(shard, fn):
            if shard == 2:
                raise TimeoutError("hung")
            if shard == 0 and flaky.fails:
                flaky.fails -= 1
                raise ConnectionError("flake")
            return fn()
        flaky.fails = 1
        idx = L.ResilientSketchIndex(
            1024, num_shards=4, m=48, n_buckets=96, seed=5,
            retry=L.RetryPolicy(attempts=2, base_delay=0.0, deadline=None),
            call_wrapper=flaky, sleep=lambda s: None, **kw)
        idx.add_many([f"v{d}" for d in range(12)], V)
        idx.query(q)
        idx.kill_shard(3)
        idx.all_pairs()
        ms = L.ResilientMatrixStore(
            128, 4, num_shards=2, m=16, seed=5,
            retry=L.RetryPolicy(attempts=1, deadline=None), **kw)
        A = rng.normal(size=(2, 128, 4)).astype(np.float32)
        ms.add("A", A[0])
        ms.add("B", A[1])
        ms.kill_shard(1)
        ms.query(A[0])
        ms.products([("A", "B")])


def _series(snap: dict) -> dict:
    """{(family, kind, label names, label values): value or histogram
    count}, the values of ``*_seconds`` families left out."""
    out = {}
    for name, fam in snap.items():
        for s in fam["series"]:
            key = (name, fam["kind"], tuple(fam["labels"]),
                   tuple(s["labels"][k] for k in fam["labels"]))
            if fam["kind"] == "histogram":
                out[key] = s["count"]
            else:
                out[key] = None if name.endswith("_seconds") else s["value"]
    return out


@pytest.mark.parametrize("part", PARTS)
def test_registry_matches_reference_after_workload(tmp_path, both_enabled,
                                                   part):
    """The same workload part through both packages: the same families,
    kinds, label names and label values, and the same counter and gauge
    values (histogram counts for histograms; ``*_seconds`` values aside).
    The reference's ``repro_engine_traces_total`` (its JAX retraces) has
    no counterpart, and its engine spans come from jitted builds the port
    does not have: the ``engine.*`` op series are compared only where
    both record them."""
    _workload("ref", part, str(tmp_path))
    _workload("port", part, str(tmp_path))
    got, want = _series(obs.snapshot()), _series(jobs.snapshot())
    want = {k: v for k, v in want.items()
            if k[0] != "repro_engine_traces_total"
            and not (k[3] and k[3][0].startswith("engine."))}
    got = {k: v for k, v in got.items()
           if not (k[3] and k[3][0].startswith("engine."))}
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, float) and not np.isfinite(value):
            assert got[key] == value, key
        else:
            assert got[key] == pytest.approx(value, rel=1e-12), key
    assert obs.tracer().active_depth() == 0


def test_prometheus_text_parses_line_by_line(tmp_path, both_enabled):
    """Every line of the exposition after the whole workload is a HELP, a
    TYPE or a sample with a number; the samples are the reference's, by
    name and labels."""
    for part in PARTS:
        _workload("port", part, str(tmp_path))
        _workload("ref", part, str(tmp_path))
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                        r'(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
                        r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)\})?'
                        r' (\S+)$')

    def samples(text):
        out = set()
        for line in text.splitlines():
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                assert len(line.split(" ", 3)) >= 3, line
                continue
            m = sample.match(line)
            assert m, f"unparseable exposition line {line!r}"
            float(m.group(7))
            if "engine" not in line:
                out.add(line.rsplit(" ", 1)[0])
        return out
    got = samples(obs.prometheus_text())
    want = samples(jobs.prometheus_text())
    assert got == want
    assert any(s.startswith("repro_wal_appends_total") for s in got)
    assert any(s.startswith("repro_recovery_") for s in got)
    assert any(s.startswith("repro_degraded_results_total") for s in got)
