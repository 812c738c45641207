"""Port parity of the ingest quality metrics: ``repro_torch.obs``'s
quality monitor against ``repro.obs.quality.QualityMonitor``, fed the
same batches directly and through both ``SketchIndex``es (CPU, ``obs``
enabled on each side).  Counters must be equal; the tau gauges agree to
1e-12 relative (the same float64 arithmetic on the same taus)."""
import numpy as np
import pytest

from _torch_common import sparse_block

import repro.obs as jobs
from repro.obs.metrics import MetricsRegistry
from repro.obs.quality import QualityMonitor as JQualityMonitor
from repro.serve import SketchIndex as JIndex
from repro_torch import obs
from repro_torch.serve import SketchIndex

GAUGES = ("repro_quality_tau_last", "repro_quality_tau_ewma")
COUNTERS = ("repro_quality_ingest_rows_total",
            "repro_quality_overflow_entries_total",
            "repro_quality_overflow_rows_total")


@pytest.fixture
def both_enabled():
    """Both registries reset and enabled for the test, and reset and
    disabled after it."""
    jobs.reset()
    obs.reset()
    jobs.enable()
    obs.enable()
    try:
        yield
    finally:
        jobs.disable()
        obs.disable()
        jobs.reset()
        obs.reset()


def _port_value(name: str) -> float:
    return obs.snapshot().get((name, ""), 0.0)


def _assert_same(read_ref) -> dict:
    """The five metrics of both sides: gauges within 1e-12 relative,
    counters equal.  Returns the port's values."""
    got = {}
    for name in GAUGES:
        got[name] = _port_value(name)
        assert got[name] == pytest.approx(read_ref(name), rel=1e-12,
                                          abs=0.0), name
    for name in COUNTERS:
        got[name] = _port_value(name)
        assert got[name] == read_ref(name), name
    return got


def test_quality_monitor_matches_reference_on_raw_batches(both_enabled):
    """Arrays, scalars, an all-inf batch (no EWMA step), an empty batch,
    drops given and not given."""
    ref = JQualityMonitor(MetricsRegistry())
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
    assert obs.quality_monitor() is not mon
    assert obs.snapshot() == {}


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
    j = JIndex(**cfg)
    t = SketchIndex(**cfg, device="cpu")
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
    obs.reset()
    assert not obs.enabled()
    t = SketchIndex(m=16, n_buckets=64, slots=2, device="cpu")
    t.add("a", np.ones(64, np.float32))
    t.add_many(["b"], np.ones((1, 64), np.float32))
    assert obs.snapshot() == {}
