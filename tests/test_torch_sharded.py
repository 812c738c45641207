"""Port parity of sharded serving: ``repro_torch.serve.ShardedSketchIndex``
and ``ShardedDiscoveryEngine`` (on ``device="cpu"``, the kernels' plain
versions) against ``repro.serve``'s on the same rows, at the reference
tests' sizes (D = 36 over n = 256, 3 shards, m, B, S = 32, 64, 2); the
retry guard (``RetryPolicy``, ``ShardHealth``, ``HeartbeatMonitor``); the
fan-out's metrics; and ``partitioned_sketch_corpus_sharded`` in 2 and 4
gloo ranks against the JAX one-shot build.

Each shard's host blocks and the global ``_homes`` are bit-equal to the
reference's; scan results equal in names and order (estimates within
``RTOL``), in ``ScanStats`` field for field and in ``degraded``,
``coverage``, ``lost_pairs`` and ``lost_shards``.  The corpora are
sketched once a module in both packages."""
import dataclasses
import os
import signal
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_common import RTOL, assert_bits, atol_for
from _torch_common import release_jax_executables  # noqa: F401

import jax.numpy as jnp
import repro.obs as jobs
import repro.private as rp
from repro.kernels.sketch_build import build_priority_corpus as j_priority
from repro.kernels.sketch_build import build_threshold_corpus as j_threshold
from repro.serve import RetryPolicy as JRetryPolicy
from repro.serve import ShardedSketchIndex as JSharded
from repro.serve import ShardHealth as JShardHealth
from repro.serve.discovery import ShardedDiscoveryEngine as JEngine
from repro.train.fault_tolerance import HeartbeatMonitor as JHeartbeat
from repro_torch import obs
from repro_torch.distributed import (partitioned_sketch_corpus,
                                     partitioned_sketch_corpus_sharded)
from repro_torch.kernels import _build
from repro_torch.private import DPParams
from repro_torch.serve import (ResilienceError, RetryPolicy, ScanStats,
                               ShardDownError, ShardedDiscoveryEngine,
                               ShardedSketchIndex, ShardHealth, SketchIndex)
from repro_torch.train import HeartbeatMonitor

M, B, S, N = 32, 64, 2, 256
STATE = ("_idx", "_val", "_tau", "_dropped", "_g", "_kn", "_head_idx",
         "_head_val", "_head_kept")
TESTS = Path(__file__).resolve().parent


def _matrix(D=36, seed=0):
    """The reference tests' sharded corpus (``tests/test_discovery.py::
    _sharded``): 1/d-scaled Gaussian rows, row 1 a noisy copy of row 0."""
    rng = np.random.default_rng(seed)
    scales = (np.arange(1, D + 1, dtype=np.float32) ** -1.0) * 5.0
    X = rng.standard_normal((D, N)).astype(np.float32) * scales[:, None]
    X[1] = 0.9 * X[0] + 0.1 * rng.standard_normal(N).astype(np.float32)
    return X


def _both(X, shards, rng_seed=None, **kw):
    """The same rows through both packages' sharded ``add_many``; every
    shard's host blocks and the homes bit-equal.  ``rng_seed``: each
    package's shards share one ``dp_rng`` of that seed."""
    names = [f"c{i}" for i in range(X.shape[0])]
    jkw = dict(kw)
    if jkw.get("dp") is not None:
        jkw["dp"] = rp.DPParams(*jkw["dp"])
    if rng_seed is not None:
        kw["dp_rng"] = np.random.default_rng(rng_seed)
        jkw["dp_rng"] = np.random.default_rng(rng_seed)
    j = JSharded(num_shards=shards, m=M, n_buckets=B, slots=S, **jkw)
    t = ShardedSketchIndex(num_shards=shards, m=M, n_buckets=B, slots=S,
                           device="cpu", **kw)
    j.add_many(names, X)
    t.add_many(names, X)
    _same_state(t, j)
    return j, t


def _same_state(t, j):
    assert t._names == j._names
    assert t._homes == j._homes
    assert t.total_dropped == j.total_dropped
    for ts, js in zip(t._shards, j._shards, strict=True):
        assert ts._names == js._names and ts.capacity == js.capacity
        for name in STATE:
            assert_bits(getattr(ts, name), getattr(js, name))


@pytest.fixture(scope="module")
def corpus():
    """(shards, seed) -> (JAX sharded index, port sharded index, X), built
    once a module; tests that ingest or inject faults build engines of
    their own over these."""
    cache = {}

    def get(shards=3, seed=0):
        if (shards, seed) not in cache:
            X = _matrix(seed=seed)
            cache[shards, seed] = (*_both(X, shards), X)
        return cache[shards, seed]
    return get


def _true_pairs(est, names, k, absolute=False):
    """``all_pairs()`` plus the reference tests' sort: descending score,
    ties by ascending (row, column)."""
    iu, ju = np.triu_indices(est.shape[0], k=1)
    v = est[iu, ju]
    score = np.abs(v) if absolute else v
    order = np.lexsort((ju, iu, -score))[:k]
    return [(names[iu[o]], names[ju[o]], float(v[o])) for o in order]


def _same_items(got, want):
    """Names and order equal; estimates within ``RTOL``."""
    assert [it[:-1] for it in got] == [it[:-1] for it in want]
    g = np.array([it[-1] for it in got])
    w = np.array([it[-1] for it in want])
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol_for(w))


def _same_result(got, want):
    """Items, every ``ScanStats`` field (the merged threshold is unset on
    both sides) and the degradation fields equal."""
    _same_items(got.items, want.items)
    for f in dataclasses.fields(ScanStats):
        assert getattr(got.stats, f.name) == getattr(want.stats, f.name), \
            f.name
    assert (got.degraded, got.coverage, got.lost_pairs, got.lost_shards) \
        == (want.degraded, want.coverage, want.lost_pairs, want.lost_shards)


def _no_sleep(_seconds):
    pass


# ---------------------------------------------------------------------------
# state, all_pairs and query against the reference and the global index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_shard_state_and_homes_bit_equal(shards):
    """Round-robin routing: each shard's blocks and the global homes equal
    the reference's, also with an ``add`` after the batch."""
    X = _matrix(D=23, seed=shards)
    j, t = _both(X[:20], shards)
    for i in range(20, 23):
        j.add(f"c{i}", X[i])
        t.add(f"c{i}", X[i])
    _same_state(t, j)
    assert len(t) == len(j) == 23


def test_sharded_all_pairs_matches_reference_and_global(corpus):
    """Within ``RTOL`` of the reference's sharded matrix; each cell
    bit-equal to the global index's over the same rows (a cell depends on
    its two rows only)."""
    j, t, X = corpus()
    got = t.all_pairs()
    np.testing.assert_allclose(got, np.asarray(j.all_pairs()), rtol=RTOL,
                               atol=atol_for(got))
    g = SketchIndex(M, n_buckets=B, slots=S, device="cpu")
    g.add_many(t._names, X)
    assert_bits(got, g.all_pairs())


@pytest.mark.parametrize("mode", ["plain", "bias_aware"])
def test_sharded_query_matches_reference_and_global(corpus, mode):
    j, t, X = corpus()
    q = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    got = t.query(q, mode=mode)
    want = j.query(q, mode=mode)
    assert [n for n, _ in got] == [n for n, _ in want]
    g_est = np.array([e for _, e in got])
    w_est = np.array([e for _, e in want])
    np.testing.assert_allclose(g_est, w_est, rtol=RTOL, atol=atol_for(w_est))
    # the sharded index reassembles into float32, as the reference's does
    g = SketchIndex(M, n_buckets=B, slots=S, device="cpu")
    g.add_many(t._names, X)
    glob = g.query(q, mode=mode)
    assert [n for n, _ in got] == [n for n, _ in glob]
    assert_bits(g_est.astype(np.float32),
                np.array([e for _, e in glob], np.float32))
    top = t.query(q, top_k=6, mode=mode)
    assert [n for n, _ in top] == [n for n, _ in j.query(q, top_k=6,
                                                         mode=mode)]


def test_sharded_private_query_matches_reference():
    """Each shard charges its own accountant; one seeded ``dp_rng`` a
    package, drawn shard 0..P-1 in order: the answers, every shard's
    release and its ledger equal the reference's."""
    X = _matrix(D=20, seed=4)
    params = DPParams(epsilon=4.0, clamp=1.0, p_floor=0.05)
    j, t = _both(X, 3, rng_seed=3, dp=params)
    q = X[0] + 0.5 * X[3]
    for _ in range(2):   # the second query reads the cached releases
        got = np.array([e for _, e in t.query(q, mode="private")])
        want = np.array([e for _, e in j.query(q, mode="private")])
        np.testing.assert_allclose(got, want, rtol=1e-12)
    for ts, js in zip(t._shards, j._shards, strict=True):
        assert_bits(ts._private_release.idx, js._private_release.idx)
        assert_bits(ts._private_release.z, js._private_release.z)
        led = [(r.label, r.epsilon, r.delta, r.mem_epsilon)
               for r in ts.accountant.ledger]
        assert led == [(r.label, r.epsilon, r.delta, r.mem_epsilon)
                       for r in js.accountant.ledger]
        assert len(led) == 1


# ---------------------------------------------------------------------------
# the sharded fan-out against the reference (tests/test_discovery.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("absolute", [False, True])
@pytest.mark.parametrize("ceiling", ["admissible", "chebyshev"])
@pytest.mark.parametrize("tile", [4, 64])
def test_sharded_top_pairs_matches_reference(corpus, tile, ceiling,
                                             absolute):
    """Against the reference's fan-out; admissible scans also equal the
    global ``all_pairs()`` plus the sort (names in order)."""
    j, t, _ = corpus()
    got = ShardedDiscoveryEngine(t, tile=tile, ceiling=ceiling).top_pairs(
        8, absolute=absolute)
    want = JEngine(j, tile=tile, ceiling=ceiling).top_pairs(
        8, absolute=absolute)
    _same_result(got, want)
    assert not got.degraded and got.coverage == 1.0
    if ceiling == "admissible":
        _same_items(got.items, _true_pairs(t.all_pairs(), t._names, 8,
                                           absolute))


def test_sharded_top_pairs_matches_global(corpus):
    """``tests/test_discovery.py::test_sharded_top_pairs_matches_global``
    through the index's lazy engine."""
    j, t, _ = corpus()
    res = t.top_pairs(k=8)
    _same_items(res.items, _true_pairs(t.all_pairs(), t._names, 8))
    _same_result(res, j.top_pairs(k=8))
    assert isinstance(t._discovery, ShardedDiscoveryEngine)


@pytest.mark.parametrize("absolute", [False, True])
def test_sharded_query_scan_matches_reference(corpus, absolute):
    """``tests/test_discovery.py::test_sharded_query_matches_global``:
    the fan-out's names equal ``query(top_k=6)``'s."""
    j, t, _ = corpus()
    q = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    got = t.top_k_for_query(q, k=6, absolute=absolute)
    _same_result(got, j.top_k_for_query(q, k=6, absolute=absolute))
    if not absolute:
        assert [nm for nm, _ in got.items] == \
            [nm for nm, _ in t.query(q, top_k=6)]


def test_shard_loss_degrades_with_quantified_coverage(corpus):
    """Shard 1 raises ``ConnectionError``: its tasks are tried twice, then
    lost; the coverage is the surviving pairs' share; every surviving true
    pair is still found, in order; all fields equal the reference's."""
    j, t, _ = corpus()
    dead = 1
    out = {}
    for pkg, index, engine, policy in ((
            "port", t, ShardedDiscoveryEngine, RetryPolicy), (
            "jax", j, JEngine, JRetryPolicy)):
        calls = []

        def wrapper(shards, fn, calls=calls):
            calls.append(shards)
            if dead in shards:
                raise ConnectionError("injected shard loss")
            return fn()

        eng = engine(index, retry=policy(attempts=2, base_delay=0.0),
                     call_wrapper=wrapper, sleep=_no_sleep)
        out[pkg] = (eng.top_pairs(k=8), Counter(calls))
    res, calls = out["port"]
    _same_result(res, out["jax"][0])
    assert calls == out["jax"][1]
    assert res.degraded and 0 < res.coverage < 1
    assert res.lost_pairs == ((0, 1), (1, 1), (1, 2))
    sizes = [len(s) for s in t._shards]
    lost = sizes[0] * sizes[1] + sizes[1] * (sizes[1] - 1) // 2 \
        + sizes[1] * sizes[2]
    D = len(t)
    assert res.coverage == (D * (D - 1) // 2 - lost) / (D * (D - 1) // 2)
    assert all(calls[key] == 2 for key in res.lost_pairs)
    name_shard = {nm: s for nm, (s, _) in zip(t._names, t._homes)}
    surviving = [it[:2] for it in _true_pairs(t.all_pairs(), t._names, 8)
                 if name_shard[it[0]] != dead and name_shard[it[1]] != dead]
    got = [it[:2] for it in res.items]
    assert surviving == [p for p in got if p in surviving]
    assert set(surviving) <= set(got)


def test_query_scan_shard_loss_coverage(corpus):
    """A lost shard costs the query scan its rows: coverage is the
    surviving rows' share, as the reference reckons it."""
    j, t, X = corpus()
    q = X[2] - 0.3 * X[7]

    def wrapper(shards, fn):
        if 2 in shards:
            raise ConnectionError("injected shard loss")
        return fn()

    got = ShardedDiscoveryEngine(
        t, retry=RetryPolicy(attempts=2, base_delay=0.0),
        call_wrapper=wrapper, sleep=_no_sleep).top_k_for_query(q, k=5)
    want = JEngine(j, retry=JRetryPolicy(attempts=2, base_delay=0.0),
                   call_wrapper=wrapper, sleep=_no_sleep
                   ).top_k_for_query(q, k=5)
    _same_result(got, want)
    assert got.lost_pairs == ((2,),)
    assert got.coverage == (len(t) - len(t._shards[2])) / len(t)


def test_killed_shard_skipped_without_calls(corpus):
    j, t, _ = corpus(shards=2)
    out = {}
    for pkg, index, engine in (("port", t, ShardedDiscoveryEngine),
                               ("jax", j, JEngine)):
        seen = []
        eng = engine(index, call_wrapper=lambda shards, fn, seen=seen: (
            seen.append(shards), fn())[1])
        eng.kill_shard(0, "maintenance")
        down = eng.top_pairs(k=4)
        assert all(0 not in key for key in seen)
        eng.revive_shard(0)
        out[pkg] = (down, eng.top_pairs(k=4), sorted(seen))
    down, up, seen = out["port"]
    _same_result(down, out["jax"][0])
    _same_result(up, out["jax"][1])
    assert seen == out["jax"][2]
    assert down.degraded and down.lost_shards == (0,)
    assert down.lost_pairs == ((0, 0), (0, 1))
    assert not up.degraded and up.coverage == 1.0 and up.lost_shards == ()


def test_timeout_is_terminal_immediately(corpus):
    """A ``TimeoutError`` is never retried, whatever ``attempts`` says."""
    j, t, _ = corpus(shards=2)
    out = {}
    for pkg, index, engine, policy in ((
            "port", t, ShardedDiscoveryEngine, RetryPolicy), (
            "jax", j, JEngine, JRetryPolicy)):
        attempts = []

        def wrapper(shards, fn, attempts=attempts):
            attempts.append(shards)
            if 0 in shards:
                raise TimeoutError("hung shard")
            return fn()

        eng = engine(index, retry=policy(attempts=5, base_delay=0.0),
                     call_wrapper=wrapper, sleep=_no_sleep)
        out[pkg] = (eng.top_pairs(k=4), Counter(attempts))
    res, counts = out["port"]
    _same_result(res, out["jax"][0])
    assert counts == out["jax"][1]
    assert res.degraded
    assert all(counts[key] == 1 for key in counts if 0 in key)
    assert counts[(1, 1)] == 1


def test_deadline_stops_retries_and_backoff_doubles(corpus):
    """Backoff sleeps double from ``base_delay`` up to ``max_delay``; once
    the deadline has passed on the injected clock, no further try."""
    j, t, _ = corpus(shards=2)
    out = {}
    for pkg, index, engine, policy in ((
            "port", t, ShardedDiscoveryEngine, RetryPolicy), (
            "jax", j, JEngine, JRetryPolicy)):
        now = [0.0]
        slept = []

        def sleep(s, now=now, slept=slept):
            slept.append(s)
            now[0] += s

        def wrapper(shards, fn):
            if shards == (1, 1):
                raise ConnectionError("flaky")
            return fn()

        eng = engine(index, retry=policy(attempts=10, base_delay=0.5,
                                         max_delay=1.5, deadline=3.0),
                     call_wrapper=wrapper, sleep=sleep,
                     clock=lambda now=now: now[0], max_workers=1)
        out[pkg] = (eng.top_pairs(k=4), slept)
    res, slept = out["port"]
    _same_result(res, out["jax"][0])
    assert slept == out["jax"][1] == [0.5, 1.0, 1.5]
    assert res.lost_pairs == ((1, 1),)


def test_sharded_errors_match_reference():
    """``tests/test_serve.py``'s sharded cases: a duplicate name routed to
    the other shard, an empty index's query; and an empty scan, a
    duplicate across an ``add_many`` batch, a wrong width (the global
    lists untouched) and zero shards."""
    rng = np.random.default_rng(9)
    v = rng.normal(size=64).astype(np.float32)
    for cls, kw in ((JSharded, {}), (ShardedSketchIndex, {"device": "cpu"})):
        sh = cls(num_shards=2, m=16, n_buckets=64, slots=2, **kw)
        with pytest.raises(ValueError, match="empty index"):
            sh.query(np.ones(64, np.float32))
        with pytest.raises(ValueError, match="empty index"):
            sh.top_pairs()
        with pytest.raises(ValueError, match="empty index"):
            sh.top_k_for_query(v)
        sh.add("x", v)
        with pytest.raises(ValueError, match="duplicate"):
            sh.add("x", v)
        with pytest.raises(ValueError, match="duplicate"):
            sh.add_many(["y", "x"], np.stack([v, v]))
        with pytest.raises(ValueError, match="coordinates"):
            sh.add_many(["y", "z"], np.ones((2, 32), np.float32))
        assert sh._names == ["x"] and sh._homes == [(0, 0)]
        with pytest.raises(ValueError, match="at least one shard"):
            cls(num_shards=0, **kw)


def test_sharded_query_top_k_tie_order():
    """Duplicate vectors tie exactly: ascending global position wins."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal(128).astype(np.float32)
    got = {}
    for cls, kw in ((JSharded, {}), (ShardedSketchIndex, {"device": "cpu"})):
        sh = cls(num_shards=2, m=M, n_buckets=B, slots=S, **kw)
        sh.add_many(["d0", "d1", "d2", "d3"], np.stack([v, v, v, v]))
        got[cls] = ([nm for nm, _ in sh.query(v, top_k=2)],
                    [nm for nm, _ in sh.top_k_for_query(v, k=3).items],
                    [it[:2] for it in sh.top_pairs(k=3).items])
    assert got[ShardedSketchIndex] == got[JSharded]
    assert got[ShardedSketchIndex][0] == ["d0", "d1"]
    assert got[ShardedSketchIndex][1] == ["d0", "d1", "d2"]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


FANOUT_COUNTERS = ("repro_retry_attempts_total", "repro_deadline_hits_total",
                   "repro_retry_backoffs_total", "repro_shard_down_total")
SCAN_METRICS = ("repro_discovery_scans_total", "repro_discovery_tiles_total",
                "repro_discovery_tiles_launched_total",
                "repro_discovery_tiles_pruned_total",
                "repro_discovery_kernel_launches_total",
                "repro_discovery_peak_bytes",
                "repro_discovery_summary_tiles_refreshed")


def test_fanout_metrics_match_reference(corpus):
    """With both registries enabled: a degraded pair scan (retries, a
    timeout), a killed shard's query scan and a healthy pair scan on each
    side; the fan-out counters, coverage and shard gauges, the degraded
    counts, the scan metrics and the task spans equal the reference's.
    Nothing is recorded while disabled."""
    j, t, X = corpus()

    def wrapper(shards, fn):
        if shards == (0, 2):
            raise TimeoutError("hung")
        if 1 in shards:
            raise ConnectionError("lost")
        return fn()

    jobs.reset()
    obs.reset()
    jobs.enable()
    obs.enable()
    try:
        for index, engine, policy in ((j, JEngine, JRetryPolicy),
                                      (t, ShardedDiscoveryEngine,
                                       RetryPolicy)):
            eng = engine(index, tile=8, retry=policy(attempts=3,
                                                     base_delay=0.0),
                         call_wrapper=wrapper, sleep=_no_sleep)
            eng.top_pairs(k=5)
            eng.kill_shard(2)
            eng.top_k_for_query(X[3], k=4)
            healthy = engine(index, tile=8)
            healthy.top_pairs(k=3, absolute=True)
        snap = obs.snapshot()
        got = obs.registry().value
        reg = jobs.registry()
        for name in FANOUT_COUNTERS + ("repro_shards_down",):
            want = reg.value(name, "discovery")
            assert got(name, "discovery") == want, name
        assert got("repro_retry_attempts_total", "discovery") > 0
        for surface in ("discovery.pairs", "discovery.query"):
            for name in ("repro_quality_coverage",
                         "repro_degraded_results_total"):
                want = reg.value(name, surface)
                assert got(name, surface) == want, (name, surface)
        assert got("repro_degraded_results_total", "discovery.pairs") == 1
        for scan in ("pairs", "query"):
            for name in SCAN_METRICS:
                want = reg.value(name, scan)
                assert got(name, scan) == want, (name, scan)

        def tasks(spans):
            return sorted(tuple(sh) for sh in spans)
        assert tasks(s.attrs["shards"] for s in obs.tracer().events()
                     if s.name == "serve.discovery.task") == tasks(
            s.attrs["shards"] for s in jobs.tracer().events()
            if s.name == "serve.discovery.task")
        assert not any(ser["labels"].get("op") == "serve.discovery.task"
                       for fam in snap.values() for ser in fam["series"])
    finally:
        jobs.disable()
        obs.disable()
        jobs.reset()
        obs.reset()
    ShardedDiscoveryEngine(t, tile=8).top_pairs(k=3)
    assert obs.snapshot() == {} and obs.tracer().events() == []


# ---------------------------------------------------------------------------
# the retry guard's pieces
# ---------------------------------------------------------------------------


def test_retry_policy_matches_reference():
    assert dataclasses.asdict(RetryPolicy()) == \
        dataclasses.asdict(JRetryPolicy())
    with pytest.raises(dataclasses.FrozenInstanceError):
        RetryPolicy().attempts = 5
    assert issubclass(ShardDownError, ResilienceError)
    assert issubclass(ResilienceError, RuntimeError)


def test_heartbeat_monitor_matches_reference():
    t, j = HeartbeatMonitor(timeout=5.0), JHeartbeat(timeout=5.0)
    for mon in (t, j):
        mon.beat("a", now=0.0)
        mon.beat("b", now=3.0)
    for now in (4.0, 5.5, 8.5, 9.0):
        assert t.dead_workers(now) == j.dead_workers(now)
        assert t.healthy(now) == j.healthy(now)
    assert t.dead_workers(9.0) == ["a", "b"]


def test_shard_health_down_mark_heartbeat_timeout_and_revival():
    """The down-mark, the heartbeat timeout under an injected clock, and
    revival by a beat, step for step against the reference."""
    now = [100.0]
    t = ShardHealth(3, timeout=10.0, clock=lambda: now[0])
    j = JShardHealth(3, timeout=10.0, clock=lambda: now[0])

    def same():
        assert t.down_shards() == j.down_shards()
        assert [t.is_up(p) for p in range(3)] == \
            [j.is_up(p) for p in range(3)]

    same()
    assert t.down_shards() == {}
    for h in (t, j):
        h.mark_down(1, "drained")
    same()
    assert t.down_shards() == {1: "drained"}
    now[0] = 105.0
    for h in (t, j):
        h.beat(0)
    now[0] = 111.0          # shards 1 and 2 last beat at 100
    same()
    assert t.down_shards() == {1: "drained",
                               2: "no heartbeat for > 10.0s"}
    for h in (t, j):
        h.beat(1)
        h.beat(2)
    same()
    assert t.down_shards() == {}
    now[0] = 116.0          # shard 0 last beat at 105
    same()
    assert list(t.down_shards()) == [0]


def test_shard_health_shared_monitor():
    """A shared monitor's timeout wins and its earlier beats stay; only
    shards it never saw are registered live."""
    for health, mon_cls in ((ShardHealth, HeartbeatMonitor),
                            (JShardHealth, JHeartbeat)):
        mon = mon_cls(timeout=2.0)
        mon.beat(0, now=0.0)
        h = health(2, timeout=60.0, clock=lambda: 10.0, monitor=mon)
        assert h.timeout == 2.0 and h.monitor is mon
        assert mon.last_seen == {0: 0.0, 1: 10.0}
        assert h.down_shards() == {0: "no heartbeat for > 2.0s"}


# ---------------------------------------------------------------------------
# thread safety of the launch counter and the first load
# ---------------------------------------------------------------------------


def test_count_launch_loses_no_update_under_threads():
    """16 threads, a short switch interval: every increment lands."""
    def wrapper():
        pass
    wrapper.launches = 0
    threads, per = 16, 2000

    def work():
        for _ in range(per):
            _build.count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == threads * per


def test_concurrent_first_loads_build_once(tmp_path, monkeypatch):
    """8 threads' first ``load`` of one library: one build, one handle.
    The build is stood in for by a copy of the C math library (no
    ``nvcc`` here); the card test builds the real sources."""
    import ctypes.util
    libm = ctypes.util.find_library("m")
    if libm is None:
        pytest.skip("no C math library to stand in for a built kernel")
    src = next((p for p in (Path("/lib/x86_64-linux-gnu") / libm,
                            Path("/usr/lib/x86_64-linux-gnu") / libm,
                            Path("/lib64") / libm, Path("/usr/lib64") / libm)
                if p.exists()), None)
    if src is None:
        pytest.skip(f"{libm} not found on the usual paths")
    builds = []

    def fake_build_all():
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)   # other threads arrive meanwhile
        (tmp_path / "libfake.so").write_bytes(src.read_bytes())
        return {}

    monkeypatch.setattr(_build, "_build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_build_all", fake_build_all)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_BOUND", set())
    got = [None] * 8
    barrier = threading.Barrier(8)

    def first(i):
        barrier.wait(timeout=30)
        got[i] = _build.load("fake", {"cos": []})

    pool = [threading.Thread(target=first, args=(i,)) for i in range(8)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in pool)
    assert len(builds) == 1
    assert all(lib is got[0] for lib in got) and got[0] is not None
    assert ("fake", "cos") in _build._BOUND


# ---------------------------------------------------------------------------
# the multi-process partitioned build (gloo, CPU)
# ---------------------------------------------------------------------------


def _spawn_ranks(world, tmp_path):
    """Run ``_torch_sharded_worker.py`` with ``world`` gloo ranks; a hang
    fails within 120 s and leaves no rank behind."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(TESTS.parent / "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_sharded_worker.py"), str(world),
         str(tmp_path / "rendezvous"), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{world} gloo ranks did not finish within 120 s")
    assert proc.returncode == 0, log
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def gloo_block():
    sys.path.insert(0, str(TESTS))
    try:
        import _torch_sharded_worker as w
    finally:
        sys.path.remove(str(TESTS))
    return w.block(), w.M, w.SEED


@pytest.mark.parametrize("world", [2, 4])
def test_partitioned_build_in_gloo_ranks(world, tmp_path, gloo_block):
    """Every rank's priority build bit-equal to the JAX one-shot build and
    to the port's one-host ``partitioned_sketch_corpus``; threshold equal
    in idx with tau within rtol 1e-5 (``tests/test_merge.py``'s
    contract); an indivisible n raises the reference's error."""
    A, m, seed = gloo_block
    ranks = _spawn_ranks(world, tmp_path)
    jp = j_priority(jnp.asarray(A), m, seed)
    jt = j_threshold(jnp.asarray(A), m, seed)
    host = partitioned_sketch_corpus(A, m, seed, num_partitions=world,
                                     device="cpu")
    for r, out in enumerate(ranks):
        for f in ("idx", "val", "tau"):
            assert_bits(out[f"priority_{f}"], np.asarray(getattr(jp, f)))
            assert_bits(out[f"priority_{f}"], getattr(host, f))
        assert_bits(out["threshold_idx"], np.asarray(jt.idx))
        np.testing.assert_allclose(out["threshold_tau"], np.asarray(jt.tau),
                                   rtol=1e-5)
        assert str(out["indivisible"]) == \
            f"n={A.shape[1] - 1} must divide over {world} shards", r


def test_partitioned_build_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        partitioned_sketch_corpus_sharded(np.ones((2, 8), np.float32), 4, 1,
                                          device="cpu")
