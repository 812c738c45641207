"""Port parity of bound-pruned top-k discovery over one index:
``repro_torch.serve.DiscoveryEngine`` (on ``device="cpu"``, B5's plain
version) against ``repro.serve.DiscoveryEngine`` on the same corpora, at
the reference tests' sizes (m, B, S = 32, 64, 2; D = 32-64; n = 256).

The tile summaries and the four discovery bounds are bit-equal; the scan
statistics and the audit log equal (the threshold, an estimate, within
float32 summation tolerance); items equal in names and order, estimates
within ``RTOL``.  The port's scan is also held against its own
``all_pairs()`` plus the reference tests' tie-broken sort (each estimate
one of the matrix's cells bit for bit), and its query scan against a
one-row tile over every row plus the sort, bit for bit.  Each corpus is
sketched once a module in both packages."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import RTOL, assert_bits, atol_for
from _torch_common import release_jax_executables  # noqa: F401

import repro.core.variance as jv
import repro.obs as jobs
from repro.serve import DiscoveryEngine as JEngine
from repro.serve import SketchIndex as JIndex
from repro.serve.discovery import TileSummaries as JTileSummaries
from repro.serve.discovery import _pair_scan as j_pair_scan
from repro_torch import obs
import repro_torch.core as tc
import repro_torch.kernels as tk
from repro_torch.serve import (DiscoveryEngine, ScanStats, SketchIndex,
                               TileSummaries)
from repro_torch.serve.discovery import _pair_scan

M, B, S, N = 32, 64, 2, 256
STATE = ("_idx", "_val", "_tau", "_dropped", "_g", "_kn")


def _matrix(D, seed, zipf):
    """The reference tests' corpus: Zipf-scaled Gaussian rows, row 1 a
    noisy copy of row 0."""
    rng = np.random.default_rng(seed)
    scales = (np.arange(1, D + 1, dtype=np.float32) ** -zipf) * 5.0
    X = rng.standard_normal((D, N)).astype(np.float32) * scales[:, None]
    X[1] = 0.9 * X[0] + 0.1 * rng.standard_normal(N).astype(np.float32)
    return X


def _both(X, names=None):
    """The same rows through both packages' ``add_many``; the host blocks
    and row summaries bit-equal."""
    names = names or [f"c{i}" for i in range(X.shape[0])]
    j = JIndex(m=M, n_buckets=B, slots=S)
    t = SketchIndex(M, n_buckets=B, slots=S, device="cpu")
    j.add_many(names, X)
    t.add_many(names, X)
    _same_state(t, j)
    return j, t


def _same_state(t, j):
    assert t._names == j._names and t.capacity == j.capacity
    for name in STATE:
        assert_bits(getattr(t, name), getattr(j, name))


@pytest.fixture(scope="module")
def corpus():
    """(D, seed, zipf) -> (JAX index, port index, X), built once a
    module; tests that ingest build their own."""
    cache = {}

    def get(D=40, seed=0, zipf=1.0):
        if (D, seed, zipf) not in cache:
            X = _matrix(D, seed, zipf)
            cache[D, seed, zipf] = (*_both(X), X)
        return cache[D, seed, zipf]
    return get


CORPORA = {"flat": dict(D=40), "skewed": dict(D=64, zipf=1.5)}


def _true_pairs(idx, k, absolute=False):
    """``all_pairs()`` plus the reference tests' sort: descending score,
    ties by ascending (row, column)."""
    est = np.asarray(idx.all_pairs())
    iu, ju = np.triu_indices(est.shape[0], k=1)
    v = est[iu, ju]
    score = np.abs(v) if absolute else v
    order = np.lexsort((ju, iu, -score))[:k]
    names = idx._names
    return [(names[iu[o]], names[ju[o]], float(v[o])) for o in order]


def _assert_all_pairs_cells(got, t, k, absolute=False):
    """A pair scan's items against the port's ``all_pairs()`` plus the
    sort: names and order equal, and each estimate a cell of the matrix
    bit for bit, in one orientation or the other (a tile holds a pair in
    either; the plain version's cell (a, b) may differ from (b, a) in the
    last bit, where the card's join, summing by bucket and id, is
    symmetric)."""
    want = _true_pairs(t, k, absolute)
    assert [it[:2] for it in got] == [it[:2] for it in want]
    est = t.all_pairs()
    row = {nm: i for i, nm in enumerate(t._names)}
    for a, b, e in got:
        i, j = row[a], row[b]
        assert np.float32(e) in (est[i, j], est[j, i]), (a, b, e)


def _query_truth(t, q, k, absolute=False):
    """One-row tile of the query against every row of the port's index
    (the scan's estimator form), plus the sort."""
    sq = tc.priority_sketch(torch.as_tensor(q), M, t.seed)
    qb = tk.bucketize(sq, n_buckets=B, slots=S)
    qc = tk.BucketizedSketch(qb.idx[None], qb.val[None], qb.tau.reshape(1),
                             torch.zeros(1, dtype=torch.int32))
    c = t._corpus()
    D = len(t)
    est = tk.estimate_tile_rows(
        qc.idx, qc.val, tk.slot_inclusion_probs(qc), c.idx, c.val,
        tk.slot_inclusion_probs(c), [0], np.arange(D)).numpy()[0]
    score = np.abs(est) if absolute else est
    order = np.lexsort((np.arange(D), -score))[:k]
    return [(t._names[i], float(est[i])) for i in order]


def _same_items(got, want):
    """Names and order equal; estimates within ``RTOL``."""
    assert [it[:-1] for it in got] == [it[:-1] for it in want]
    g = np.array([it[-1] for it in got])
    w = np.array([it[-1] for it in want])
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol_for(w))


def _same_stats(got, want):
    """Every ``ScanStats`` field equal; the threshold (an estimate) within
    ``RTOL``."""
    for f in dataclasses.fields(ScanStats):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "threshold" and np.isfinite(w):
            assert g == pytest.approx(w, rel=RTOL, abs=atol_for(w)), f.name
        else:
            assert g == w, f.name


def _same_result(got, want):
    _same_items(got.items, want.items)
    _same_stats(got.stats, want.stats)
    assert got.audit == want.audit
    assert (got.degraded, got.coverage, got.lost_pairs, got.lost_shards) \
        == (False, 1.0, (), ())


# ---------------------------------------------------------------------------
# the four discovery bounds, bit-equal (float32)
# ---------------------------------------------------------------------------


def _masses(rng, shape):
    return (rng.random(shape) * 10.0 ** rng.uniform(-3, 3, shape)) \
        .astype(np.float32)


@pytest.mark.parametrize("P", [0, 1, 5, 32, 33, 100, 1100])
@pytest.mark.parametrize("method", ["priority", "threshold"])
def test_surviving_corpus_bound_bit_equal(P, method):
    """Partitions along the last axis, over and under XLA's 32-element
    reduce window, with and without leading axes."""
    rng = np.random.default_rng(P)
    for lead in ((), (7,), (3, 5)):
        args = [_masses(rng, lead + (P,)) for _ in range(4)]
        want = jv.surviving_corpus_bound(*args, 64, 0.07, method=method)
        got = tc.surviving_corpus_bound(*args, 64, 0.07, method=method)
        for g, w in zip(got, want):
            assert_bits(g, np.asarray(w))


@pytest.mark.parametrize("P", [0, 1, 7, 33, 1100])
def test_coverage_fraction_bit_equal(P):
    rng = np.random.default_rng(100 + P)
    for lead in ((), (9,)):
        surv, lost = _masses(rng, lead + (P,)), _masses(rng, lead + (P,))
        zero = np.zeros_like(surv)
        for s, lo in ((surv, lost), (zero, zero), (zero, lost)):
            assert_bits(tc.coverage_fraction(s, lo),
                        np.asarray(jv.coverage_fraction(s, lo)))


def test_pair_estimate_ceiling_bit_equal():
    """Broadcast tile maxima, and Python floats against an array (the
    query scan's form); the engine's numpy twin gives the same bits."""
    from repro_torch.serve.discovery import _pair_ceiling_np
    rng = np.random.default_rng(3)
    ga, na = _masses(rng, (16, 1)), _masses(rng, (16, 1))
    gb, nb = _masses(rng, (1, 12)), _masses(rng, (1, 12))
    for args in ((ga, na, gb, nb), (float(ga[2, 0]), float(na[2, 0]),
                                    gb[0], nb[0])):
        got = tc.pair_estimate_ceiling(*args)
        assert got.dtype == torch.float32
        assert_bits(got, np.asarray(jv.pair_estimate_ceiling(*args)))
        assert_bits(got, _pair_ceiling_np(*args))


@pytest.mark.parametrize("method", ["priority", "threshold"])
def test_chebyshev_estimate_ceiling_bit_equal(method):
    """A float32 array times a Python float stays float32 on both sides."""
    rng = np.random.default_rng(4)
    na, nb = _masses(rng, (16, 1)), _masses(rng, (1, 12))
    for m in (2, 32, 256):
        for delta in (0.01, 0.05, 0.3):
            for a, b in ((na, nb), (float(na[5, 0]), nb[0])):
                want = np.asarray(jv.chebyshev_estimate_ceiling(
                    a, b, m, delta, method=method))
                got = tc.chebyshev_estimate_ceiling(a, b, m, delta,
                                                    method=method)
                assert want.dtype == np.float32
                assert_bits(got, want)


# ---------------------------------------------------------------------------
# tile summaries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile", [4, 8, 16])
def test_tile_summaries_bit_equal(corpus, tile):
    """D = 37: a short tail tile.  Members, maxima, sizes and refresh
    counts equal; a refresh at the same epoch does nothing."""
    j, t, _ = corpus(D=37)
    js, ts = JTileSummaries(j, tile), TileSummaries(t, tile)
    js.refresh()
    ts.refresh()
    assert ts.n_tiles == js.n_tiles == -(-37 // tile)
    for u in range(ts.n_tiles):
        assert_bits(ts.tile_rows(u), js.tile_rows(u))
    assert_bits(ts.tile_g, js.tile_g)
    assert_bits(ts.tile_n, js.tile_n)
    assert (ts.nbytes(), ts.refreshes, ts.refresh_calls) == \
        (js.nbytes(), js.refreshes, js.refresh_calls)
    ts.refresh()
    assert ts.refresh_calls == 1


# ---------------------------------------------------------------------------
# pair and query scans against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("absolute", [False, True])
@pytest.mark.parametrize("ceiling", ["admissible", "chebyshev"])
@pytest.mark.parametrize("tile", [4, 8, 16, 64])
@pytest.mark.parametrize("which", sorted(CORPORA))
def test_top_pairs_matches_reference(corpus, which, tile, ceiling, absolute):
    """Tiles of 4-16 rows, and 64 (one tile, wider than the flat
    corpus's 40 rows: peak bytes reckon it at 64 as the reference's padded
    tile)."""
    j, t, _ = corpus(**CORPORA[which])
    k = 7
    got = DiscoveryEngine(t, tile=tile, ceiling=ceiling).top_pairs(
        k, absolute=absolute, audit=True)
    want = JEngine(j, tile=tile, ceiling=ceiling).top_pairs(
        k, absolute=absolute, audit=True)
    _same_result(got, want)
    s = got.stats
    assert s.tiles_launched + s.tiles_pruned == s.tiles_total
    assert s.kernel_launches == s.tiles_launched
    if ceiling == "admissible":
        # lossless: the port's own all_pairs() plus the sort
        _assert_all_pairs_cells(got.items, t, k, absolute)


def test_skewed_corpus_prunes():
    """The reference's heavy-tailed case: tiles pruned, fewer launches
    than tile pairs, top-5 equal to all_pairs() plus the sort."""
    _, t = _both(_matrix(64, 0, 1.5))
    res = DiscoveryEngine(t, tile=8).top_pairs(k=5)
    _assert_all_pairs_cells(res.items, t, 5)
    assert res.stats.tiles_pruned > 0
    assert res.stats.kernel_launches < res.stats.tiles_total


@pytest.mark.parametrize("absolute", [False, True])
@pytest.mark.parametrize("ceiling", ["admissible", "chebyshev"])
@pytest.mark.parametrize("tile", [4, 16, 64])
@pytest.mark.parametrize("which", sorted(CORPORA))
def test_top_k_for_query_matches_reference(corpus, which, tile, ceiling,
                                           absolute):
    j, t, X = corpus(**CORPORA[which])
    q = 0.5 * X[0] - 0.3 * X[5]
    k = 7
    got = DiscoveryEngine(t, tile=tile, ceiling=ceiling).top_k_for_query(
        q, k, absolute=absolute)
    want = JEngine(j, tile=tile, ceiling=ceiling).top_k_for_query(
        q, k, absolute=absolute)
    _same_result(got, want)
    if ceiling == "admissible":
        assert got.items == _query_truth(t, q, k, absolute)


def _same_ranking(got, want):
    """Estimates within ``RTOL`` position by position; names equal, except
    for a swap between estimates within that tolerance of each other."""
    g = np.array([e for _, e in got])
    w = np.array([e for _, e in want])
    tol = RTOL * np.abs(w) + atol_for(w)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol_for(w))
    by_name = dict(got)
    for i, (name, est) in enumerate(want):
        if got[i][0] != name:
            assert name in by_name and abs(by_name[name] - est) <= tol[i]


@pytest.mark.parametrize("which", sorted(CORPORA))
def test_top_k_for_query_matches_index_query(corpus, which):
    """The scan (B5's reciprocal-max form) against ``query(top_k=...)``
    (B4's divide form) on the port and against the reference's scan."""
    j, t, X = corpus(**CORPORA[which])
    q = 0.5 * X[0] + 0.1 * X[5]
    got = t.top_k_for_query(q, k=7)
    _same_ranking(got.items, t.query(q, top_k=7))
    _same_items(got.items, j.top_k_for_query(q, k=7).items)


def test_index_keeps_one_engine(corpus):
    """``SketchIndex.top_pairs`` / ``top_k_for_query`` share one lazy
    engine; a second scan at the same epoch refreshes nothing."""
    _, t, X = corpus()
    first = t.top_pairs(k=3)
    eng = t._discovery
    assert isinstance(eng, DiscoveryEngine) and eng.tile == 64
    calls = eng._summaries.refresh_calls
    t.top_k_for_query(X[2], k=3)
    second = t.top_pairs(k=3)
    assert t._discovery is eng and eng._summaries.refresh_calls == calls
    assert second.items == first.items


def test_two_index_scan_matches_reference():
    """The scan of one index's rows against another's (every pair, no
    symmetry) equals the reference's."""
    X = _matrix(48, 5, 1.0)
    ja, ta = _both(X[:24], [f"a{i}" for i in range(24)])
    jb, tb = _both(X[24:], [f"b{i}" for i in range(24)])
    for absolute in (False, True):
        got = _pair_scan(DiscoveryEngine(ta, tile=8),
                         DiscoveryEngine(tb, tile=8), 6, absolute=absolute,
                         audit=True)
        want = j_pair_scan(JEngine(ja, tile=8), JEngine(jb, tile=8), 6,
                           absolute=absolute, audit=True)
        _same_result(got, want)


# ---------------------------------------------------------------------------
# lossless pruning: no pruned tile held a true top-k pair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,zipf,tile,k", [(0, 0.5, 8, 5), (1, 1.0, 8, 10),
                                              (2, 1.5, 16, 3),
                                              (3, 2.0, 4, 7)])
def test_no_pruned_tile_held_a_true_topk_pair_seeded(corpus, seed, zipf,
                                                     tile, k):
    """The reference's seeded sweep, with the audit log equal to the
    reference's."""
    j, t, _ = corpus(D=48, seed=seed, zipf=zipf)
    eng = DiscoveryEngine(t, tile=tile)
    res = eng.top_pairs(k=k, audit=True)
    assert res.audit == JEngine(j, tile=tile).top_pairs(
        k=k, audit=True).audit
    name_id = {nm: i for i, nm in enumerate(t._names)}
    tile_of = {int(rid): u for u in range(eng._summaries.n_tiles)
               for rid in eng.tile_members(u)}
    launched = {(a["u"], a["v"]) for a in res.audit if a["launched"]}
    for a, b, _ in _true_pairs(t, k):
        u, v = sorted((tile_of[name_id[a]], tile_of[name_id[b]]))
        assert (u, v) in launched, \
            f"true top-{k} pair ({a}, {b}) lived in pruned tile ({u}, {v})"


# ---------------------------------------------------------------------------
# ingest after a scan: dirty tiles, results still exact
# ---------------------------------------------------------------------------


def _scan_both(je, te, k, **kw):
    got, want = te.top_pairs(k, **kw), je.top_pairs(k, **kw)
    _same_result(got, want)
    _assert_all_pairs_cells(got.items, te.index, k,
                            kw.get("absolute", False))
    return got


def test_results_correct_after_add():
    """High-norm ``add``s displace the top pairs; an anti-correlated one
    leads the absolute scan.  One engine a side across the ingests."""
    j, t = _both(_matrix(32, 0, 1.0))
    je, te = JEngine(j, tile=8), DiscoveryEngine(t, tile=8)
    _scan_both(je, te, 5)
    v = np.random.default_rng(9).standard_normal(N).astype(np.float32) * 20
    for name, vec in (("hot", v), ("hot2", 0.85 * v), ("neg", -0.9 * v)):
        j.add(name, vec)
        t.add(name, vec)
    _same_state(t, j)
    res = _scan_both(je, te, 5)
    assert ("hot", "hot2") in [(a, b) for a, b, _ in res.items]
    res = _scan_both(je, te, 5, absolute=True)
    assert any("neg" in (a, b) for a, b, _ in res.items)


def test_results_correct_after_add_many():
    j, t = _both(_matrix(32, 1, 1.0))
    je, te = JEngine(j, tile=8), DiscoveryEngine(t, tile=8)
    _scan_both(je, te, 6)
    extra = _matrix(12, 7, 0.3)
    names = [f"x{i}" for i in range(12)]
    j.add_many(names, extra)
    t.add_many(names, extra)
    _same_state(t, j)
    res = _scan_both(je, te, 6)
    assert res.stats.summary_tiles_refreshed > 0


def test_results_correct_after_merge_from():
    """Two indexes over the two halves of the coordinates; one merges the
    other in after a scan, and the next scan sees the merged corpus."""
    X = _matrix(40, 2, 1.0)
    lo, hi = X.copy(), X.copy()
    lo[:, N // 2:] = 0.0
    hi[:, :N // 2] = 0.0
    (j, t), (jh, th) = _both(lo), _both(hi)
    je, te = JEngine(j, tile=8), DiscoveryEngine(t, tile=8)
    _scan_both(je, te, 5)
    j.merge_from(jh)
    t.merge_from(th)
    _same_state(t, j)
    _scan_both(je, te, 5)
    q = X[0] + X[3]
    _same_result(te.top_k_for_query(q, 5), je.top_k_for_query(q, 5))


def test_low_norm_append_dirties_only_tail_tiles():
    j, t = _both(_matrix(32, 0, 1.0))
    je, te = JEngine(j, tile=8), DiscoveryEngine(t, tile=8)
    _scan_both(je, te, 3)
    before, n_tiles = te._summaries.refreshes, te._summaries.n_tiles
    tiny = np.full((2, N), 1e-4, np.float32)
    j.add_many(["tiny0", "tiny1"], tiny)
    t.add_many(["tiny0", "tiny1"], tiny)
    _scan_both(je, te, 3)
    dirtied = te._summaries.refreshes - before
    assert 0 < dirtied < n_tiles
    assert te._summaries.refreshes == je._summaries.refreshes


# ---------------------------------------------------------------------------
# errors and metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["empty index", "empty index query",
                                  "k must be", "k must be query",
                                  "'admissible' or 'chebyshev'",
                                  "power of two"])
def test_discovery_errors_match_reference(case):
    X = _matrix(8, 0, 1.0)
    empty = case.startswith("empty")
    j = JIndex(m=M, n_buckets=B, slots=S)
    t = SketchIndex(M, n_buckets=B, slots=S, device="cpu")
    if not empty:
        j.add_many([f"c{i}" for i in range(8)], X)
        t.add_many([f"c{i}" for i in range(8)], X)
    q = np.ones(N, np.float32)
    calls = {
        "empty index": lambda ix, eng, ts: ix.top_pairs(),
        "empty index query": lambda ix, eng, ts: ix.top_k_for_query(q),
        "k must be": lambda ix, eng, ts: ix.top_pairs(k=0),
        "k must be query": lambda ix, eng, ts: ix.top_k_for_query(q, k=0),
        "'admissible' or 'chebyshev'":
            lambda ix, eng, ts: eng(ix, ceiling="exact"),
        "power of two": lambda ix, eng, ts: ts(ix, tile=12),
    }
    match = case.replace(" query", "")
    for ix, eng, ts in ((j, JEngine, JTileSummaries),
                        (t, DiscoveryEngine, TileSummaries)):
        with pytest.raises(ValueError, match=match):
            calls[case](ix, eng, ts)


DISCOVERY_METRICS = ("repro_discovery_scans_total",
                     "repro_discovery_tiles_total",
                     "repro_discovery_tiles_launched_total",
                     "repro_discovery_tiles_pruned_total",
                     "repro_discovery_kernel_launches_total",
                     "repro_discovery_peak_bytes",
                     "repro_discovery_summary_tiles_refreshed")


def test_discovery_metrics_match_reference(corpus):
    """Two pair scans and a query scan on each side with both registries
    enabled: the seven ``repro_discovery_*`` metrics equal, label by
    label; nothing is recorded while disabled."""
    j, t, X = corpus(D=64, zipf=1.5)
    jobs.reset()
    obs.reset()
    jobs.enable()
    obs.enable()
    try:
        for eng in (JEngine(j, tile=8), DiscoveryEngine(t, tile=8)):
            eng.top_pairs(k=5)
            eng.top_pairs(k=3, absolute=True)
            eng.top_k_for_query(X[4], k=4)
        got = obs.registry().value
        for scan in ("pairs", "query"):
            for name in DISCOVERY_METRICS:
                want = jobs.registry().value(name, scan)
                assert want > 0 or name.endswith("pruned_total"), name
                assert got(name, scan) == want, (name, scan)
        assert got("repro_op_total", "serve.discovery.top_pairs") == 2
    finally:
        jobs.disable()
        obs.disable()
        jobs.reset()
        obs.reset()
    DiscoveryEngine(t, tile=8).top_pairs(k=5)
    assert obs.snapshot() == {}
