"""The discovery scans in batches of tile pairs, against the reference.

``repro_torch.serve.discovery`` walks its visit order in batches (one
``kernels.scan_tile_batch`` a batch: on the card one launch of the
tile-list join and one copy), a first batch of ``_FIRST_BATCH`` pairs
doubling up to the pairs of ``_MAX_BATCH`` join tiles, with the stop
test between the tiles.  What a scan visits must not depend on the
batches: under each schedule (a first batch of 1 and of 3, a cap of 8
join tiles, and every pair at once) the items, every ``ScanStats`` field
and the audit equal ``repro.serve``'s, for tiles of 8, 64 and 128 rows,
both scans, one index against itself and against another, and the
sharded fan-out.  The tiles a schedule computes stay within its bound,
and at tiles up to 1024 rows a batch holds at most ``_MAX_BATCH`` join
tiles.  The corpus's scan layout is built once an index
change, and rebuilt after ``add``, ``add_many`` and ``merge_from``.

The compacted layout the card runs (a row list into ``allpairs_compact``,
then the tile-list join) is checked here through its plain versions: the
compaction through a row list bit-equal to the compaction of the gathered
rows, the tile-list join bit-equal to ``allpairs_join_ref`` a pair, and
the scan's tiles from that layout (the join tiles a batch spans, joined
by ``allpairs_join_tiles_ref`` and cut) within ``RTOL`` of the gathered
route's (the plain versions sum in different orders)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import RTOL, assert_bits, atol_for

from repro.serve import DiscoveryEngine as JEngine
from repro.serve import ShardedDiscoveryEngine as JSharded
from repro.serve import ShardedSketchIndex as JShardedIndex
from repro.serve import SketchIndex as JIndex
from repro.serve.discovery import _pair_scan as j_pair_scan
import repro_torch.kernels as tk
from repro_torch.kernels.intersect_estimate import (allpairs_compact_ref,
                                                    allpairs_join_ref,
                                                    allpairs_join_tiles_ref)
from repro_torch.kernels.intersect_estimate.ops import (_cut_tiles,
                                                        _join_pairs,
                                                        scan_row_list)
from repro_torch.serve import (DiscoveryEngine, ScanStats,
                               ShardedDiscoveryEngine, ShardedSketchIndex,
                               SketchIndex)
import repro_torch.serve.discovery as disc

M, B, S, N = 32, 64, 2, 256
K = 6
# (first batch, largest batch in join tiles): 1 and 3 doubling to the
# default cap, a cap of 8 join tiles (2 pairs of 128-row tiles a batch),
# and every tile pair in one batch
SCHEDULES = {"first_1": (1, disc._MAX_BATCH), "first_3": (3, disc._MAX_BATCH),
             "cap_8": (3, 8), "all_at_once": (1 << 30, 1 << 30)}


def _matrix(D, seed, zipf):
    """Zipf-scaled Gaussian rows (the reference tests' corpus), row 1 a
    noisy copy of row 0."""
    rng = np.random.default_rng(seed)
    scales = (np.arange(1, D + 1, dtype=np.float32) ** -zipf) * 5.0
    X = rng.standard_normal((D, N)).astype(np.float32) * scales[:, None]
    X[1] = 0.9 * X[0] + 0.1 * rng.standard_normal(N).astype(np.float32)
    return X


def _both(X, prefix="c"):
    names = [f"{prefix}{i}" for i in range(X.shape[0])]
    j = JIndex(m=M, n_buckets=B, slots=S)
    t = SketchIndex(M, n_buckets=B, slots=S, device="cpu")
    j.add_many(names, X)
    t.add_many(names, X)
    return j, t


@pytest.fixture(scope="module")
def corpora():
    """Built once a module: a skewed corpus of 160 rows (5 tiles of 32, 3
    of 64, 2 of 128: a short last tile at each) and a second index of 72
    rows for the two-index scans."""
    X = _matrix(160, 3, 1.2)
    Y = _matrix(72, 4, 0.8)
    return dict(main=(*_both(X), X), other=_both(Y, "d"))


@pytest.fixture
def schedule(monkeypatch, request):
    """Set the scans' batch schedule and count the batches and the tiles
    they compute (``scan_tile_batch`` calls)."""
    first, cap = SCHEDULES[request.param]
    monkeypatch.setattr(disc, "_FIRST_BATCH", first)
    monkeypatch.setattr(disc, "_MAX_BATCH", cap)
    calls = []
    real = disc.scan_tile_batch

    def counting(a, b, pairs, **kw):
        calls.append(len(pairs))
        return real(a, b, pairs, **kw)

    monkeypatch.setattr(disc, "scan_tile_batch", counting)
    return first, cap, calls


def _same_result(got, want):
    """Items (names equal, estimates within ``RTOL``), every ``ScanStats``
    field (the threshold within ``RTOL``) and the audit equal."""
    assert [it[:-1] for it in got.items] == [it[:-1] for it in want.items]
    g = np.array([it[-1] for it in got.items])
    w = np.array([it[-1] for it in want.items])
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol_for(w))
    for f in dataclasses.fields(ScanStats):
        gv, wv = getattr(got.stats, f.name), getattr(want.stats, f.name)
        if f.name == "threshold" and np.isfinite(wv):
            assert gv == pytest.approx(wv, rel=RTOL, abs=atol_for(wv))
        else:
            assert gv == wv, f.name
    assert got.audit == want.audit


def _batches_within_bound(calls, visited, total, first, cap, kk=1):
    """The batches of one scan: doubling from ``first`` up to the pairs
    of ``cap`` join tiles (``kk`` a pair; a batch may end early at the
    k-th score), covering every visited pair, computing at most 2
    visited + first - 2 tiles (and no more than the pairs)."""
    cap = max(1, cap // kk)
    first = min(first, cap)
    assert sum(calls) >= visited > 0
    assert sum(calls) <= min(total, max(first, 2 * visited + first - 2))
    size = first
    for n in calls:
        assert 1 <= n <= size
        size = min(2 * size, cap)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES), indirect=True)
@pytest.mark.parametrize("tile", [8, 64, 128])
@pytest.mark.parametrize("absolute", [False, True])
def test_pair_scan_schedule_changes_nothing(corpora, schedule, tile,
                                            absolute):
    first, cap, calls = schedule
    j, t, _ = corpora["main"]
    got = DiscoveryEngine(t, tile=tile).top_pairs(K, absolute=absolute,
                                                  audit=True)
    want = JEngine(j, tile=tile).top_pairs(K, absolute=absolute, audit=True)
    _same_result(got, want)
    _batches_within_bound(calls, got.stats.tiles_launched,
                          got.stats.tiles_total, first, cap,
                          max(tile // 64, 1) ** 2)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES), indirect=True)
@pytest.mark.parametrize("tile", [8, 64, 128])
def test_two_index_scan_schedule_changes_nothing(corpora, schedule, tile):
    first, cap, calls = schedule
    (j, t, _), (jb, tb) = corpora["main"], corpora["other"]
    got = disc._pair_scan(DiscoveryEngine(t, tile=tile),
                          DiscoveryEngine(tb, tile=tile), K, audit=True)
    want = j_pair_scan(JEngine(j, tile=tile), JEngine(jb, tile=tile), K,
                       audit=True)
    _same_result(got, want)
    _batches_within_bound(calls, got.stats.tiles_launched,
                          got.stats.tiles_total, first, cap,
                          max(tile // 64, 1) ** 2)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES), indirect=True)
@pytest.mark.parametrize("tile", [8, 64, 128])
@pytest.mark.parametrize("absolute", [False, True])
def test_query_scan_schedule_changes_nothing(corpora, schedule, tile,
                                             absolute):
    first, cap, calls = schedule
    j, t, X = corpora["main"]
    q = 0.6 * X[2] - 0.4 * X[7]
    got = DiscoveryEngine(t, tile=tile).top_k_for_query(q, K,
                                                        absolute=absolute)
    want = JEngine(j, tile=tile).top_k_for_query(q, K, absolute=absolute)
    _same_result(got, want)
    _batches_within_bound(calls, got.stats.tiles_launched,
                          got.stats.tiles_total, first, cap,
                          max(tile // 64, 1))


@pytest.mark.parametrize("schedule", sorted(SCHEDULES), indirect=True)
def test_sharded_scans_schedule_changes_nothing(schedule):
    """The fan-out's shard-pair tasks (symmetric and two-index) and query
    tasks under each schedule: the reference's answers and statistics."""
    X = _matrix(96, 5, 1.2)
    names = [f"c{i}" for i in range(96)]
    j = JShardedIndex(num_shards=3, m=M, n_buckets=B, slots=S)
    t = ShardedSketchIndex(num_shards=3, m=M, n_buckets=B, slots=S,
                           device="cpu")
    j.add_many(names, X)
    t.add_many(names, X)
    je = JSharded(j, tile=8, sleep=lambda s: None)
    te = ShardedDiscoveryEngine(t, tile=8, sleep=lambda s: None)
    for got, want in ((te.top_pairs(K), je.top_pairs(K)),
                      (te.top_k_for_query(X[4], K),
                       je.top_k_for_query(X[4], K))):
        assert [it[:-1] for it in got.items] == \
            [it[:-1] for it in want.items]
        np.testing.assert_allclose([it[-1] for it in got.items],
                                   [it[-1] for it in want.items], rtol=RTOL,
                                   atol=atol_for([it[-1] for it in
                                                  want.items]))
        for f in dataclasses.fields(ScanStats):
            assert getattr(got.stats, f.name) == \
                getattr(want.stats, f.name), f.name


@pytest.mark.parametrize("tile", [8, 64, 256, 1024])
@pytest.mark.parametrize("query", [False, True])
def test_batches_capped_in_join_tiles(monkeypatch, tile, query):
    """Large tiles: a batch holds at most the pairs of ``_MAX_BATCH``
    join tiles (a pair of T-row tiles is (T / 64)^2 of them; a query's
    pair T / 64), and at least one pair; the first batch is
    ``_FIRST_BATCH`` pairs or that cap, each later one twice the last up
    to it.  No tile is pruned here (an empty heap), so the batches cover
    every pair."""
    calls = []

    def fake_batch(a, b, pairs):
        calls.append(len(pairs))
        return [np.zeros((a.tile, b.tile), np.float32)] * len(pairs)

    monkeypatch.setattr(disc, "scan_tile_batch", fake_batch)
    a = tk.ScanTiles(1 if query else tile, np.ones(1 if query else 40))
    b = tk.ScanTiles(tile, np.ones(40))
    n = 300
    uu = np.zeros(n, np.int64) if query else np.arange(n) % 40
    vv = np.arange(n) % 40
    got = list(disc._tile_stream(a, b, uu, vv, np.ones(n, np.float32), [],
                                 K))
    assert len(got) == n and sum(calls) == n
    kk = max(tile // 64, 1) ** (1 if query else 2)
    cap = max(1, disc._MAX_BATCH // kk)
    assert cap == disc._batch_cap(a, b)
    assert max(calls) * kk <= max(disc._MAX_BATCH, kk)
    size = min(disc._FIRST_BATCH, cap)
    for c in calls[:-1]:
        assert c == size
        size = min(2 * size, cap)
    assert 1 <= calls[-1] <= size


# ---------------------------------------------------------------------------
# the scan layout: built once an index change
# ---------------------------------------------------------------------------


def _ingest(kind, j, t, X):
    if kind == "add":
        v = np.random.default_rng(9).standard_normal(N).astype(np.float32)
        for name, vec in (("hot", 20 * v), ("hot2", 17 * v)):
            j.add(name, vec)
            t.add(name, vec)
    elif kind == "add_many":
        extra = _matrix(12, 7, 0.3)
        names = [f"x{i}" for i in range(12)]
        j.add_many(names, extra)
        t.add_many(names, extra)
    else:
        other = X[:40].copy()
        other[:, :N // 2] = 0.0
        jh, th = _both(other)
        j.merge_from(jh)
        t.merge_from(th)


@pytest.mark.parametrize("kind", ["add", "add_many", "merge_from"])
def test_scan_layout_rebuilt_after_ingest(kind):
    """A scan caches its layout; a second scan at the same epoch reuses
    it; after the ingest the next scan rebuilds it (one layout an epoch)
    and both scans still equal the reference's."""
    X = _matrix(40, 2, 1.0)
    if kind == "merge_from":
        X[:, N // 2:] = 0.0
    j, t = _both(X)
    je, te = JEngine(j, tile=8), DiscoveryEngine(t, tile=8)
    q = X[0] + X[3]
    _same_result(te.top_pairs(K, audit=True), je.top_pairs(K, audit=True))
    layout = te._scan
    _same_result(te.top_k_for_query(q, K), je.top_k_for_query(q, K))
    assert te._scan is layout
    _ingest(kind, j, t, X)
    _same_result(te.top_pairs(K, audit=True), je.top_pairs(K, audit=True))
    assert te._scan is not layout
    assert te._dev_epoch == t.summary_epoch
    assert tk.ScanTiles is type(te._scan)
    assert sum(te._scan.sizes) == len(t)
    _same_result(te.top_k_for_query(q, K), je.top_k_for_query(q, K))


# ---------------------------------------------------------------------------
# the compacted layout the card runs, through the plain versions
# ---------------------------------------------------------------------------


def _layout(ix, tile):
    """(idx, val, p) of an index's corpus and its scan tiles' rows."""
    eng = DiscoveryEngine(ix, tile=tile)
    eng._prepare()
    s = eng._summaries
    return ((eng._dev.idx, eng._dev.val, eng._probs),
            [s.tile_rows(u) for u in range(s.n_tiles)])


@pytest.mark.parametrize("tile", [1, 8, 64, 128])
def test_compaction_with_row_list_equals_gathered(corpora, tile):
    """The plain compaction through a row list (scan order, -1 padding)
    bit-equal to the compaction of the gathered rows, empty rows as the
    corpus's padding."""
    _, t, _ = corpora["main"]
    arrs, rows = _layout(t, tile)
    flat = scan_row_list(rows, tile)
    assert flat.size % 64 == 0 and (flat >= 0).sum() == len(t)
    got = allpairs_compact_ref(*arrs, rows=torch.as_tensor(flat))
    take = torch.as_tensor(np.where(flat >= 0, flat, 0))
    live = torch.as_tensor(flat >= 0)[:, None, None]
    idx, val, p = (x[take] for x in arrs)
    want = allpairs_compact_ref(
        torch.where(live, idx, torch.full_like(idx, 0x7FFFFFFF)),
        torch.where(live, val, torch.zeros_like(val)),
        torch.where(live, p, torch.ones_like(p)))
    for g, w in zip(got, want):
        assert_bits(g, w)


def test_join_tiles_ref_equals_per_pair_join(corpora):
    """The plain tile-list join: each listed pair bit-equal to
    ``allpairs_join_ref`` on the two compacted tiles, repeats and
    out-of-range pairs (zeros) included."""
    (_, ta, _), (_, tb) = corpora["main"], corpora["other"]
    a = allpairs_compact_ref(*_layout(ta, 64)[0])
    b = allpairs_compact_ref(*_layout(tb, 64)[0])
    pairs = torch.tensor([[0, 0], [2, 1], [1, 0], [2, 1], [3, 0], [0, -1]],
                         dtype=torch.int32)
    got = allpairs_join_tiles_ref(*a, *b, pairs)
    assert got.shape == (6, 64, 64)
    for n, (u, v) in enumerate(pairs.tolist()):
        if not (0 <= u < a[0].shape[0] and 0 <= v < b[0].shape[0]):
            assert_bits(got[n], torch.zeros(64, 64))
            continue
        assert_bits(got[n], allpairs_join_ref(
            a[0][u:u + 1], a[1][u:u + 1], b[0][v:v + 1], b[1][v:v + 1], 64,
            64))
    # the wrapper takes the plain version on CPU tensors
    assert_bits(tk.allpairs_join_tiles(*a, *b, pairs), got)


@pytest.mark.parametrize("tile", [8, 64, 128])
@pytest.mark.parametrize("sides", ["symmetric", "two_index", "query"])
def test_compacted_layout_tiles_match_gathered(corpora, tile, sides):
    """The card's route of ``scan_tile_batch`` through the plain versions:
    the compaction through a row list, the join tiles a batch of every
    tile pair spans (``_join_pairs``), ``allpairs_join_tiles_ref`` on
    them and the scan tiles cut out (``_cut_tiles``): every tile has the
    gathered route's shape and values within ``RTOL`` (zeros where it
    has zeros)."""
    (_, t, _), (_, tb) = corpora["main"], corpora["other"]
    arrs, rows = _layout(t, tile)
    if sides == "query":
        a_arrs, a_rows, a_tile = tuple(x[5:6] for x in arrs), \
            [np.zeros(1, np.int64)], 1
    else:
        a_arrs, a_rows, a_tile = arrs, rows, tile
    b_arrs, b_rows = (_layout(tb, tile) if sides == "two_index"
                      else (arrs, rows))
    gathered_a = tk.scan_tiles(*a_arrs, a_rows, a_tile)
    gathered_b = tk.scan_tiles(*b_arrs, b_rows, tile)
    compact_a = tk.ScanTiles(a_tile, gathered_a.sizes, *allpairs_compact_ref(
        *a_arrs, rows=torch.as_tensor(scan_row_list(a_rows, a_tile))))
    compact_b = tk.ScanTiles(tile, gathered_b.sizes, *allpairs_compact_ref(
        *b_arrs, rows=torch.as_tensor(scan_row_list(b_rows, tile))))
    uu, vv = np.indices((len(a_rows), len(b_rows))).reshape(2, -1)
    pairs = np.stack([uu, vv], 1)[::-1]     # any order, in one batch
    jt = _join_pairs(compact_a, compact_b, pairs)
    kk = compact_a.join_tiles * compact_b.join_tiles
    assert jt.shape == (len(pairs) * kk, 2)
    host = allpairs_join_tiles_ref(compact_a.entries, compact_a.counts,
                                   compact_b.entries, compact_b.counts,
                                   torch.as_tensor(jt)).numpy()
    got = _cut_tiles(host, compact_a, compact_b, pairs)
    want = tk.scan_tile_batch(gathered_a, gathered_b, pairs)
    assert len(got) == len(want) == len(pairs)
    for g, w, (u, v) in zip(got, want, pairs):
        assert g.shape == w.shape == (a_rows[u].size, b_rows[v].size)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol_for(w))
        assert np.array_equal(g == 0, w == 0)
