"""Streaming top-k discovery: bound-pruned tile scans on the all-pairs
kernel, over one index or a sharded one (DESIGN.md §17 of the reference).

``all_pairs`` gives the whole (D, D) matrix: quadratic in the corpus and
out of reach at the column counts discovery runs at (the most-correlated
column pairs across unjoined tables).  The engine prunes, scans and
streams instead:

1. **Summaries.**  Every indexed row carries its rescaled kept norm ``G``
   and plain kept norm ``N``, kept up to date at ingest
   (``SketchIndex._refresh_row_stats``).  Every estimate of a pair obeys
   ``|est| <= min(G_a G_b, G_a N_b + N_a G_b)``
   (:func:`repro_torch.core.variance.pair_estimate_ceiling`), so a tile's
   maxima of (G, N) bound whatever a launch on it can return.
2. **Bound-ordered scan.**  Rows are tiled in descending ``G``
   (:class:`TileSummaries`), tile pairs are visited in descending ceiling
   order, and once a streaming top-k heap is full and the next ceiling is
   below its k-th score, no later tile can hold a top-k pair: the scan
   stops.  The corpus is laid out for the scans once per index change
   (``kernels.scan_tiles``: on the card one compaction launch, rows in
   scan-tile order), and the visit order is walked in batches of tile
   pairs, each batch one launch of the all-pairs join on the listed
   tiles and one copy to the host (``kernels.scan_tile_batch``): a
   first batch of ``_FIRST_BATCH`` pairs, each later one twice as many
   up to ``_MAX_BATCH`` join tiles of 64 x 64, each cut before the first pair whose ceiling is
   already below the full heap's k-th score.  The host then takes the
   tiles strictly in scan order with the stop test pair by pair, so what
   a scan visits (its answer, statistics and audit) does not depend on
   the batches; tiles computed past the stop are dropped unread.  Only
   (tq, tc) tiles come to the host; the working set is O(D m), never
   O(D^2).
3. **Sharded fan-out.**  :class:`ShardedDiscoveryEngine` scans the shard
   pairs of a :class:`~repro_torch.serve.sketch_service.ShardedSketchIndex`
   concurrently (worker threads launching on the card's current stream),
   each task keeping its own top-k heap, merged at the coordinator.  Each
   task runs under :class:`~repro_torch.serve.resilience.RetryPolicy`
   semantics (retry, backoff, deadline, ``TimeoutError`` terminal), so a
   slow or dead shard degrades the answer, with its ``coverage``
   quantified, instead of stalling it (DESIGN.md §16 of the reference).
4. **Dirty-tile invalidation.**  Ingest refreshes the summaries of the
   rows it touched; :class:`TileSummaries` recomputes the maxima of only
   the tiles whose members or member stats changed.

The summaries, ceilings, scan order and heap are host numpy, as in the
reference, so the scan order and every pruning decision are its own; the
corpus and its slot probabilities stay on the index's device.
"""
from __future__ import annotations

import heapq
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import priority_sketch
from repro_torch.core.variance import chebyshev_estimate_ceiling
from repro_torch.kernels import (BucketizedSketch, ScanTiles, bucketize,
                                 round_up_pow2, scan_tile_batch, scan_tiles,
                                 slot_inclusion_probs)

from .resilience import RetryPolicy, ShardDownError, ShardHealth
from .sketch_service import _host, _row_summaries
from .validation import check_vector

DEFAULT_TILE = 64
# tile pairs of a scan's first batch, and the most join tiles (64 x 64)
# a batch takes (each batch doubles the last): a few pairs first, since a
# pruned scan visits few; then batches that fill the card.  A tile pair
# of T > 64 rows a side is (T / 64)^2 join tiles, so a batch holds at
# most max(1, _MAX_BATCH / (T / 64)^2) pairs (its device tiles and pinned
# copy at most _MAX_BATCH x 16 KiB, whatever the tile)
_FIRST_BATCH = 4
_MAX_BATCH = 512


def _pair_ceiling_np(ga, na, gb, nb):
    """Numpy twin of :func:`repro_torch.core.variance.pair_estimate_ceiling`
    (broadcasting outer products for the tile-pair ceiling matrix)."""
    return np.minimum(ga * gb, ga * nb + na * gb)


class TileSummaries:
    """Bound-ordered tile view of one index's (G, N) row summaries.

    Rows are ranked by descending ``G`` and cut into tiles of ``tile`` rows;
    each tile carries its (max G, max N), all a scan needs to bound every
    estimate the tile can produce.  ``refresh`` does nothing while the
    index's ``summary_epoch`` is unchanged, and otherwise recomputes the
    maxima of only the tiles whose member set or member stats differ from
    the cached snapshot: an append of low-``G`` rows dirties only the
    trailing tiles.
    """

    def __init__(self, index, tile: int = DEFAULT_TILE):
        if tile < 1 or round_up_pow2(tile) != tile:
            raise ValueError(f"tile must be a positive power of two, "
                             f"got {tile}")
        self.index = index
        self.tile = tile
        self._epoch = -1
        self._tile_rows: list = []     # per tile: np array of original row ids
        self._g_snap: Optional[np.ndarray] = None
        self._n_snap: Optional[np.ndarray] = None
        self.tile_g = np.empty((0,), np.float32)
        self.tile_n = np.empty((0,), np.float32)
        self.refreshes = 0             # cumulative tiles recomputed
        self.refresh_calls = 0         # refreshes that did any work

    @property
    def n_tiles(self) -> int:
        return len(self._tile_rows)

    def tile_rows(self, t: int) -> np.ndarray:
        """Original row ids of tile ``t`` (descending-G order)."""
        return self._tile_rows[t]

    def nbytes(self) -> int:
        snap = 0 if self._g_snap is None else \
            self._g_snap.nbytes + self._n_snap.nbytes
        return snap + self.tile_g.nbytes + self.tile_n.nbytes + \
            sum(r.nbytes for r in self._tile_rows)

    def refresh(self) -> None:
        if self.index.summary_epoch == self._epoch:
            return
        g_view, n_view = self.index.row_summaries()
        g = np.array(g_view, np.float32)   # snapshot: views mutate on ingest
        n = np.array(n_view, np.float32)
        D, T = g.shape[0], self.tile
        # stable: equal-G rows keep insertion order, so appends that do not
        # outrank existing rows leave the leading tiles' members alone
        order = np.argsort(-g, kind="stable").astype(np.int64)
        nt = -(-D // T)
        rows = [order[t * T:(t + 1) * T] for t in range(nt)]
        tile_g = np.zeros((nt,), np.float32)
        tile_n = np.zeros((nt,), np.float32)
        d_old = 0 if self._g_snap is None else self._g_snap.shape[0]
        for t in range(nt):
            r = rows[t]
            clean = (t < len(self._tile_rows)
                     and r.shape == self._tile_rows[t].shape
                     and np.array_equal(r, self._tile_rows[t])
                     and (r.size == 0 or r.max() < d_old)
                     and np.array_equal(g[r], self._g_snap[r])
                     and np.array_equal(n[r], self._n_snap[r]))
            if clean:
                tile_g[t] = self.tile_g[t]
                tile_n[t] = self.tile_n[t]
            else:
                if r.size:
                    tile_g[t] = g[r].max()
                    tile_n[t] = n[r].max()
                self.refreshes += 1
        self._tile_rows = rows
        self.tile_g, self.tile_n = tile_g, tile_n
        self._g_snap, self._n_snap = g, n
        self._epoch = self.index.summary_epoch
        self.refresh_calls += 1


@dataclass
class ScanStats:
    """Accounting of one pruned scan: the tile launches the bound saved,
    and the peak working-set bytes the scan held (corpus blocks,
    summaries, ceiling table, one tile buffer, heap; never the (D1, D2)
    estimate matrix)."""
    tiles_total: int = 0
    tiles_launched: int = 0
    tiles_pruned: int = 0
    kernel_launches: int = 0
    threshold: float = float("-inf")
    peak_bytes: int = 0
    summary_tiles_refreshed: int = 0


def _publish_scan(stats: ScanStats, scan: str) -> None:
    """Add one scan's :class:`ScanStats` to the ``repro_discovery_*``
    metrics, labelled by ``scan`` (``"pairs"`` or ``"query"``)."""
    if not obs.enabled():
        return
    obs.counter("repro_discovery_scans_total", scan)
    obs.counter("repro_discovery_tiles_total", scan, stats.tiles_total)
    obs.counter("repro_discovery_tiles_launched_total", scan,
                stats.tiles_launched)
    obs.counter("repro_discovery_tiles_pruned_total", scan,
                stats.tiles_pruned)
    obs.counter("repro_discovery_kernel_launches_total", scan,
                stats.kernel_launches)
    obs.gauge("repro_discovery_peak_bytes",
              "peak working-set bytes of the last scan", scan
              ).set(stats.peak_bytes)
    obs.gauge("repro_discovery_summary_tiles_refreshed",
              "cumulative dirty-tile summary refreshes at the last scan",
              scan).set(stats.summary_tiles_refreshed)


@dataclass
class DiscoveryResult:
    """Top-k discovery answer.  ``items`` is descending by score:
    ``(name_a, name_b, estimate)`` for pair scans, ``(name, estimate)``
    for query scans.  ``audit`` (pair scans asked for it) lists every tile
    pair in scan order with its ceiling and whether it was launched.
    ``degraded``, ``coverage``, ``lost_pairs`` and ``lost_shards`` describe
    the shard tasks a sharded fan-out lost; a scan over one index loses
    none."""
    items: list
    stats: ScanStats
    degraded: bool = False
    coverage: float = 1.0
    lost_pairs: tuple = ()
    lost_shards: tuple = ()
    audit: Optional[list] = None

    @property
    def pairs(self) -> list:
        return self.items


def _push_candidates(heap, k, scores, payloads):
    """Stream tile candidates into the bounded min-heap."""
    for sc, payload in zip(scores, payloads):
        item = (float(sc),) + payload
        if len(heap) < k:
            heapq.heappush(heap, item)
        elif item > heap[0]:
            heapq.heappushpop(heap, item)


def _drain(heap) -> list:
    """Heap -> descending score, ties broken by ascending ids (the tie
    contract of the index's ``query(top_k=...)``)."""
    return sorted(heap, key=lambda it: (-it[0],) + it[1:-1])


def _tile_stream(a: ScanTiles, b: ScanTiles, uu: np.ndarray,
                 vv: np.ndarray, ceil: np.ndarray, heap: list, k: int):
    """The tiles of the tile pairs ``(uu[i], vv[i])``, in scan order, in
    batches (one :func:`~repro_torch.kernels.scan_tile_batch` each):
    ``_FIRST_BATCH`` pairs, then twice the last batch, up to the pairs of
    ``_MAX_BATCH`` join tiles (:func:`_batch_cap`).  The caller asks for
    pair i's tile only once pair i passed the stop test; a batch ends
    before the first pair whose ceiling is below the k-th score of the
    full ``heap`` (that score only rises, so the scan stops there or
    earlier)."""
    cap = _batch_cap(a, b)
    i, size = 0, min(_FIRST_BATCH, cap)
    while i < uu.size:
        end = min(uu.size, i + size)
        if len(heap) == k:
            below = np.flatnonzero(ceil[i:end].astype(np.float64)
                                   < heap[0][0])
            if below.size:
                end = i + max(int(below[0]), 1)
        yield from scan_tile_batch(a, b, np.stack([uu[i:end], vv[i:end]],
                                                  axis=1))
        i = end
        size = min(2 * size, cap)


def _batch_cap(a: ScanTiles, b: ScanTiles) -> int:
    """The most tile pairs of ``a`` x ``b`` a batch takes: those of
    ``_MAX_BATCH`` join tiles, and at least one."""
    return max(1, _MAX_BATCH // (a.join_tiles * b.join_tiles))


class DiscoveryEngine:
    """Bound-pruned streaming top-k discovery over one
    :class:`~repro_torch.serve.sketch_service.SketchIndex`.

    ``tile``: rows a scan tile (a power of two).  ``ceiling``:
    ``"admissible"`` (the default) prunes on the deterministic certificate
    only, so the top-k equals ``all_pairs()`` plus a sort;
    ``"chebyshev"`` also applies the Theorem-3 probabilistic ceiling at
    confidence ``1 - delta`` a pair: it prunes more and no longer
    guarantees recall 1.
    """

    def __init__(self, index, *, tile: int = DEFAULT_TILE,
                 ceiling: str = "admissible", delta: float = 0.05):
        if ceiling not in ("admissible", "chebyshev"):
            raise ValueError(f"ceiling must be 'admissible' or 'chebyshev', "
                             f"got {ceiling!r}")
        self.index = index
        self.tile = tile
        self.ceiling = ceiling
        self.delta = delta
        self._summaries = TileSummaries(index, tile)
        self._lock = threading.Lock()
        self._dev_epoch = -1
        self._dev: Optional[BucketizedSketch] = None
        self._probs: Optional[torch.Tensor] = None
        self._scan: Optional[ScanTiles] = None

    def _prepare(self) -> ScanTiles:
        """Refresh the tile summaries, and when the index changed the
        device corpus, its slot probabilities and its scan layout (one
        compaction launch on the card); -> the scan layout."""
        with self._lock:
            self._summaries.refresh()
            ep = self.index.summary_epoch
            if self._dev_epoch != ep:
                self._dev = self.index._corpus()
                self._probs = slot_inclusion_probs(self._dev)
                s = self._summaries
                self._scan = scan_tiles(
                    self._dev.idx, self._dev.val, self._probs,
                    [s.tile_rows(t) for t in range(s.n_tiles)], self.tile)
                self._dev_epoch = ep
            return self._scan

    def _corpus_nbytes(self) -> int:
        return int(self._dev.idx.nbytes + self._dev.val.nbytes +
                   self._probs.nbytes)

    def tile_members(self, t: int) -> np.ndarray:
        """Original row ids of scan tile ``t`` (audit, introspection)."""
        return np.array(self._summaries.tile_rows(t))

    def _ceiling_matrix(self, other: "DiscoveryEngine") -> np.ndarray:
        sa, sb = self._summaries, other._summaries
        ceil = _pair_ceiling_np(sa.tile_g[:, None], sa.tile_n[:, None],
                                sb.tile_g[None, :], sb.tile_n[None, :])
        if self.ceiling == "chebyshev":
            ceil = np.minimum(ceil, chebyshev_estimate_ceiling(
                sa.tile_n[:, None], sb.tile_n[None, :], self.index.m,
                self.delta).numpy())
        return ceil

    def top_pairs(self, k: int = 10, *, absolute: bool = False,
                  audit: bool = False) -> DiscoveryResult:
        """Global top-k pairs of the index against itself (each unordered
        pair once, self-pairs excluded)."""
        with obs.op("serve.discovery.top_pairs") as sp:
            res = _pair_scan(self, self, k, absolute=absolute, audit=audit)
            sp.set("launched", res.stats.tiles_launched)
            sp.set("pruned", res.stats.tiles_pruned)
            _publish_scan(res.stats, "pairs")
            return res

    def top_k_for_query(self, vector, k: int = 10, *,
                        absolute: bool = False) -> DiscoveryResult:
        """Top-k indexed rows for one query vector: corpus tiles whose
        ceiling falls below the running k-th score are never launched."""
        with obs.op("serve.discovery.top_k_for_query") as sp:
            res = self._top_k_for_query(vector, k, absolute=absolute)
            sp.set("launched", res.stats.tiles_launched)
            sp.set("pruned", res.stats.tiles_pruned)
            _publish_scan(res.stats, "query")
            return res

    def _top_k_for_query(self, vector, k: int, *,
                         absolute: bool) -> DiscoveryResult:
        index = self.index
        if not index._names:
            raise ValueError("discovery on an empty index: add vectors "
                             "before querying")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        vector = check_vector(vector, "query vector", dim=index._dim,
                              nonfinite=index.nonfinite)
        # the query sketch takes SketchIndex.query's route
        sq = priority_sketch(torch.as_tensor(vector, device=index.device),
                             index.m, index.seed)
        q = bucketize(sq, n_buckets=index.n_buckets, slots=index.slots)
        gq, nq = _row_summaries(_host(q.val)[None], _host(q.tau).reshape(1))
        cb = self._prepare()
        s = self._summaries
        stats = ScanStats(tiles_total=s.n_tiles,
                          summary_tiles_refreshed=s.refreshes)
        ceil = _pair_ceiling_np(float(gq[0]), float(nq[0]),
                                s.tile_g, s.tile_n)
        if self.ceiling == "chebyshev":
            ceil = np.minimum(ceil, chebyshev_estimate_ceiling(
                float(nq[0]), s.tile_n, index.m, self.delta).numpy())
        order = np.argsort(-ceil, kind="stable")
        qb = BucketizedSketch(q.idx[None], q.val[None], q.tau.reshape(1),
                              torch.zeros((1,), dtype=torch.int32,
                                          device=q.idx.device))
        # the query's one row, laid out once a call
        qt = scan_tiles(qb.idx, qb.val, slot_inclusion_probs(qb),
                        [np.zeros((1,), np.int64)], 1)
        heap: list = []
        launched = 0
        tiles = _tile_stream(qt, cb, np.zeros_like(order), order,
                             ceil[order], heap, k)
        for t in order:
            c = float(ceil[t])
            if len(heap) == k and c < heap[0][0]:
                break
            rows = s.tile_rows(int(t))
            est = next(tiles)[0]
            launched += 1
            score = np.abs(est) if absolute else est
            sel = np.arange(rows.size)
            if rows.size > k:
                sel = np.argpartition(-score, k - 1)[:k]
            _push_candidates(heap, k, score[sel],
                             [(int(rows[i]), float(est[i])) for i in sel])
        obs.kernel_launch("intersect_estimate.tile", launched)
        stats.kernel_launches = stats.tiles_launched = launched
        stats.tiles_pruned = stats.tiles_total - launched
        stats.threshold = heap[0][0] if len(heap) == k else float("-inf")
        # the tile buffer reckoned at a full tile's (T,) float32 row, three
        # times, as the reference's padded tile is
        tile_bytes = 3 * 4 * self.tile
        stats.peak_bytes = (self._corpus_nbytes() + s.nbytes() + ceil.nbytes
                            + tile_bytes + 64 * max(len(heap), 1))
        names = index._names
        items = [(names[rid], est) for _, rid, est in _drain(heap)]
        return DiscoveryResult(items=items, stats=stats)


def _pair_scan(ea: DiscoveryEngine, eb: DiscoveryEngine, k: int, *,
               absolute: bool = False,
               audit: bool = False) -> DiscoveryResult:
    """Bound-pruned scan of every (row of ``ea``) x (row of ``eb``) pair;
    when both engines wrap the same index, each unordered pair is scored
    once and self-pairs are left out."""
    symmetric = ea.index is eb.index
    if ea.tile != eb.tile:
        raise ValueError("engines must share a tile size to scan jointly")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not ea.index._names or not eb.index._names:
        raise ValueError("discovery on an empty index: add vectors first")
    ta = ea._prepare()
    tb = ta if symmetric else eb._prepare()
    sa, sb = ea._summaries, eb._summaries
    T = ea.tile

    ceil = ea._ceiling_matrix(eb)
    if symmetric:
        uu, vv = np.triu_indices(sa.n_tiles)
    else:
        uu, vv = np.indices(ceil.shape).reshape(2, -1)
    order = np.argsort(-ceil[uu, vv], kind="stable")
    uu, vv = uu[order], vv[order]

    stats = ScanStats(
        tiles_total=uu.size,
        summary_tiles_refreshed=sa.refreshes + (0 if symmetric
                                                else sb.refreshes))
    heap: list = []
    audit_log: Optional[list] = [] if audit else None
    n_visited = 0
    tiles = _tile_stream(ta, tb, uu, vv, ceil[uu, vv], heap, k)
    for u, v, c in zip(uu, vv, ceil[uu, vv]):
        c = float(c)
        if len(heap) == k and c < heap[0][0]:
            break
        n_visited += 1
        rows_u, rows_v = sa.tile_rows(int(u)), sb.tile_rows(int(v))
        est = next(tiles)
        score = np.abs(est) if absolute else est
        if symmetric and u == v:
            # the same tile on both sides: strict original-id order drops
            # the mirrored pairs and the self-pairs (tiles u < v have
            # disjoint members)
            flat = np.flatnonzero(rows_u[:, None] < rows_v[None, :])
        else:
            flat = np.arange(est.size)
        if flat.size:
            sflat = score.ravel()[flat]
            if flat.size > k:
                keep = np.argpartition(-sflat, k - 1)[:k]
                flat, sflat = flat[keep], sflat[keep]
            payloads = []
            for fi in flat:
                i, j = divmod(int(fi), rows_v.size)
                aid, bid = int(rows_u[i]), int(rows_v[j])
                if symmetric and aid > bid:
                    aid, bid = bid, aid
                payloads.append((aid, bid, float(est[i, j])))
            _push_candidates(heap, k, sflat, payloads)
        if audit_log is not None:
            audit_log.append({"u": int(u), "v": int(v), "ceiling": c,
                              "launched": True})
    if audit_log is not None:
        for u, v, c in zip(uu[n_visited:], vv[n_visited:],
                           ceil[uu[n_visited:], vv[n_visited:]]):
            audit_log.append({"u": int(u), "v": int(v), "ceiling": float(c),
                              "launched": False})
    obs.kernel_launch("intersect_estimate.tile", n_visited)
    stats.kernel_launches = stats.tiles_launched = n_visited
    stats.tiles_pruned = stats.tiles_total - n_visited
    stats.threshold = heap[0][0] if len(heap) == k else float("-inf")
    # the tile buffer reckoned at a full (T, T) tile, as the reference's
    # padded one: three float32 copies and the bool validity mask
    tile_bytes = (3 * 4 + 1) * T * T if n_visited else 0
    corpus_bytes = ea._corpus_nbytes() + (0 if symmetric
                                          else eb._corpus_nbytes())
    stats.peak_bytes = (corpus_bytes + sa.nbytes()
                        + (0 if symmetric else sb.nbytes())
                        + ceil.nbytes + uu.nbytes + vv.nbytes
                        + tile_bytes + 80 * max(len(heap), 1))
    names_a, names_b = ea.index._names, eb.index._names
    items = [(names_a[aid], names_b[bid], est)
             for _, aid, bid, est in _drain(heap)]
    return DiscoveryResult(items=items, stats=stats, audit=audit_log)


def _merge_stats(parts: list) -> ScanStats:
    """Sum of the per-task scan statistics (the threshold stays unset;
    ``peak_bytes`` sums the tasks' peaks, as the reference's does)."""
    out = ScanStats()
    for s in parts:
        out.tiles_total += s.tiles_total
        out.tiles_launched += s.tiles_launched
        out.tiles_pruned += s.tiles_pruned
        out.kernel_launches += s.kernel_launches
        out.peak_bytes += s.peak_bytes
        out.summary_tiles_refreshed += s.summary_tiles_refreshed
    return out


class ShardedDiscoveryEngine:
    """Guarded fan-out of pruned scans over a
    :class:`~repro_torch.serve.sketch_service.ShardedSketchIndex`.

    Shard-pair tasks (s <= t: the pairs within each shard, and each
    cross-shard combination once) run concurrently in up to
    ``max_workers`` threads (default: 8, or fewer tasks), each launching
    on its shard's device; each task keeps a partial top-k heap, merged at
    the coordinator.  Every task is guarded by ``retry``
    (:class:`~repro_torch.serve.resilience.RetryPolicy`: retry with
    exponential backoff under a per-call deadline, ``TimeoutError``
    terminal at once), so a slow shard costs its own pairs (reported as
    ``coverage`` < 1 and ``lost_pairs``), never the whole answer.
    ``call_wrapper(shards, fn)`` is the fault-injection hook;
    ``kill_shard`` administratively drops a shard; ``sleep`` and
    ``clock`` are injectable for tests.
    """

    def __init__(self, sharded, *, tile: int = DEFAULT_TILE,
                 ceiling: str = "admissible", delta: float = 0.05,
                 retry: Optional[RetryPolicy] = None,
                 call_wrapper: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 max_workers: Optional[int] = None):
        self.sharded = sharded
        self.retry = retry if retry is not None else RetryPolicy()
        self.health = ShardHealth(sharded.num_shards, clock=clock)
        self._call_wrapper = call_wrapper
        self._sleep = sleep
        self._clock = clock
        self._max_workers = max_workers
        self._engines = [DiscoveryEngine(s, tile=tile, ceiling=ceiling,
                                         delta=delta)
                         for s in sharded._shards]

    def kill_shard(self, shard: int, reason: str = "killed") -> None:
        self.health.mark_down(shard, reason)

    def revive_shard(self, shard: int) -> None:
        self.health.beat(shard)

    def _guarded(self, shards: tuple, fn: Callable):
        """One task under the retry policy, keyed by its shard tuple so
        that cross-shard tasks degrade independently.  Raises
        :class:`ShardDownError` carrying the last failure's text."""
        policy = self.retry
        t0 = self._clock()
        delay = policy.base_delay
        last: Optional[BaseException] = None
        with obs.span("serve.discovery.task") as tsp:
            tsp.set("shards", list(shards))
            for attempt in range(max(policy.attempts, 1)):
                try:
                    obs.counter("repro_retry_attempts_total", "discovery")
                    if self._call_wrapper is not None:
                        out = self._call_wrapper(shards, fn)
                    else:
                        out = fn()
                    for p in shards:
                        self.health.beat(p)
                    return out
                except Exception as e:  # noqa: BLE001 — the fault boundary
                    last = e
                    timed_out = isinstance(e, TimeoutError) or (
                        policy.deadline is not None
                        and self._clock() - t0 >= policy.deadline)
                    if timed_out:
                        obs.counter("repro_deadline_hits_total", "discovery")
                    if timed_out or attempt >= policy.attempts - 1:
                        break
                    obs.counter("repro_retry_backoffs_total", "discovery")
                    self._sleep(delay)
                    delay = min(delay * 2.0, policy.max_delay)
            obs.counter("repro_shard_down_total", "discovery")
            raise ShardDownError(
                f"discovery task over shards {shards} failed after "
                f"{attempt + 1} attempt(s): {last}") from last

    def _fan_out(self, tasks: dict):
        """Run ``{shard tuple: thunk}`` concurrently -> ``(results,
        lost)``: each lost task's key with why (a down shard, or its
        :class:`ShardDownError`'s text)."""
        live = {key: fn for key, fn in tasks.items()
                if all(self.health.is_up(p) for p in key)}
        lost = {key: "shard marked down" for key in tasks if key not in live}
        results: dict = {}
        if live:
            workers = self._max_workers or min(8, len(live))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futs = {key: pool.submit(self._guarded, key, fn)
                        for key, fn in live.items()}
                for key, fut in futs.items():
                    try:
                        results[key] = fut.result()
                    except ShardDownError as e:
                        lost[key] = str(e)
        return results, lost

    def top_pairs(self, k: int = 10, *, absolute: bool = False
                  ) -> DiscoveryResult:
        """Global top-k pairs: each unordered pair once, names in global
        insertion order, ties broken by (first, second) insertion
        position, as ``all_pairs()`` plus the sort."""
        sharded = self.sharded
        if not sharded._names:
            raise ValueError("discovery on an empty index: add vectors "
                             "first")
        shards = sharded._shards
        # prepare serially: the scans then only read each engine's state
        for s, e in enumerate(self._engines):
            if len(shards[s]):
                e._prepare()
        tasks = {}
        for s in range(sharded.num_shards):
            if not len(shards[s]):
                continue
            for t in range(s, sharded.num_shards):
                if not len(shards[t]):
                    continue
                ea, eb = self._engines[s], self._engines[t]
                tasks[(s, t)] = (
                    lambda ea=ea, eb=eb: _pair_scan(ea, eb, k,
                                                    absolute=absolute))
        results, lost = self._fan_out(tasks)
        # a cross-shard scan emits (shard-s name, shard-t name):
        # canonicalise to global insertion order
        pos = {name: i for i, name in enumerate(sharded._names)}
        merged: list = []
        for r in results.values():
            for a, b, est in r.items:
                if pos[a] > pos[b]:
                    a, b = b, a
                merged.append((a, b, est))
        score = (lambda it: -abs(it[2])) if absolute else (lambda it: -it[2])
        merged.sort(key=lambda it: (score(it), pos[it[0]], pos[it[1]]))
        stats = _merge_stats([r.stats for r in results.values()])
        # pair counts in Python ints: exact at any corpus size
        total = covered = 0
        sizes = [len(s) for s in shards]
        for s in range(sharded.num_shards):
            for t in range(s, sharded.num_shards):
                n = sizes[s] * (sizes[s] - 1) // 2 if s == t \
                    else sizes[s] * sizes[t]
                total += n
                if (s, t) in results or (s, t) not in lost:
                    covered += n
        res = DiscoveryResult(
            items=merged[:k], stats=stats, degraded=bool(lost),
            coverage=covered / total if total else 1.0,
            lost_pairs=tuple(sorted(lost)),
            lost_shards=tuple(sorted(self.health.down_shards())))
        self._publish_result(res, "pairs", publish_stats=True)
        return res

    def top_k_for_query(self, vector, k: int = 10, *,
                        absolute: bool = False) -> DiscoveryResult:
        """Top-k rows for one query: one pruned query scan a shard, merged
        by score, ties by global insertion position."""
        sharded = self.sharded
        if not sharded._names:
            raise ValueError("discovery on an empty index: add vectors "
                             "first")
        shards = sharded._shards
        tasks = {}
        for s in range(sharded.num_shards):
            if not len(shards[s]):
                continue
            e = self._engines[s]
            tasks[(s,)] = (lambda e=e: e.top_k_for_query(vector, k,
                                                         absolute=absolute))
        results, lost = self._fan_out(tasks)
        pos = {name: i for i, name in enumerate(sharded._names)}
        merged: list = []
        for r in results.values():
            merged.extend(r.items)
        score = (lambda it: -abs(it[1])) if absolute else (lambda it: -it[1])
        merged.sort(key=lambda it: (score(it), pos[it[0]]))
        stats = _merge_stats([r.stats for r in results.values()])
        lost_rows = sum(len(shards[key[0]]) for key in lost)
        D = len(sharded)
        res = DiscoveryResult(
            items=merged[:k], stats=stats, degraded=bool(lost),
            coverage=(D - lost_rows) / D if D else 1.0,
            lost_pairs=tuple(sorted(lost)),
            lost_shards=tuple(sorted(self.health.down_shards())))
        self._publish_result(res, "query", publish_stats=False)
        return res

    def _publish_result(self, res: DiscoveryResult, scan: str,
                        *, publish_stats: bool) -> None:
        """Coverage and shard-health metrics of one fan-out.  Query tasks
        publish their own scan statistics through the shard engines; pair
        tasks bypass them, so their merged statistics are published
        here."""
        if not obs.enabled():
            return
        if publish_stats:
            _publish_scan(res.stats, scan)
        obs.quality_monitor().observe_coverage(res.coverage,
                                               "discovery." + scan)
        obs.gauge("repro_shards_down", "shards currently marked down",
                  "discovery").set(len(res.lost_shards))
        if res.degraded:
            obs.counter("repro_degraded_results_total", "discovery." + scan)
