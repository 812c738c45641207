"""Bucketized sketch layout and the estimation entry points.

Layout (DESIGN.md §4 of the reference): entry ``i`` of a sorted sketch
lands in bucket ``hash(i) mod B`` with at most S slots a bucket, in
coordinate order; coordinated sketches share the bucket seed, so a shared
coordinate lands in the same bucket on both sides.  The layout is
bit-identical to ``repro.kernels.intersect_estimate``'s.

Estimation entry points:

- ``query_corpus``                   one query vs a corpus (serving path)
- ``estimate_all_pairs_bucketized``  the (D1, D2) estimate matrix
- ``estimate_tile_rows``             one tile of it from gathered rows
- ``scan_tiles`` / ``scan_tile_batch`` a corpus laid out once for the
                                     discovery scans, and a batch of its
                                     tile pairs in one launch
- ``allpairs_moments``               (D1, D2, 6) co-moment channels

Each launches its CUDA kernel for CUDA tensors and the plain version for
CPU tensors; ``use_kernel=False`` asks for the plain version explicitly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.hashing import hash_bucket
from repro_torch.core.sketches import INVALID_IDX, Sketch

from .intersect_estimate import (allpairs_compact, allpairs_estimate,
                                 allpairs_join_tiles, intersect_estimate)
from .ref import COMPACT_TILE, allpairs_estimate_ref, intersect_estimate_ref

DEFAULT_BUCKET_SEED = 0xB0C4


class BucketizedSketch(NamedTuple):
    idx: torch.Tensor      # int32 (B, S) or (C, B, S)
    val: torch.Tensor      # float32, same shape
    tau: torch.Tensor      # float32 scalar or (C,)
    dropped: torch.Tensor  # int32 scalar or (C,): bucket-overflow losses


def round_up_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def bucketize_payloads(idx: torch.Tensor, payloads: tuple, *,
                       n_buckets: int = 512, slots: int = 4,
                       bucket_seed: int = DEFAULT_BUCKET_SEED):
    """Re-lay sorted index rows and per-entry payloads into (B, S).

    ``idx``: (cap,) or (C, cap) int32; each payload the same shape.
    Returns ``(out_idx (..., B, S) int32, tuple of (..., B, S) float32
    payloads, dropped (...) int32)``.  Entries beyond S in a bucket are
    dropped and counted; a dropped entry is written nowhere (it never
    clobbers another cell).
    """
    one = idx.ndim == 1
    if one:
        idx = idx[None]
        payloads = tuple(p[None] for p in payloads)
    C, cap = idx.shape
    dev = idx.device
    valid = idx != INVALID_IDX
    b = torch.where(valid, hash_bucket(bucket_seed, idx, n_buckets),
                    n_buckets).to(torch.int64)  # invalid -> sentinel bucket
    order = torch.argsort(b, dim=1, stable=True)
    b_sorted = torch.gather(b, 1, order)
    # position within the bucket = rank - first rank of this bucket value
    first = torch.searchsorted(b_sorted, b_sorted, side="left")
    pos = torch.arange(cap, device=dev)[None, :] - first
    keep = (b_sorted < n_buckets) & (pos < slots)
    cells = n_buckets * slots
    flat = torch.where(keep, b_sorted * slots + pos,
                       torch.full_like(pos, cells))   # extra, discarded cell
    out_idx = torch.full((C, cells + 1), INVALID_IDX, dtype=torch.int32,
                         device=dev)
    out_idx.scatter_(1, flat, torch.gather(idx.to(torch.int32), 1, order))
    outs = []
    for p in payloads:
        out = torch.zeros((C, cells + 1), dtype=torch.float32, device=dev)
        out.scatter_(1, flat, torch.gather(p.to(torch.float32), 1, order))
        outs.append(out[:, :cells].reshape(C, n_buckets, slots).contiguous())
    dropped = (valid.sum(dim=1) - keep.sum(dim=1)).to(torch.int32)
    out_idx = out_idx[:, :cells].reshape(C, n_buckets, slots).contiguous()
    if one:
        return out_idx[0], tuple(o[0] for o in outs), dropped[0]
    return out_idx, tuple(outs), dropped


def bucketize(sketch: Sketch, *, n_buckets: int = 512, slots: int = 4,
              bucket_seed: int = DEFAULT_BUCKET_SEED) -> BucketizedSketch:
    """Re-lay a sorted sketch (or a (C, cap) batch) into (B, S) buckets."""
    out_idx, (out_val,), dropped = bucketize_payloads(
        sketch.idx, (sketch.val,), n_buckets=n_buckets, slots=slots,
        bucket_seed=bucket_seed)
    return BucketizedSketch(out_idx, out_val,
                            torch.as_tensor(sketch.tau, dtype=torch.float32),
                            dropped)


def bucketize_corpus(sketches: Sketch, **kw) -> BucketizedSketch:
    """Bucketize a (C, cap) corpus of sketches."""
    return bucketize(sketches, **kw)


def slot_inclusion_probs(bc: BucketizedSketch, *,
                         variant: str = "l2") -> torch.Tensor:
    """Per-slot inclusion probability min(1, tau * w(val)) of a (C, B, S)
    corpus; 1.0 at padding (w == 0), so an inf tau never gives NaN."""
    from repro_torch.engine.bucketized import payload_slot_probs
    from repro_torch.engine.containers import BucketizedPayloads
    return payload_slot_probs(
        BucketizedPayloads(bc.idx, bc.val[..., None], bc.tau, bc.dropped),
        variant=variant)


def query_corpus(q: BucketizedSketch, corpus: BucketizedSketch, *,
                 use_kernel: bool = True) -> torch.Tensor:
    """(C,) inner-product estimates of one query against a corpus."""
    obs.kernel_launch("intersect_estimate.query")
    if not use_kernel:
        return intersect_estimate_ref(q.idx, q.val, q.tau, corpus.idx,
                                      corpus.val, corpus.tau)
    return intersect_estimate(q.idx, q.val, q.tau, corpus.idx, corpus.val,
                              corpus.tau)


def estimate_all_pairs_bucketized(A: BucketizedSketch, B: BucketizedSketch,
                                  *, variant: str = "l2",
                                  ref_chunk: int | None = None,
                                  use_kernel: bool = True) -> torch.Tensor:
    """(D1, B, S) x (D2, B, S) bucketized corpora -> (D1, D2) estimates
    (on the card: the compaction pass, then one join launch).
    ``ref_chunk`` chunks the plain version's corpus side (intermediates
    (D1, ref_chunk, B))."""
    obs.kernel_launch("intersect_estimate.allpairs")
    a_p = slot_inclusion_probs(A, variant=variant)
    # one corpus against itself (all_pairs) is compacted once on the card
    b_p = a_p if B is A else slot_inclusion_probs(B, variant=variant)
    if not use_kernel:
        return allpairs_estimate_ref(A.idx, A.val, a_p, B.idx, B.val, b_p,
                                     ct=ref_chunk)
    return allpairs_estimate(A.idx, A.val, a_p, B.idx, B.val, b_p)


def estimate_tile_rows(a_idx, a_val, a_p, b_idx, b_val, b_p, rows_a, rows_b,
                       *, use_kernel: bool = True) -> torch.Tensor:
    """One (tq, tc) tile of the all-pairs matrix from gathered row subsets
    of two bucketized corpora (idx/val/inclusion-probability triples) —
    the reference's discovery tile launch (DESIGN.md §17 of the
    reference), kept as the oracle of the scans' batches
    (:func:`scan_tile_batch`).

    ``rows_a`` (tq,) / ``rows_b`` (tc,) are row ids into the (D, B, S)
    arrays; out-of-range ids clamp, as the reference's gather does
    (callers pad short tiles with any id and mask the padding).  One
    all-pairs launch a tile; a cell's bits depend on its two rows only, so
    a tile equals the matching block of the full matrix bit for bit."""
    obs.kernel_launch("intersect_estimate.tile")

    def gather(rows, *arrs):
        r = torch.as_tensor(rows, device=arrs[0].device).to(torch.int64)
        r = r.clamp(0, arrs[0].shape[0] - 1)
        return tuple(x.index_select(0, r) for x in arrs)

    a = gather(rows_a, a_idx, a_val, a_p)
    b = gather(rows_b, b_idx, b_val, b_p)
    if not use_kernel:
        return allpairs_estimate_ref(*a, *b)
    return allpairs_estimate(*a, *b)


class ScanTiles(NamedTuple):
    """A corpus laid out once for the discovery scans' tile batches
    (:func:`scan_tiles`): scan tile ``u`` holds ``sizes[u]`` rows (at most
    ``tile``).  On the card, ``entries`` / ``counts`` are the compaction
    of the rows in scan order through a row list: a tile of T >= 64 rows
    is T / 64 compacted tiles, a tile of T < 64 rows a slice of one.  On
    the CPU, ``gathered`` holds each tile's (idx, val, p) rows."""
    tile: int
    sizes: np.ndarray
    entries: Optional[torch.Tensor] = None
    counts: Optional[torch.Tensor] = None
    gathered: Optional[list] = None

    @property
    def join_tiles(self) -> int:
        """Compacted tiles a scan tile spans on each side (1 below 64
        rows): a tile pair is ``a.join_tiles * b.join_tiles`` join
        tiles."""
        return max(self.tile // COMPACT_TILE, 1)

    @property
    def nbytes(self) -> int:
        if self.entries is not None:
            return int(self.entries.nbytes + self.counts.nbytes)
        return int(sum(x.nbytes for g in self.gathered for x in g))


def scan_tiles(idx, val, p, rows: list, tile: int) -> ScanTiles:
    """Lay a (D, B, S) corpus (idx/val/inclusion-probability triple) out
    for tile scans: ``rows[u]`` are the row ids of scan tile ``u`` (a
    power-of-two ``tile`` of them, the last tile possibly short).  On the
    card one compaction launch; on the CPU each tile's rows gathered."""
    sizes = np.array([r.size for r in rows], np.int64)
    if idx.device.type == "cpu":
        gathered = [tuple(x.index_select(0, torch.as_tensor(r).to(
            torch.int64)) for x in (idx, val, p)) for r in rows]
        return ScanTiles(tile, sizes, gathered=gathered)
    entries, counts = allpairs_compact(
        idx, val, p, rows=torch.as_tensor(scan_row_list(rows, tile),
                                          device=idx.device))
    return ScanTiles(tile, sizes, entries, counts)


def scan_row_list(rows: list, tile: int) -> np.ndarray:
    """The compaction's row list of scan tiles ``rows`` (``tile`` rows
    each, at most): tile u's rows from slot u * tile on, -1 in the short
    tail and after, to whole compacted tiles of 64 rows (int32)."""
    n = len(rows) * tile
    flat = np.full((-(-n // COMPACT_TILE) * COMPACT_TILE,), -1, np.int32)
    for u, r in enumerate(rows):
        flat[u * tile:u * tile + r.size] = r
    return flat


def _join_pairs(a: ScanTiles, b: ScanTiles, pairs: np.ndarray) -> np.ndarray:
    """Tile pairs ``(u, v)`` of two compacted layouts -> the (n * kk, 2)
    int32 list of the join tiles they span (kk = ``a.join_tiles *
    b.join_tiles``), pair by pair, A tiles major."""
    ka, kb = a.join_tiles, b.join_tiles
    jt = np.empty((pairs.shape[0], ka, kb, 2), np.int32)
    jt[..., 0] = (pairs[:, 0] * a.tile // COMPACT_TILE)[:, None, None] \
        + np.arange(ka)[None, :, None]
    jt[..., 1] = (pairs[:, 1] * b.tile // COMPACT_TILE)[:, None, None] \
        + np.arange(kb)[None, None, :]
    return jt.reshape(-1, 2)


def _cut_tiles(host: np.ndarray, a: ScanTiles, b: ScanTiles,
               pairs: np.ndarray) -> list:
    """The (n * kk, 64, 64) join tiles of :func:`_join_pairs` on the host
    -> each pair's (sizes[u], sizes[v]) tile: its kk join tiles put
    together, then the scan tiles' rows cut out (a scan tile below 64
    rows sits at row ``u * tile % 64`` of its join tile)."""
    ka, kb = a.join_tiles, b.join_tiles
    tiles = []
    for i, (u, v) in enumerate(pairs):
        blk = host[i * ka * kb:(i + 1) * ka * kb].reshape(
            ka, kb, COMPACT_TILE, COMPACT_TILE).transpose(0, 2, 1, 3).reshape(
            ka * COMPACT_TILE, kb * COMPACT_TILE)
        ra = u * a.tile % COMPACT_TILE if a.tile < COMPACT_TILE else 0
        rb = v * b.tile % COMPACT_TILE if b.tile < COMPACT_TILE else 0
        tiles.append(blk[ra:ra + a.sizes[u], rb:rb + b.sizes[v]])
    return tiles


def scan_tile_batch(a: ScanTiles, b: ScanTiles, pairs: np.ndarray) -> list:
    """Tile pairs ``(u, v)`` (an (n, 2) integer array) of two laid-out
    corpora -> the n (sizes[u], sizes[v]) float32 tiles of estimates on
    the host.  On the card one :func:`allpairs_join_tiles` launch on the
    join tiles the pairs span and one copy into a pinned buffer of this
    call, each tile bit-equal to :func:`estimate_tile_rows` on its rows;
    on the CPU :func:`allpairs_estimate_ref` on each pair's gathered rows
    (the bits ``estimate_tile_rows`` gives there).  A pair runs as
    :func:`allpairs_join_tiles`' default groups of blocks, one block for
    a one-row A side (a query)."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if a.entries is None:
        return [allpairs_estimate_ref(*a.gathered[u], *b.gathered[v])
                .numpy() for u, v in pairs]
    dev = a.entries.device
    jt = torch.from_numpy(_join_pairs(a, b, pairs)).pin_memory()
    out = allpairs_join_tiles(a.entries, a.counts, b.entries, b.counts,
                              jt.to(dev, non_blocking=True),
                              groups=1 if a.tile == 1 else None)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    done.synchronize()
    return _cut_tiles(host.numpy(), a, b, pairs)


def allpairs_moments(a_idx, a_val, a_p, b_idx, b_val, b_p, *,
                     ref_chunk: int | None = None,
                     use_kernel: bool = True) -> torch.Tensor:
    """(D1, D2, 6) co-moment channels (``MOMENT_CHANNELS`` order) with
    caller-supplied per-slot inclusion probabilities — the join-correlation
    all-pairs path (DESIGN.md §7, §12 of the reference)."""
    obs.kernel_launch("intersect_estimate.moments")
    if not use_kernel:
        return allpairs_estimate_ref(a_idx, a_val, a_p, b_idx, b_val, b_p,
                                     moments=True, ct=ref_chunk)
    return allpairs_estimate(a_idx, a_val, a_p, b_idx, b_val, b_p,
                             moments=True)
