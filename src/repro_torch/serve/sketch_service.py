"""Sketch index service: the query-vs-corpus and all-pairs serving path of
the paper's introduction, on the port's CUDA kernels.

Vectors are sketched on ingestion and bucketized straight into
pre-allocated (capacity, B, S) host blocks: ``add`` is an amortized O(m)
append; ``add_many`` sketches a whole (D, n) block with one batched
linear-time build on the card (the hash/rank/histogram and refinement
kernels), bucketizes it there, and brings the bucketized block back once.
Capacity grows by doubling and stays a power of two.  ``query`` answers
all D estimates with one launch of the query kernel; ``all_pairs`` gives
the (D, D) matrix with one launch of the all-pairs kernel;
``merge_from`` folds a partition peer's index in with one launch of the
bucketized merge kernel.  The device copy of the occupied corpus is rebuilt
lazily after each mutation.

Plain mode only: the bias-aware and private query modes (and the privacy
accountant that ``merge_from`` composes in the reference), ``top_pairs``,
``top_k_for_query`` and ``MatrixSketchStore`` come with later slices
(ROADMAP queue A).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import INVALID_IDX, priority_sketch
from repro_torch.device import resolve_device
from repro_torch.kernels import (BucketizedSketch, bucketize,
                                 bucketize_corpus, build_priority_corpus,
                                 estimate_all_pairs_bucketized,
                                 merge_bucketized_corpora, query_corpus,
                                 round_up_pow2)

from .validation import (check_finite, check_nonfinite_policy, check_sparse,
                         check_unique_name, check_unique_names, check_vector)

QUERY_MODES = ("plain", "bias_aware", "private")


def _row_summaries(val: np.ndarray, tau: np.ndarray):
    """(R, B, S) values + (R,) taus -> per-row (G, N) ceiling summaries
    (rescaled and plain kept norms, DESIGN.md §17 of the reference)."""
    w = np.asarray(val, np.float32) ** 2
    tw = np.multiply(np.asarray(tau, np.float32)[:, None, None], w,
                     where=w > 0, out=np.ones_like(w))  # inf tau * 0 pad
    p = np.where(w > 0, np.minimum(1.0, tw), 1.0)
    g = np.sqrt(np.sum(w / (p * p), axis=(1, 2)))
    n = np.sqrt(np.sum(w, axis=(1, 2)))
    return g.astype(np.float32), n.astype(np.float32)


def _top_k_desc(est: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` largest entries, descending, by partial
    selection.  Ties rank by ascending index, including ties that
    straddle the selection boundary."""
    D = est.shape[0]
    k = min(int(k), D)
    if k <= 0:
        return np.empty((0,), np.int64)
    if k < D:
        part = np.argpartition(-est, k - 1)[:k]
        kth = est[part].min()
        # argpartition breaks boundary ties arbitrarily: rebuild the
        # selection as (everything above the kth value) + (ties at the kth
        # value, lowest index first)
        above = np.flatnonzero(est > kth)
        tied = np.flatnonzero(est == kth)
        sel = np.concatenate([above, tied[: k - above.size]])
    else:
        sel = np.arange(D)
    # lexsort: primary descending score, secondary ascending index
    return sel[np.lexsort((sel, -est[sel]))]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SketchIndex:
    """Incremental priority-sketch index (plain mode).

    ``m``: samples per indexed vector; ``n_buckets``/``slots``: the
    bucketized layout (``n_buckets >= 2 m`` keeps overflow drops near
    zero); ``seed``: the shared coordination seed; ``initial_capacity``:
    starting row allocation (grows by doubling); ``nonfinite``:
    ``"raise"`` rejects NaN/Inf input, ``"sanitize"`` zeroes it;
    ``head_h``: exact top-``head_h`` coordinates kept per row for the
    bias-aware mode; ``device``: where sketches are built and estimated
    (default ``cuda``; ``"cpu"`` runs the kernels' plain versions).
    """

    def __init__(self, m: int = 256, *, n_buckets: int = 512, slots: int = 4,
                 seed: int = 11, initial_capacity: int = 64,
                 nonfinite: str = "raise", head_h: int = 16, device=None):
        self.device = resolve_device(device)
        self.m = m
        self.n_buckets = n_buckets
        self.slots = slots
        self.seed = seed
        self.nonfinite = check_nonfinite_policy(nonfinite)
        if head_h < 0:
            raise ValueError(f"need head_h >= 0, got {head_h}")
        self.head_h = int(head_h)
        self._dim: Optional[int] = None  # universe size, fixed on first add
        self._name_set: set = set()
        self._names: list = []
        self._cap = round_up_pow2(initial_capacity)
        self._idx = np.full((self._cap, n_buckets, slots), INVALID_IDX,
                            np.int32)
        self._val = np.zeros((self._cap, n_buckets, slots), np.float32)
        # padding rows get tau=1 so their (all-INVALID) estimates are inert
        self._tau = np.ones((self._cap,), np.float32)
        self._dropped = np.zeros((self._cap,), np.int32)
        self._device_corpus: Optional[BucketizedSketch] = None
        # per-row rescaled / plain kept norms, refreshed per touched row
        self._g = np.zeros((self._cap,), np.float32)
        self._kn = np.zeros((self._cap,), np.float32)
        self._stats_epoch = 0
        self._stats_rows_computed = 0
        # bias-aware head state: per-row exact top-head_h coordinates,
        # values, and whether each landed in the bucketized kept set
        self._head_idx = np.full((self._cap, self.head_h), -1, np.int64)
        self._head_val = np.zeros((self._cap, self.head_h), np.float32)
        self._head_kept = np.zeros((self._cap, self.head_h), bool)

    def __len__(self):
        return len(self._names)

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def total_dropped(self) -> int:
        """Entries lost to bucket overflow across all indexed vectors."""
        return int(self._dropped[: len(self._names)].sum())

    def _grow(self) -> None:
        new_cap = self._cap * 2

        def extend(arr, fill):
            out = np.full((new_cap,) + arr.shape[1:], fill, arr.dtype)
            out[: self._cap] = arr
            return out

        self._idx = extend(self._idx, INVALID_IDX)
        self._val = extend(self._val, 0)
        self._tau = extend(self._tau, 1)
        self._dropped = extend(self._dropped, 0)
        self._g = extend(self._g, 0)
        self._kn = extend(self._kn, 0)
        self._head_idx = extend(self._head_idx, -1)
        self._head_val = extend(self._head_val, 0)
        self._head_kept = extend(self._head_kept, False)
        self._cap = new_cap

    def _set_head_row(self, d: int, coords: np.ndarray,
                      vals: np.ndarray) -> None:
        """Record row ``d``'s exact head: the top-``head_h`` nonzero
        coordinates by l2 weight, sorted by coordinate, and whether each
        landed in the row's bucketized kept set.  Runs after the row's
        bucketized blocks are written."""
        h = self.head_h
        if h == 0:
            return
        coords = np.asarray(coords, np.int64)
        vals = np.asarray(vals, np.float32)
        live = vals != 0
        coords, vals = coords[live], vals[live]
        if coords.size > h:
            part = np.argpartition(-(vals.astype(np.float64) ** 2),
                                   h - 1)[:h]
            coords, vals = coords[part], vals[part]
        order = np.argsort(coords)
        coords, vals = coords[order], vals[order]
        k = coords.size
        self._head_idx[d, :k] = coords
        self._head_idx[d, k:] = -1
        self._head_val[d, :k] = vals
        self._head_val[d, k:] = 0
        row = self._idx[d].ravel()
        self._head_kept[d, :k] = np.isin(coords, row[row != INVALID_IDX])
        self._head_kept[d, k:] = False

    def _refresh_row_stats(self, lo: int, hi: int) -> None:
        """Recompute the ceiling summaries of rows [lo, hi) only."""
        if hi <= lo:
            return
        self._g[lo:hi], self._kn[lo:hi] = _row_summaries(
            self._val[lo:hi], self._tau[lo:hi])
        self._stats_rows_computed += hi - lo
        self._stats_epoch += 1

    def row_summaries(self):
        """Current per-row (G, N) ceiling summaries of the occupied rows."""
        D = len(self._names)
        return self._g[:D], self._kn[:D]

    @property
    def summary_epoch(self) -> int:
        """Bumps on every mutation that touches row summaries."""
        return self._stats_epoch

    def add(self, name, vector: Optional[np.ndarray] = None, *,
            indices: Optional[np.ndarray] = None,
            values: Optional[np.ndarray] = None) -> None:
        """Sketch + bucketize one vector and append it in place.

        Takes a dense ``vector`` or a sparse column ``(indices, values)``
        (ascending coordinates), which hashes only the given coordinates.
        Sparse inputs are padded to the next power of two (padding weight
        0 is never sampled)."""
        if (vector is None) == (indices is None and values is None):
            raise ValueError("pass either a dense vector or (indices, values)")
        check_unique_name(name, self._name_set)
        dev = self.device
        with obs.op("serve.index.add") as sp:
            if vector is not None:
                vector = check_vector(vector, f"vector {name!r}",
                                      dim=self._dim,
                                      nonfinite=self.nonfinite)
                self._dim = vector.shape[0]
                sk = priority_sketch(torch.as_tensor(vector, device=dev),
                                     self.m, self.seed)
            else:
                if indices is None or values is None:
                    raise ValueError(
                        "sparse input needs both indices and values")
                indices, values = check_sparse(indices, values, dim=self._dim,
                                               nonfinite=self.nonfinite)
                nnz = indices.shape[0]
                pad = round_up_pow2(max(nnz, 1)) - nnz
                # padding: value 0 -> weight 0 -> rank +inf, never selected
                vals_p = torch.as_tensor(np.pad(values, (0, pad)), device=dev)
                idx_p = torch.as_tensor(np.pad(indices, (0, pad)), device=dev)
                sk = priority_sketch(vals_p, self.m, self.seed, indices=idx_p)
                sp.set("sparse", True)
            b = bucketize(sk, n_buckets=self.n_buckets, slots=self.slots)
            if len(self._names) == self._cap:
                self._grow()
            d = len(self._names)
            self._idx[d] = _host(b.idx)
            self._val[d] = _host(b.val)
            self._tau[d] = float(b.tau)
            self._dropped[d] = int(b.dropped)
            if vector is not None:
                nz = np.flatnonzero(vector)
                self._set_head_row(d, nz, vector[nz])
            else:
                self._set_head_row(d, indices, values)
            self._names.append(name)
            self._name_set.add(name)
            self._refresh_row_stats(d, d + 1)
            self._device_corpus = None

    def add_many(self, names: Sequence, matrix: np.ndarray) -> None:
        """Batch-ingest a (D, n) block: one linear-time build of all D
        vectors on the device plus one bucketize, written into the host
        blocks.  Equal to D ``add`` calls (same sketches, same layout)."""
        matrix = np.asarray(matrix, np.float32)
        if matrix.ndim != 2 or matrix.shape[0] != len(names):
            raise ValueError("matrix must be (len(names), n)")
        check_unique_names(names, self._name_set)
        if self._dim is not None and matrix.shape[1] != self._dim:
            raise ValueError(f"matrix has {matrix.shape[1]} coordinates but "
                             f"this index was built over {self._dim}")
        matrix = check_finite(matrix, "ingest matrix",
                              nonfinite=self.nonfinite)
        D = matrix.shape[0]
        if D == 0:
            return
        with obs.op("serve.index.add_many") as sp:
            sp.set("rows", D)
            self._dim = matrix.shape[1]
            sk = build_priority_corpus(torch.as_tensor(matrix), self.m,
                                       self.seed, device=self.device)
            bc = bucketize_corpus(sk, n_buckets=self.n_buckets,
                                  slots=self.slots)
            while len(self._names) + D > self._cap:
                self._grow()
            d0 = len(self._names)
            self._idx[d0:d0 + D] = _host(bc.idx)
            self._val[d0:d0 + D] = _host(bc.val)
            self._tau[d0:d0 + D] = _host(bc.tau)
            self._dropped[d0:d0 + D] = _host(bc.dropped)
            for k in range(D):
                nz = np.flatnonzero(matrix[k])
                self._set_head_row(d0 + k, nz, matrix[k, nz])
            self._names.extend(names)
            self._name_set.update(names)
            self._refresh_row_stats(d0, d0 + D)
            self._device_corpus = None

    def _rollback_last(self, k: int) -> None:
        """Undo the last ``k`` appended rows, restoring padding state
        (INVALID ids, tau=1) so the blocks stay inert."""
        for _ in range(k):
            name = self._names.pop()
            self._name_set.discard(name)
            d = len(self._names)
            self._idx[d] = INVALID_IDX
            self._val[d] = 0
            self._tau[d] = 1
            self._dropped[d] = 0
            self._g[d] = 0
            self._kn[d] = 0
            self._head_idx[d] = -1
            self._head_val[d] = 0
            self._head_kept[d] = False
        self._stats_epoch += 1
        self._device_corpus = None

    def _corpus(self) -> BucketizedSketch:
        """Occupied corpus prefix on the device, rounded up to a power of
        two (at least 8 rows), so its shape changes only on doublings."""
        if self._device_corpus is None:
            c = min(self._cap, max(round_up_pow2(max(len(self._names), 1)), 8))
            dev = self.device
            self._device_corpus = BucketizedSketch(
                torch.tensor(self._idx[:c], device=dev),
                torch.tensor(self._val[:c], device=dev),
                torch.tensor(self._tau[:c], device=dev),
                torch.tensor(self._dropped[:c], device=dev))
        return self._device_corpus

    def query(self, vector: np.ndarray, top_k: Optional[int] = None, *,
              mode: str = "plain"):
        """Inner-product estimates of ``vector`` against every indexed
        vector, with one launch of the query kernel.  Returns
        ``[(name, estimate)]`` in index order, or the ``top_k`` largest,
        descending (ties by ascending index)."""
        if mode not in QUERY_MODES:
            raise ValueError(f"unknown mode {mode!r}; expected "
                             "'plain'|'bias_aware'|'private'")
        if mode != "plain":
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet (ROADMAP step A12)")
        if not self._names:
            raise ValueError("query on an empty index: add vectors before "
                             "querying")
        with obs.op("serve.index.query") as sp:
            sp.set("rows", len(self._names))
            sp.set("mode", mode)
            vector = check_vector(vector, "query vector", dim=self._dim,
                                  nonfinite=self.nonfinite)
            sq = priority_sketch(torch.as_tensor(vector, device=self.device),
                                 self.m, self.seed)
            q = bucketize(sq, n_buckets=self.n_buckets, slots=self.slots)
            est = _host(query_corpus(q, self._corpus())).astype(
                np.float64)[: len(self._names)]
            if top_k is None:
                return list(zip(self._names, est.tolist()))
            order = _top_k_desc(est, top_k)
            return [(self._names[i], float(est[i])) for i in order]

    def all_pairs(self, *, use_kernel: bool = True) -> np.ndarray:
        """(D, D) inner-product estimate matrix over the indexed vectors,
        with one launch of the all-pairs kernel."""
        with obs.op("serve.index.all_pairs") as sp:
            c = self._corpus()
            # the plain version is chunked so it never holds (D, D, B)
            est = _host(estimate_all_pairs_bucketized(
                c, c, ref_chunk=64, use_kernel=use_kernel))
            D = len(self._names)
            sp.set("rows", D)
            return est[:D, :D]

    def merge_from(self, other: "SketchIndex") -> None:
        """Merge a partition-peer index into this one, row by row, without
        leaving the bucketized layout (DESIGN.md §14 of the reference).

        ``other`` must index the same names in the same order, each row
        sketching a disjoint coordinate partition of the same vector (two
        ingestion hosts each sketching part of the coordinates of every
        column).  One launch of the merge kernel merges all rows; raw
        vectors are never touched.  Exact up to bucket-overflow drops on
        either side (counted in ``total_dropped``): an entry already lost
        to a full bucket cannot re-enter the union."""
        if (other.m, other.n_buckets, other.slots, other.seed) != \
                (self.m, self.n_buckets, self.slots, self.seed):
            raise ValueError("indexes must share m/n_buckets/slots/seed "
                             "to merge")
        if other._names != self._names:
            raise ValueError("row names must align for a partition merge")
        D = len(self._names)
        if D == 0:
            return
        with obs.op("serve.index.merge_from") as sp:
            sp.set("rows", D)
            dev = self.device

            def on_device(ix):
                return BucketizedSketch(
                    *(torch.as_tensor(a[:D], device=dev) for a in
                      (ix._idx, ix._val, ix._tau, ix._dropped)))

            merged = merge_bucketized_corpora(on_device(self),
                                              on_device(other), self.seed,
                                              m=self.m)
            self._idx[:D] = _host(merged.idx)
            self._val[:D] = _host(merged.val)
            self._tau[:D] = _host(merged.tau)
            self._dropped[:D] = _host(merged.dropped)
            if self.head_h:
                # disjoint coordinate partitions: the merged head is the
                # top-head_h of the union of both heads, values exact (a
                # coordinate is nonzero in one partition only); the kept
                # flags are recomputed against the merged blocks
                for d in range(D):
                    hm, ho = self._head_idx[d], other._head_idx[d]
                    coords = np.concatenate([hm[hm >= 0], ho[ho >= 0]])
                    vals = np.concatenate([self._head_val[d][hm >= 0],
                                           other._head_val[d][ho >= 0]])
                    self._set_head_row(d, coords, vals)
            # every row's kept set and tau changed: all D rows are dirty
            self._refresh_row_stats(0, D)
            self._device_corpus = None
