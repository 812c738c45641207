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
lazily after each mutation.  ``query(mode=...)`` also answers with the
bias-aware exact-head correction and against a differentially-private
release of the corpus (``dp=DPParams(...)``), charged on the index's
privacy accountant.

:class:`MatrixSketchStore` is the matrix surface: a library of
row-sampled matrix sketches answering ``A^T B`` estimates, one query
against the whole library with one launch of the matrix-product kernel.

``top_pairs`` and ``top_k_for_query`` come with a later slice (ROADMAP
queue A, step 11).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import INVALID_IDX, priority_sketch
from repro_torch.device import resolve_device
from repro_torch.kernels import (BucketizedSketch, bucketize,
                                 bucketize_corpus, bucketize_matrix_sketches,
                                 build_priority_corpus,
                                 estimate_all_pairs_bucketized,
                                 matrix_products, matrix_slot_probs,
                                 merge_bucketized_corpora, query_corpus,
                                 round_up_pow2)
from repro_torch.matrix import (MatrixSketch, estimate_matrix_product,
                                estimate_matrix_products,
                                priority_matrix_sketch)
from repro_torch.private import (PrivacyAccountant, estimate_private_dense,
                                 private_release_corpus)

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
    """Incremental priority-sketch index.

    ``m``: samples per indexed vector; ``n_buckets``/``slots``: the
    bucketized layout (``n_buckets >= 2 m`` keeps overflow drops near
    zero); ``seed``: the shared coordination seed; ``initial_capacity``:
    starting row allocation (grows by doubling); ``nonfinite``:
    ``"raise"`` rejects NaN/Inf input, ``"sanitize"`` zeroes it;
    ``head_h``: exact top-``head_h`` coordinates kept per row for the
    bias-aware mode; ``device``: where sketches are built and estimated
    (default ``cuda``; ``"cpu"`` runs the kernels' plain versions).

    ``query(..., mode=...)`` selects

    - ``"plain"``: Algorithm 2 on the query kernel (the default);
    - ``"bias_aware"``: the same plus an exact-head correction — each
      row's top-``head_h`` coordinates (tracked at ingest) contribute
      their exact product with the known query instead of the sampled
      Horvitz-Thompson term;
    - ``"private"``: estimates against a differentially-private release
      of the corpus (``dp=DPParams(...)`` required), built lazily, charged
      once on :attr:`accountant` (disjoint rows compose in parallel),
      cached until the corpus changes; queries of a cached release are
      free.  ``privacy_budget`` pins a finite epsilon budget; overdrawing
      raises ``PrivacyBudgetExceeded`` before any release is made.
      Release randomness is OS entropy, never the public ``seed``;
      ``dp_rng`` injects a seeded generator for tests only.
    """

    def __init__(self, m: int = 256, *, n_buckets: int = 512, slots: int = 4,
                 seed: int = 11, initial_capacity: int = 64,
                 nonfinite: str = "raise", head_h: int = 16, dp=None,
                 privacy_budget: Optional[float] = None, dp_rng=None,
                 device=None):
        self.device = resolve_device(device)
        self.m = m
        self.n_buckets = n_buckets
        self.slots = slots
        self.seed = seed
        self.nonfinite = check_nonfinite_policy(nonfinite)
        if head_h < 0:
            raise ValueError(f"need head_h >= 0, got {head_h}")
        self.head_h = int(head_h)
        self.dp = dp.validate() if dp is not None else None
        # release randomness is secret curator state: OS entropy unless a
        # test injects a generator; never derived from the public seed
        self._dp_rng = dp_rng
        self.accountant = PrivacyAccountant(epsilon_budget=privacy_budget)
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
        # the cached private release of rows [0, D), or None
        self._private_release = None
        self._release_count = 0

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
            self._private_release = None  # the next release pays anew
            if obs.enabled():
                obs.quality_monitor().observe_ingest(self._tau[d],
                                                     self._dropped[d])

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
            self._private_release = None
            if obs.enabled():
                obs.quality_monitor().observe_ingest(
                    self._tau[d0:d0 + D], self._dropped[d0:d0 + D])

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
        self._private_release = None

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
        vector: one launch of the query kernel (``plain``, ``bias_aware``)
        or the private release (``private``; class docstring).  Returns
        ``[(name, estimate)]`` in index order, or the ``top_k`` largest,
        descending (ties by ascending index)."""
        if mode not in QUERY_MODES:
            raise ValueError(f"unknown mode {mode!r}; expected "
                             "'plain'|'bias_aware'|'private'")
        if not self._names:
            raise ValueError("query on an empty index: add vectors before "
                             "querying")
        with obs.op("serve.index.query") as sp:
            sp.set("rows", len(self._names))
            sp.set("mode", mode)
            vector = check_vector(vector, "query vector", dim=self._dim,
                                  nonfinite=self.nonfinite)
            if mode == "private":
                est = self._query_private(vector)
            else:
                sq = priority_sketch(torch.as_tensor(vector,
                                                     device=self.device),
                                     self.m, self.seed)
                q = bucketize(sq, n_buckets=self.n_buckets, slots=self.slots)
                est = _host(query_corpus(q, self._corpus())).astype(
                    np.float64)[: len(self._names)]
                if mode == "bias_aware":
                    est = est + self._bias_aware_correction(
                        _host(q.idx), float(sq.tau), vector)
            if top_k is None:
                return list(zip(self._names, est.tolist()))
            order = _top_k_desc(est, top_k)
            return [(self._names[i], float(est[i])) for i in order]

    def _bias_aware_correction(self, q_idx: np.ndarray, tau_q: float,
                               vector: np.ndarray) -> np.ndarray:
        """Exact-head correction: per row, subtract the query kernel's
        sampled Horvitz-Thompson term of the row's head coordinates (there
        only when a coordinate is kept in both bucketized layouts) and add
        their exact product with the known query.  Unbiased for any
        ``head_h``: the kernel's terms of the other coordinates stay."""
        D = len(self._names)
        if self.head_h == 0:
            return np.zeros(D)
        hi = self._head_idx[:D]
        valid = hi >= 0
        hic = np.where(valid, hi, 0)
        hv = self._head_val[:D].astype(np.float64)
        qv = np.where(valid, np.asarray(vector, np.float64)[hic], 0.0)
        exact = hv * qv
        # the kernel matched a head coordinate only if both layouts keep
        # it (a coordinate's bucket depends on the coordinate alone)
        q_idx = q_idx.ravel()
        kept_q = np.isin(hic, q_idx[q_idx != INVALID_IDX]) & valid
        kept = kept_q & self._head_kept[:D]
        wq, wr = qv * qv, hv * hv
        tau_r = self._tau[:D, None].astype(np.float64)
        with np.errstate(over="ignore", invalid="ignore"):
            p_q = np.where(wq > 0, np.minimum(1.0, tau_q * wq), 1.0)
            p_r = np.where(wr > 0, np.minimum(1.0, tau_r * wr), 1.0)
        p_min = np.minimum(p_q, p_r)
        sampled = np.where(kept & (exact != 0),
                           exact / np.where(p_min > 0, p_min, 1.0), 0.0)
        if obs.enabled():
            n_valid = int(valid.sum())
            obs.gauge("repro_biasaware_head_fraction",
                      "fraction of head entries the plain sketch kept").set(
                          float(kept[valid].mean()) if n_valid else 0.0)
        return (exact - sampled).sum(axis=1)

    def _ensure_private_release(self):
        """The cached DP release of the whole corpus: one accountant
        charge per release epoch (rows are disjoint records: parallel
        composition), dropped by any change to the corpus.  Strict: raises
        ``PrivacyBudgetExceeded`` before releasing anything when the budget
        would be overdrawn."""
        if self.dp is None:
            raise ValueError("private mode needs the index constructed "
                             "with dp=DPParams(...)")
        if self._private_release is None:
            D = len(self._names)
            flat_idx = self._idx[:D].reshape(D, -1)
            flat_val = self._val[:D].reshape(D, -1)
            # compact the (B, S) blocks to m slots: valid coordinates sort
            # ahead of the INVALID sentinel (int32 max), a row keeps <= m
            order = np.argsort(flat_idx, axis=1, kind="stable")
            idx_c = np.take_along_axis(flat_idx, order, axis=1)[:, : self.m]
            val_c = np.take_along_axis(flat_val, order, axis=1)[:, : self.m]
            self._release_count += 1
            rng = (self._dp_rng if self._dp_rng is not None
                   else np.random.default_rng())   # OS entropy, unseeded
            self._private_release = private_release_corpus(
                idx_c, val_c, self._tau[:D], self._dim, self.dp, rng=rng,
                accountant=self.accountant,
                label=f"index-release-{self._release_count}")
        return self._private_release

    def _query_private(self, vector: np.ndarray) -> np.ndarray:
        est = np.asarray(estimate_private_dense(
            self._ensure_private_release(), vector))
        if obs.enabled():
            obs.gauge("repro_dp_epsilon_spent",
                      "cumulative epsilon charged on this index's "
                      "accountant").set(self.accountant.spent_epsilon)
        return est

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
        to a full bucket cannot re-enter the union.  A merged release
        would reveal both inputs, so the peer's privacy ledger is charged
        here first (strict: raises before anything changes)."""
        if (other.m, other.n_buckets, other.slots, other.seed) != \
                (self.m, self.n_buckets, self.slots, self.seed):
            raise ValueError("indexes must share m/n_buckets/slots/seed "
                             "to merge")
        if other._names != self._names:
            raise ValueError("row names must align for a partition merge")
        D = len(self._names)
        if D == 0:
            return
        self.accountant.merge_from(other.accountant)
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
            self._private_release = None


class MatrixSketchStore:
    """Library of matrix sketches answering ``A^T B`` estimates
    (DESIGN.md §15 of the reference).

    Matrices (n, d) with a shared column count ``dim`` are row-sampled
    once on ingestion (``m`` rows each, the linear-time priority builder
    on ``device``) and stored in pre-allocated host blocks, (capacity, m)
    ids and (capacity, m, dim) rows: amortized O(m d) per ``add``, with
    capacity doubling like :class:`SketchIndex`.  Reads:

    - ``product(a, b)``: one stored-vs-stored estimate (the sorted join);
    - ``products(pairs)``: a batch of stored pairs (on the card: both
      sides bucketized and one launch of the matrix-product kernel; on the
      CPU the batched sorted join);
    - ``query(matrix)``: one query matrix against every stored sketch.  On
      the card the query sketch is bucketized once and one kernel launch
      reads it in place for every stored sketch; the bucketized library
      and its slot probabilities are built lazily, once per change.

    On the card the layout is the kernels' default, 512 buckets x 4
    slots; ``device`` defaults to ``cuda`` (``"cpu"`` runs the plain
    versions).  All matrices share ``dim`` and the coordination ``seed``.
    """

    def __init__(self, m: int = 128, *, dim: int, seed: int = 11,
                 initial_capacity: int = 8, nonfinite: str = "raise",
                 device=None):
        if dim < 1:
            raise ValueError("dim must be >= 1")
        self.device = resolve_device(device)
        self.m = m
        self.dim = dim
        self.seed = seed
        self.nonfinite = check_nonfinite_policy(nonfinite)
        self._name_set: set = set()
        self._names: list = []
        self._cap = round_up_pow2(initial_capacity)
        self._idx = np.full((self._cap, m), INVALID_IDX, np.int32)
        self._rows = np.zeros((self._cap, m, dim), np.float32)
        # padding sketches get tau = 1: all-INVALID ids match nothing
        self._tau = np.ones((self._cap,), np.float32)
        self._device: Optional[MatrixSketch] = None
        self._device_buckets = None   # (BucketizedMatrixSketch, slot probs)

    def __len__(self):
        return len(self._names)

    @property
    def capacity(self) -> int:
        return self._cap

    def _grow(self) -> None:
        new_cap = self._cap * 2

        def extend(arr, fill):
            out = np.full((new_cap,) + arr.shape[1:], fill, arr.dtype)
            out[: self._cap] = arr
            return out

        self._idx = extend(self._idx, INVALID_IDX)
        self._rows = extend(self._rows, 0)
        self._tau = extend(self._tau, 1)
        self._cap = new_cap

    def _invalidate(self) -> None:
        self._device = None
        self._device_buckets = None

    def _sketch(self, matrix: np.ndarray) -> MatrixSketch:
        matrix = np.asarray(matrix, np.float32)
        if matrix.ndim != 2 or matrix.shape[1] != self.dim:
            raise ValueError(f"expected an (n, {self.dim}) matrix, got "
                             f"shape {matrix.shape}")
        matrix = check_finite(matrix, "matrix", nonfinite=self.nonfinite)
        return priority_matrix_sketch(
            torch.as_tensor(matrix, device=self.device), self.m, self.seed)

    def add(self, name, matrix: np.ndarray) -> None:
        """Row-sample one (n, dim) matrix and append its sketch in place:
        amortized O(m d) host writes, no re-layout of the stored ones."""
        check_unique_name(name, self._name_set, what="store")
        with obs.op("serve.store.add"):
            sk = self._sketch(matrix)
            if len(self._names) == self._cap:
                self._grow()
            c = len(self._names)
            self._idx[c] = _host(sk.row_idx)
            self._rows[c] = _host(sk.rows)
            self._tau[c] = float(sk.tau)
            self._names.append(name)
            self._name_set.add(name)
            self._invalidate()   # re-upload (not re-sketch) lazily

    def _rollback_last(self, k: int) -> None:
        """Undo the last ``k`` appended sketches, restoring padding state
        (INVALID ids, zero rows, tau = 1)."""
        for _ in range(k):
            name = self._names.pop()
            self._name_set.discard(name)
            c = len(self._names)
            self._idx[c] = INVALID_IDX
            self._rows[c] = 0
            self._tau[c] = 1
        self._invalidate()

    def _corpus(self) -> MatrixSketch:
        """Occupied prefix on the device, rounded up to a power of two (at
        least 4), so its shape changes only on doublings."""
        if self._device is None:
            c = min(self._cap, max(round_up_pow2(max(len(self._names), 1)),
                                   4))
            self._device = self._stored(slice(0, c))
        return self._device

    def _buckets(self):
        """The bucketized library and its slot probabilities (built once
        per change)."""
        if self._device_buckets is None:
            bc = bucketize_matrix_sketches(self._corpus())
            self._device_buckets = (bc, matrix_slot_probs(bc))
        return self._device_buckets

    def _pick(self, name) -> int:
        try:
            return self._names.index(name)
        except ValueError:
            raise KeyError(f"unknown matrix {name!r}") from None

    def _stored(self, rows) -> MatrixSketch:
        dev = self.device
        return MatrixSketch(torch.tensor(self._idx[rows], device=dev),
                            torch.tensor(self._rows[rows], device=dev),
                            torch.tensor(self._tau[rows], device=dev))

    def product(self, name_a, name_b) -> np.ndarray:
        """(dim, dim) estimate of ``A^T B`` for two stored matrices."""
        ia, ib = self._pick(name_a), self._pick(name_b)
        return _host(estimate_matrix_product(self._stored(ia),
                                             self._stored(ib)))

    def products(self, pairs: Sequence) -> np.ndarray:
        """(len(pairs), dim, dim) estimates for a batch of stored-name
        pairs, in one kernel launch on the card."""
        ia = np.array([self._pick(a) for a, _ in pairs], np.int64)
        ib = np.array([self._pick(b) for _, b in pairs], np.int64)
        with obs.op("serve.store.products") as sp:
            sp.set("pairs", len(pairs))
            return _host(estimate_matrix_products(self._stored(ia),
                                                  self._stored(ib)))

    def query(self, matrix: np.ndarray) -> list:
        """Estimate ``Q^T A_c`` against every stored matrix; returns
        ``[(name, (dim, dim) ndarray), ...]`` in insertion order."""
        if not self._names:
            raise ValueError("query on an empty store: add matrices before "
                             "querying")
        with obs.op("serve.store.query") as sp:
            sp.set("rows", len(self._names))
            sq = self._sketch(matrix)
            if self.device.type == "cuda":
                bc, pc = self._buckets()
                q = bucketize_matrix_sketches(sq)
                obs.kernel_launch("matrix_sketch.products")
                est = matrix_products(q.idx, q.rows, matrix_slot_probs(q),
                                      bc.idx, bc.rows, pc)
            else:
                # the sorted join with the query held fixed (no copies)
                est = estimate_matrix_product(sq, self._corpus())
            est = _host(est)
        return [(name, est[i]) for i, name in enumerate(self._names)]
