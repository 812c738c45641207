"""Table store for the paper's data-discovery workloads
(``repro.data.tables``).

Columns are (keys, values) pairs; keys hash into a shared index universe,
so any two columns become sparse vectors over the same coordinates — the
reduction of Section 4 (Figure 2).  Repeated keys pre-aggregate by sum
(the paper's World Bank preprocessing, Section 5.3.1).

``SketchedTableStore`` sketches every column once and answers
inner-product, join-size and join-correlation queries from the sketches
alone, with the reference's sketches: ``priority_sketch`` for the values
and the key counts (on the linear-time build, whose kept sets and tau are
the reference route's bit for bit) and the legacy
``combined_priority_sketch`` for correlation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import (CombinedSketch, combined_priority_sketch,
                              estimate_inner_product,
                              estimate_join_correlation, priority_sketch)
from repro_torch.device import resolve_device


def _hash_keys(keys: np.ndarray, universe: int) -> np.ndarray:
    """64-bit splitmix-style hash of integer keys -> [0, universe)."""
    x = keys.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(universe)).astype(np.int64)


def column_to_vector(keys: np.ndarray, values: np.ndarray, universe: int,
                     *, aggregate: str = "sum") -> np.ndarray:
    """(keys, values) -> dense float32 vector over the hashed key universe
    (``aggregate`` ``"sum"`` of the values or ``"count"`` of the keys)."""
    idx = _hash_keys(np.asarray(keys), universe)
    v = np.zeros(universe, np.float32)
    if aggregate == "sum":
        np.add.at(v, idx, np.asarray(values, np.float32))
    elif aggregate == "count":
        np.add.at(v, idx, 1.0)
    else:
        raise ValueError(aggregate)
    return v


class SketchedTableStore:
    """Columns sketched once; queries answered from the sketches.  Sketches
    live on ``device`` (default ``cuda``)."""

    def __init__(self, universe: int = 1 << 20, m: int = 400, seed: int = 7,
                 *, device=None):
        self.universe = universe
        self.m = m
        self.seed = seed
        self.device = resolve_device(device)
        self._ip: dict = {}
        self._corr: dict = {}
        self._freq: dict = {}
        self._stacked = None   # (names, CombinedSketch (C, m)) for scans

    # -- ingestion ---------------------------------------------------------
    def _vector(self, keys, values, aggregate: str) -> torch.Tensor:
        return torch.as_tensor(column_to_vector(keys, values, self.universe,
                                                aggregate=aggregate),
                               device=self.device)

    def add_column(self, name: str, keys, values) -> None:
        vec = self._vector(keys, values, "sum")
        self._ip[name] = priority_sketch(vec, self.m, self.seed,
                                         backend="kernel")
        self._corr[name] = combined_priority_sketch(vec, self.m, self.seed)
        self._freq[name] = priority_sketch(
            self._vector(keys, values, "count"), self.m, self.seed,
            backend="kernel")
        self._stacked = None

    def columns(self) -> list:
        return sorted(self._ip)

    # -- queries (sketch-only) ----------------------------------------------
    def inner_product(self, a: str, b: str) -> float:
        return float(estimate_inner_product(self._ip[a], self._ip[b]))

    def join_size(self, a: str, b: str) -> float:
        """<freq_a, freq_b>: the join size (the standard reduction [23])."""
        return float(estimate_inner_product(self._freq[a], self._freq[b]))

    def join_correlation(self, a: str, b: str) -> float:
        return float(estimate_join_correlation(self._corr[a], self._corr[b]))

    def _all_corr(self):
        if self._stacked is None:
            names = self.columns()
            self._stacked = (names, CombinedSketch(*(
                torch.stack(f) for f in zip(*(self._corr[c]
                                              for c in names)))))
        return self._stacked

    def top_correlated(self, query: str, k: int = 5) -> list:
        """The k columns with the largest |estimated join correlation| with
        ``query``, as (name, score) pairs.  Every column is scored in one
        batched estimate (each score is ``join_correlation(query, name)``
        up to float32 summation order); ties keep the sorted names' order,
        as the reference's stable sort does."""
        names, S = self._all_corr()
        q = self._corr[query]
        C = len(names)
        sq = CombinedSketch(q.idx.expand(C, -1), q.val.expand(C, -1),
                            *(t.expand(C) for t in q[2:]))
        scores = estimate_join_correlation(sq, S).cpu().tolist()
        pairs = [(c, s) for c, s in zip(names, scores) if c != query]
        return sorted(pairs, key=lambda t: -abs(t[1]))[:k]
