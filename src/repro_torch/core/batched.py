"""Batched sketching and estimation: every row of a (D, n) block with one
shared seed — the coordination that makes the rows' samples join
(Section 2 of the paper) — and every pair's estimate.

``backend="reference"`` runs the single-vector sort/top-k builders row by
row (the parity oracle); ``backend="kernel"`` runs the batched linear-time
build of ``repro_torch.kernels.sketch_build`` (one hash/rank pass for the
block, histogram selection instead of per-row sorts, a prefix-sum pack).
Kept sets and values are identical; threshold tau can differ by the
rounding of its sums.  :func:`estimate_all_pairs` likewise runs the
per-pair searchsorted join (``"reference"``) or the bucketized all-pairs
kernel (``"kernel"``).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from .estimator import estimate_inner_product
from .priority import priority_sketch
from .sketches import Sketch
from .threshold import threshold_sketch


def sketch_corpus(A, m: int, seed, *, method: str = "priority",
                  variant: str = "l2", backend: str = "reference",
                  device=None) -> Sketch:
    """Sketch every row of A: (D, n) -> Sketch with leading batch dim D,
    ``method`` ``"priority"`` (Algorithm 3) or ``"threshold"``
    (Algorithms 1+4).  Runs on ``device`` (default ``cuda``)."""
    if method not in ("priority", "threshold"):
        raise ValueError(f"unknown method {method!r}")
    dev = resolve_device(device)
    A = torch.atleast_2d(torch.as_tensor(A, dtype=torch.float32, device=dev))
    if backend == "kernel":
        from repro_torch.kernels.sketch_build import (build_priority_corpus,
                                                      build_threshold_corpus)
        build = (build_priority_corpus if method == "priority"
                 else build_threshold_corpus)
        return build(A, m, seed, variant=variant, device=dev)
    if backend != "reference":
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'reference' or 'kernel'")
    fn = priority_sketch if method == "priority" else threshold_sketch
    rows = [fn(a, m, seed, variant=variant) for a in A]
    return Sketch(torch.stack([s.idx for s in rows]),
                  torch.stack([s.val for s in rows]),
                  torch.stack([s.tau for s in rows]))


# (pair, slot) elements a per-pair join holds at once
_PAIR_CHUNK_ELEMS = 1 << 22


def _every_pair(SA, SB, fn) -> dict:
    """``fn`` on every (row of SA, row of SB) pair, SA's rows in chunks.

    SA and SB are NamedTuples of (D1, ...) and (D2, ...) tensors; ``fn``
    takes two NamedTuples of row-aligned pairs, fields (r D2, ...), and
    returns a dict of (r D2,) tensors.  -> that dict with (D1, D2)
    values."""
    D1, D2, cap = SA[0].shape[0], SB[0].shape[0], SA[0].shape[-1]
    step = max(1, _PAIR_CHUNK_ELEMS // max(D2 * cap, 1))
    parts = []
    for lo in range(0, D1, step):
        r = min(step, D1 - lo)

        def pair(f):        # (r, 1, ...) or (1, D2, ...) -> (r D2, ...)
            return f.expand(r, D2, *f.shape[2:]).reshape(r * D2,
                                                         *f.shape[2:])

        out = fn(type(SA)(*(pair(f[lo:lo + r, None]) for f in SA)),
                 type(SB)(*(pair(f[None]) for f in SB)))
        parts.append({k: v.reshape(r, D2) for k, v in out.items()})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def estimate_all_pairs(SA: Sketch, SB: Sketch, *, variant: str = "l2",
                       backend: str = "reference", n_buckets: int = 512,
                       slots: int = 4) -> torch.Tensor:
    """(D1, cap) x (D2, cap) sketches -> (D1, D2) inner-product estimates.

    ``backend="reference"`` runs the exact per-pair searchsorted join
    (chunked over SA's rows); ``backend="kernel"`` re-lays both corpora
    into ``(n_buckets, slots)`` buckets and runs the all-pairs kernel (B5)
    — the same up to bucket-overflow drops, which are rare for
    ``n_buckets >= cap``.  Runs on the sketches' device."""
    if backend == "kernel":
        from repro_torch.kernels.intersect_estimate import (
            bucketize_corpus, estimate_all_pairs_bucketized)
        BA = bucketize_corpus(SA, n_buckets=n_buckets, slots=slots)
        BB = BA if SB is SA else bucketize_corpus(SB, n_buckets=n_buckets,
                                                  slots=slots)
        return estimate_all_pairs_bucketized(BA, BB, variant=variant)
    if backend != "reference":
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'reference' or 'kernel'")
    def est(a: Sketch, b: Sketch) -> dict:
        return {"est": estimate_inner_product(
            Sketch(a.idx, a.val, a.tau[:, None]),
            Sketch(b.idx, b.val, b.tau[:, None]), variant=variant)}

    return _every_pair(SA, SB, est)["est"]


def estimate_query(sq: Sketch, SB: Sketch, *, variant: str = "l2"
                   ) -> torch.Tensor:
    """One query sketch vs a (D, cap) corpus: (D,) estimates."""
    D = SB.idx.shape[0]
    sa = Sketch(sq.idx.expand(D, -1).contiguous(),
                sq.val.expand(D, -1).contiguous(),
                torch.as_tensor(sq.tau, dtype=torch.float32,
                                device=sq.idx.device).reshape(1, 1))
    return estimate_inner_product(sa, Sketch(SB.idx, SB.val,
                                             SB.tau.reshape(D, 1)),
                                  variant=variant)
