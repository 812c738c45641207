"""Batched sketching: every row of a (D, n) block with one shared seed —
the coordination that makes the rows' samples join (Section 2 of the
paper).

``backend="reference"`` runs the single-vector sort/top-k builders row by
row (the parity oracle); ``backend="kernel"`` runs the batched linear-time
build of ``repro_torch.kernels.sketch_build`` (one hash/rank pass for the
block, histogram selection instead of per-row sorts, a prefix-sum pack).
Kept sets and values are identical; threshold tau can differ by the
rounding of its sums.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

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
