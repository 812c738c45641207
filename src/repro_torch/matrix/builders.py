"""Row-sampling matrix sketch builders (DESIGN.md §15, §18 of the
reference).

Both builders are the vector algorithms applied to row weights, i.e. the
d > 1 case of ``engine.build_payload_corpus``: hash the row ids once,
form sampling ranks ``h_i / w_i``, resolve the cutoffs with the
linear-time selection of ``kernels/sketch_build`` and compact with the
prefix-sum pack.  Construction is O(n d) for the row norms plus O(n)
selection.

``backend="fused"`` is the linear-time histogram selection (the CUDA
rank-histogram kernel on the card); ``backend="reference"`` the O(n log n)
sort/top-k formulations kept as the parity oracle (``selector="sort"``).

``row_indices`` passes global row ids for a row partition of a taller
matrix (the map side of ``distributed.partitioned_matrix_sketch``): the
hash is taken of the global ids, which keeps partition samples
coordinated and so mergeable.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from .containers import MATRIX_VARIANTS, MatrixSketch, matrix_capacity

BACKENDS = ("fused", "reference")


def _check_inputs(A: torch.Tensor, variant: str, backend: str) -> None:
    if A.ndim != 2:
        raise ValueError(f"expected an (n, d) matrix, got shape "
                         f"{tuple(A.shape)}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'fused' or 'reference'")
    if variant not in MATRIX_VARIANTS:
        raise ValueError(f"unknown matrix variant {variant!r}; "
                         f"expected one of {MATRIX_VARIANTS}")


def _build(A, m, seed, *, method, variant, cap, adaptive, row_indices,
           backend, device) -> MatrixSketch:
    from repro_torch.engine.build import build_payload_corpus
    if isinstance(A, torch.Tensor) and device is None:
        dev = A.device
    else:
        dev = resolve_device(device)
    A = torch.as_tensor(A, dtype=torch.float32, device=dev)
    _check_inputs(A, variant, backend)
    out = build_payload_corpus(
        A[None], m, seed, method=method, variant=variant, cap=cap,
        adaptive=adaptive, indices=row_indices, device=dev,
        selector="sort" if backend == "reference" else None)
    return MatrixSketch(row_idx=out.idx[0], rows=out.payload[0],
                        tau=out.tau[0])


def priority_matrix_sketch(A, m: int, seed, *, variant: str = "l2",
                           row_indices=None, backend: str = "fused",
                           device=None) -> MatrixSketch:
    """Priority row sampling (Algorithm 3 over rows): exactly
    ``min(m, nonzero rows)`` rows kept; ``tau`` is the exact (m+1)-st
    smallest sampling rank.  Both backends give the same bits.  A tensor
    is sketched on its device; other input on ``device`` (default
    ``cuda``)."""
    return _build(A, m, seed, method="priority", variant=variant, cap=None,
                  adaptive=True, row_indices=row_indices, backend=backend,
                  device=device)


def threshold_matrix_sketch(A, m: int, seed, *, variant: str = "l2",
                            cap: int | None = None, adaptive: bool = True,
                            row_indices=None, backend: str = "fused",
                            device=None) -> MatrixSketch:
    """Threshold row sampling (Algorithms 1+4 over rows): row ``i`` is kept
    iff ``h(i) <= tau * w_i``; ``adaptive=True`` solves ``E[size] ==
    min(m, nonzero rows)``.  The backends keep the same rows; tau differs
    only in summation order.  ``cap`` defaults to ``m + 4 ceil(sqrt(m))``.
    Device as in :func:`priority_matrix_sketch`."""
    return _build(A, m, seed, method="threshold", variant=variant,
                  cap=matrix_capacity(m) if cap is None else cap,
                  adaptive=adaptive, row_indices=row_indices,
                  backend=backend, device=device)
