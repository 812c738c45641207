"""Payload-generic sketch containers (DESIGN.md §18 of the reference).

- ``PayloadSketch``: ``idx`` int32 (..., cap) sorted ascending with
  ``INVALID_IDX`` padding, ``payload`` float32 (..., cap, d) with zero rows
  at padding, ``tau`` float32 (...).  ``d = 1`` is a vector sketch.
- ``BucketizedPayloads``: the (P, B, S, d) bucketized layout.

``payload_weight`` is the per-entry sampling weight: at d = 1 it equals
``core.sketches.weight`` bit for bit (subnormals flushed the same way);
at d > 1 its sums are written out in the order the reference's build
computes them (see :func:`payload_weight`), so sketches built by either
package carry the same ranks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.sketches import (INVALID_IDX, Sketch,
                                       default_capacity, flush_subnormal)

PAYLOAD_VARIANTS = ("l2", "l1", "uniform")


class PayloadSketch(NamedTuple):
    idx: torch.Tensor      # int32 (..., cap), sorted ascending, INVALID pad
    payload: torch.Tensor  # float32 (..., cap, d), zero at padding
    tau: torch.Tensor      # float32 (...) inclusion scale

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]

    @property
    def dim(self) -> int:
        return self.payload.shape[-1]

    def size(self) -> torch.Tensor:
        return (self.idx != INVALID_IDX).sum(dim=-1)


class BucketizedPayloads(NamedTuple):
    idx: torch.Tensor      # int32 (P, B, S), INVALID padding
    payload: torch.Tensor  # float32 (P, B, S, d), 0 at padding
    tau: torch.Tensor      # float32 (P,)
    dropped: torch.Tensor  # int32 (P,): entries lost to bucket overflow


_WINDOW = 32        # XLA's CPU tree reduction: windows of 32 elements
_FMA_PLAIN = range(5, 9)   # row widths whose products XLA rounds first


def _fma_sq(x2: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(x, x, acc)`` with one rounding, on any device, from
    ``x2 = x * x`` in float64 (exact: a float32 square has 48 bits).

    The float64 sum is rounded to odd (TwoSum gives its error; an inexact
    sum with an even last bit moves one step toward the error), so the
    final rounding to float32 is the correctly rounded fused result, with
    no double-rounding case."""
    a = acc.to(torch.float64)
    s = a + x2
    bb = s - a
    err = (a - (s - bb)) + (x2 - bb)
    # an inexact sum (err is NaN once the sum overflows: no fix then)
    fix = (err.abs() > 0) & ((s.view(torch.int64) & 1) == 0)
    # err * inf is +-inf where err != 0, the only lanes ``fix`` takes
    return torch.where(fix, torch.nextafter(s, err * torch.inf),
                       s).to(torch.float32)


def _seq_sum(terms: torch.Tensor, square: bool, fused: bool) -> torch.Tensor:
    """Left-to-right float32 sum over the last axis from 0, with XLA's
    flush-to-zero (a subnormal input reads as 0, a subnormal result is
    0).  ``square`` sums ``x * x``: ``fused`` as ``fma(x, x, acc)``, else
    the rounded product added."""
    terms = flush_subnormal(terms)
    if square and fused:
        terms = terms.to(torch.float64) ** 2
    elif square:
        terms = flush_subnormal(terms * terms)
    acc = torch.zeros(terms.shape[:-1], dtype=torch.float32,
                      device=terms.device)
    for k in range(terms.shape[-1]):
        if square and fused:
            acc = _fma_sq(terms[..., k], acc)
        else:
            acc = acc + terms[..., k]
        acc = flush_subnormal(acc)
    return acc


def _xla_row_sum(terms: torch.Tensor, square: bool) -> torch.Tensor:
    """Sum (of squares) over the last axis in the order of the
    reference's jitted ``jnp.sum`` on the CPU.  Up to 32 elements: one
    left-to-right pass, the multiply fused into each add except at widths
    5-8 (XLA vectorises those products and rounds them first).  Beyond
    32: the products are rounded, the row is zero-padded to windows of 32
    (the shorter half of the padding in front), each window summed left
    to right, and the window totals summed the same way."""
    d = terms.shape[-1]
    if d <= _WINDOW:
        return _seq_sum(terms, square, fused=d not in _FMA_PLAIN)
    if square:
        terms = flush_subnormal(flush_subnormal(terms) ** 2)
    nb = -(-d // _WINDOW)
    pad = nb * _WINDOW - d
    blocks = F.pad(terms, (pad // 2, pad - pad // 2)).reshape(
        *terms.shape[:-1], nb, _WINDOW)
    return _xla_row_sum(_seq_sum(blocks, False, False), False)


def payload_weight(payload: torch.Tensor, variant: str) -> torch.Tensor:
    """Sampling weight of each payload row, (..., d) -> (...): squared l2
    norm, l1 norm, or 1 on nonzero rows; subnormals flushed to 0.

    The l2 and l1 sums follow :func:`_xla_row_sum`, the order in which
    the reference's build and merge jits evaluate ``jnp.sum`` with XLA
    on an x86-64 CPU with AVX-512 (held bit for bit at d = 2..40 and up
    to 2100), and give the same bits on the CPU and the card.  The
    reference's eager calls round the products at every d <= 32 and may
    differ by an ulp; its estimators take these weights only under a
    tolerance.  d = 1 keeps the vector weight of ``core.sketches``."""
    if variant == "l2":
        if payload.shape[-1] == 1:
            return flush_subnormal(payload[..., 0] * payload[..., 0])
        return _xla_row_sum(payload.to(torch.float32), square=True)
    if variant == "l1":
        return _xla_row_sum(payload.to(torch.float32).abs(), square=False)
    if variant == "uniform":
        return (flush_subnormal(payload) != 0).any(dim=-1).to(payload.dtype)
    raise ValueError(f"unknown variant {variant!r}; "
                     f"expected one of {PAYLOAD_VARIANTS}")


def payload_capacity(m: int) -> int:
    """Lemma-4 threshold capacity."""
    return default_capacity(m)


def from_vector(s: Sketch) -> PayloadSketch:
    """Vector sketch -> d = 1 payload sketch (no copy: payload =
    ``val[..., None]``)."""
    return PayloadSketch(idx=s.idx, payload=s.val[..., None], tau=s.tau)


def to_vector(s: PayloadSketch) -> Sketch:
    """d = 1 payload sketch -> vector sketch (no copy)."""
    if s.payload.shape[-1] != 1:
        raise ValueError(f"not a vector sketch: payload dim "
                         f"{s.payload.shape[-1]}")
    return Sketch(idx=s.idx, val=s.payload[..., 0], tau=s.tau)


def from_matrix(s) -> PayloadSketch:
    """``matrix.MatrixSketch`` -> payload sketch (no copy)."""
    return PayloadSketch(idx=s.row_idx, payload=s.rows, tau=s.tau)


def to_matrix(s: PayloadSketch):
    """Payload sketch -> ``matrix.MatrixSketch`` (no copy)."""
    from repro_torch.matrix.containers import MatrixSketch
    return MatrixSketch(row_idx=s.idx, rows=s.payload, tau=s.tau)
