"""Payload-generic sketch containers (DESIGN.md §18 of the reference).

- ``PayloadSketch``: ``idx`` int32 (..., cap) sorted ascending with
  ``INVALID_IDX`` padding, ``payload`` float32 (..., cap, d) with zero rows
  at padding, ``tau`` float32 (...).  ``d = 1`` is a vector sketch.
- ``BucketizedPayloads``: the (P, B, S, d) bucketized layout.

``payload_weight`` is the per-entry sampling weight: at d = 1 it equals
``core.sketches.weight`` bit for bit (subnormals flushed the same way).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sketches import (INVALID_IDX, default_capacity,
                                       flush_subnormal)

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


def payload_weight(payload: torch.Tensor, variant: str) -> torch.Tensor:
    """Sampling weight of each payload row, (..., d) -> (...): squared l2
    norm, l1 norm, or 1 on nonzero rows; subnormals flushed to 0."""
    if variant == "l2":
        return flush_subnormal((payload * payload).sum(dim=-1))
    if variant == "l1":
        return flush_subnormal(payload.abs().sum(dim=-1))
    if variant == "uniform":
        return (flush_subnormal(payload) != 0).any(dim=-1).to(payload.dtype)
    raise ValueError(f"unknown variant {variant!r}; "
                     f"expected one of {PAYLOAD_VARIANTS}")


def payload_capacity(m: int) -> int:
    """Lemma-4 threshold capacity."""
    return default_capacity(m)
