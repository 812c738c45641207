"""Sketch container and the shared sampling-rank transform.

A sketch is a fixed-capacity NamedTuple of tensors, as in
``repro.core.sketches``:

- ``idx``: int32[..., cap], sorted ascending, ``INVALID_IDX`` padding;
- ``val``: float32[..., cap], 0 at padding;
- ``tau``: float32[...] inclusion scale; entry ``i`` is kept with
  probability ``min(1, tau * w_i)``.

**Flush to zero.**  The reference runs under XLA, which flushes float32
subnormals to zero (outputs) and reads subnormal inputs as zero in
comparisons.  PyTorch and CUDA keep subnormals.  The kept set depends on
both, so the port flushes explicitly: a subnormal weight is 0 (its rank is
+inf and it is never kept), and a subnormal rank (a huge weight) is 0.
Without this, values with ``|v| < ~1.1e-19`` or ``|v| > ~1e18`` give a
different kept set than the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

INVALID_IDX = int(np.iinfo(np.int32).max)
FLT_MIN = float(np.finfo(np.float32).tiny)   # smallest normal float32

VARIANTS = ("l2", "l1", "uniform")


class Sketch(NamedTuple):
    """Single-vector inner-product sketch (Algorithms 1 and 3)."""

    idx: torch.Tensor   # int32[..., cap], sorted ascending, INVALID padding
    val: torch.Tensor   # float32[..., cap]
    tau: torch.Tensor   # float32[...] inclusion scale

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]

    def size(self) -> torch.Tensor:
        """Number of valid (non-padding) entries."""
        return (self.idx != INVALID_IDX).sum(dim=-1)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """Zero every float32 subnormal (XLA's flush-to-zero, made explicit)."""
    return torch.where(x.abs() < FLT_MIN, torch.zeros_like(x), x)


def weight(val: torch.Tensor, variant: str) -> torch.Tensor:
    """Sampling weight: l2 -> a^2, l1 -> |a|, uniform -> 1[a != 0],
    with subnormal inputs and weights flushed to 0."""
    if variant == "l2":
        return flush_subnormal(val * val)
    if variant == "l1":
        return flush_subnormal(val.abs())
    if variant == "uniform":
        return (flush_subnormal(val) != 0).to(val.dtype)
    raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")


def default_capacity(m: int) -> int:
    """Fixed capacity for threshold sampling: m + 4*ceil(sqrt(m))."""
    return int(m + 4 * math.ceil(math.sqrt(max(m, 1))))


def sampling_ranks(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Sampling rank ``R_i = h_i / w_i`` (+inf where ``w_i == 0``; a
    subnormal rank flushes to 0).  ``w`` must come from :func:`weight`."""
    pos = w > 0
    r = h / torch.where(pos, w, torch.ones_like(w))
    r = torch.where(pos, r, torch.full_like(r, math.inf))
    return flush_subnormal(r)


def select_and_pack(scores: torch.Tensor, include: torch.Tensor,
                    idx: torch.Tensor, val: torch.Tensor,
                    cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep included entries (lowest ``scores`` first, equal scores by
    lowest position, as ``lax.top_k`` orders them) up to ``cap``; sort by
    idx.  All inputs are (..., n); returns (idx (..., cap) ascending with
    INVALID padding, val (..., cap) with 0 padding)."""
    n = scores.shape[-1]
    key = torch.where(include, scores, torch.full_like(scores, math.inf))
    idx = idx.to(torch.int32)
    val = val.to(torch.float32)
    if cap >= n:
        pad = (0, cap - n)
        kidx = F.pad(idx, pad, value=INVALID_IDX)
        kval = F.pad(val, pad)
        kinc = F.pad(include.to(torch.int8), pad).to(torch.bool)
    else:
        pos = torch.sort(key, dim=-1, stable=True).indices[..., :cap]
        kidx = torch.gather(idx, -1, pos)
        kval = torch.gather(val, -1, pos)
        kinc = torch.gather(include, -1, pos)
    kidx = torch.where(kinc, kidx, torch.full_like(kidx, INVALID_IDX))
    kval = torch.where(kinc, kval, torch.zeros_like(kval))
    order = torch.argsort(kidx, dim=-1, stable=True)
    return torch.gather(kidx, -1, order), torch.gather(kval, -1, order)


def densify(sketch: Sketch, n: int) -> torch.Tensor:
    """Scatter a sketch back to a dense length-n unbiased estimate of its
    vector: entry i gets ``val_i / p_i`` with ``p_i = min(1, tau w_i)``
    (l2).  Used by gradient compression (DESIGN.md §3.1 of the
    reference)."""
    w = weight(sketch.val, "l2")
    p = torch.clamp(torch.as_tensor(sketch.tau, dtype=torch.float32) * w,
                    max=1.0)
    valid = sketch.idx != INVALID_IDX
    scale = torch.where(valid & (p > 0),
                        sketch.val / torch.where(p > 0, p, torch.ones_like(p)),
                        torch.zeros_like(p))
    safe_idx = torch.where(valid, sketch.idx, 0).to(torch.int64)
    out = torch.zeros((n,), dtype=torch.float32, device=sketch.val.device)
    return out.index_add_(0, safe_idx, scale)
