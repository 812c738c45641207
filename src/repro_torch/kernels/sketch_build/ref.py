"""Plain PyTorch versions of the sketch_build kernels, and the build oracle.

``hash_rank_hist_ref`` and ``rank_hist_ref`` compute what the CUDA kernels
compute, on any device; the wrappers in ``sketch_build.py`` use them for
CPU tensors, and the tests and ``chip_smoke.py`` compare the kernels with
them.  ``build_priority_corpus_ref`` runs the single-vector reference
``priority_sketch`` and ``build_threshold_corpus_ref`` the reference
``threshold_sketch`` (full sorts) row by row: the oracles for the
linear-time builds.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import hash_unit
from repro_torch.core.priority import priority_sketch
from repro_torch.core.sketches import Sketch, sampling_ranks, weight
from repro_torch.core.threshold import threshold_sketch

NBINS = 256


def _row_hist(digits: torch.Tensor, active: torch.Tensor | None = None
              ) -> torch.Tensor:
    """(D, n) int64 digits in [0, NBINS) -> (D, NBINS) int32 counts."""
    D = digits.shape[0]
    ones = (torch.ones_like(digits, dtype=torch.int32) if active is None
            else active.to(torch.int32))
    hist = torch.zeros((D, NBINS), dtype=torch.int32, device=digits.device)
    return hist.scatter_add_(1, digits, ones)


def _bits(keys: torch.Tensor) -> torch.Tensor:
    """Bit patterns of nonnegative float32 keys, as int64."""
    return keys.contiguous().view(torch.int32).to(torch.int64)


def hash_rank_hist_ref(values: torch.Tensor, seed, *, variant: str = "l2"):
    """(D, n) f32 -> (h (n,), rank (D, n), hist (D, 256) int32)."""
    n = values.shape[-1]
    h = hash_unit(seed, torch.arange(n, dtype=torch.int32,
                                     device=values.device))
    rank = sampling_ranks(weight(values.to(torch.float32), variant), h[None])
    return h, rank, _row_hist(_bits(rank) >> 24)


def rank_hist_ref(keys: torch.Tensor, prefix: torch.Tensor, *,
                  shift: int) -> torch.Tensor:
    """Counts of ``(bits >> shift) & 0xFF`` over the keys of each row whose
    bits above ``shift + 8`` equal ``prefix[row]`` -> (D, 256) int32."""
    u = _bits(keys)
    digits = (u >> shift) & 0xFF
    active = None
    if shift < 24:
        active = (u >> (shift + 8)) == prefix.to(torch.int64)[:, None]
    return _row_hist(digits, active)


def build_priority_corpus_ref(A: torch.Tensor, m: int, seed, *,
                              variant: str = "l2") -> Sketch:
    """Row-by-row reference priority sketches of a (D, n) block."""
    A = torch.atleast_2d(A.to(torch.float32))
    rows = [priority_sketch(a, m, seed, variant=variant) for a in A]
    return Sketch(torch.stack([s.idx for s in rows]),
                  torch.stack([s.val for s in rows]),
                  torch.stack([s.tau for s in rows]))


def build_threshold_corpus_ref(A: torch.Tensor, m: int, seed, *,
                               variant: str = "l2", cap: int | None = None,
                               adaptive: bool = True) -> Sketch:
    """Row-by-row reference threshold sketches of a (D, n) block."""
    A = torch.atleast_2d(A.to(torch.float32))
    rows = [threshold_sketch(a, m, seed, variant=variant, cap=cap,
                             adaptive=adaptive) for a in A]
    return Sketch(torch.stack([s.idx for s in rows]),
                  torch.stack([s.val for s in rows]),
                  torch.stack([s.tau for s in rows]))
