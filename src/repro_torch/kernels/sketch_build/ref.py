"""Plain PyTorch versions of the sketch_build kernels, and the build oracle.

``hash_rank_hist_ref`` computes what the hash/rank/histogram kernel
computes and ``kth_smallest_ranks_ref`` (the four-level descent over
``rank_hist_ref``, one 8-bit histogram level each) what the radix select
kernel computes, on any device; the wrappers in ``sketch_build.py`` use
them for CPU tensors, and the tests and ``chip_smoke.py`` compare the
kernels with them.  ``build_priority_corpus_ref`` runs the single-vector reference
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


def kth_smallest_ranks_ref(keys: torch.Tensor, k, *,
                           hist0: torch.Tensor | None = None) -> torch.Tensor:
    """Exact per-row k-th smallest of (D, n) nonnegative float32 keys by
    the four-level descent: at shifts 24, 16, 8, 0 count the next byte
    under the prefix found so far (:func:`rank_hist_ref`; level 0 is
    ``hist0`` when given), take the first bin whose running count reaches
    k, rebase k.  ``k``: int or (D,) tensor, 1 <= k <= n.  -> (D,)
    float32."""
    D = keys.shape[0]
    dev = keys.device
    keys = keys.contiguous()
    remaining = torch.broadcast_to(
        torch.as_tensor(k, dtype=torch.int64, device=dev), (D,)).clone()
    prefix = torch.zeros((D,), dtype=torch.int64, device=dev)
    for shift in (24, 16, 8, 0):
        if shift == 24 and hist0 is not None:
            hist = hist0
        else:
            hist = rank_hist_ref(keys, prefix.to(torch.int32), shift=shift)
        csum = torch.cumsum(hist.to(torch.int64), dim=1)
        # first bin whose running count reaches the remaining rank
        d_star = (csum < remaining[:, None]).sum(dim=1)
        below = torch.gather(csum, 1, (d_star - 1).clamp(min=0)[:, None])[:, 0]
        remaining = remaining - torch.where(d_star > 0, below,
                                            torch.zeros_like(below))
        prefix = (prefix << 8) | d_star
    # ranks are nonnegative: the sign bit is 0 and the pattern fits int32
    return prefix.to(torch.int32).view(torch.float32)


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
