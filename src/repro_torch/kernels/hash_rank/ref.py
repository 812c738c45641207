"""Plain PyTorch versions of the hash_rank kernels.

The same function as ``csrc/sketch_build.cu``'s ``hash_rank_kernel``
without its histogram: the wrappers in ``hash_rank.py`` use them for CPU
tensors, and the tests and ``chip_smoke.py`` compare the kernels with
them.  They are built from ``core.hashing`` and ``core.sketches``, so a
kernel-built sketch stays coordinated with a host-built one.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import hash_unit
from repro_torch.core.sketches import sampling_ranks, weight


def hash_rank_ref(values: torch.Tensor, seed, *, variant: str = "l2"):
    """(n,) float32 -> (h (n,), rank (n,))."""
    h, rank = hash_rank_batched_ref(values[None], seed, variant=variant)
    return h, rank[0]


def hash_rank_batched_ref(values: torch.Tensor, seed, *,
                          variant: str = "l2"):
    """(D, n) float32 -> (h (n,), rank (D, n)).  The hash depends only on
    the coordinate, so it is computed once for all D rows."""
    n = values.shape[-1]
    h = hash_unit(seed, torch.arange(n, dtype=torch.int32,
                                     device=values.device))
    return h, sampling_ranks(weight(values.to(torch.float32), variant),
                             h[None, :])
