"""Plain PyTorch version of the CountSketch kernel.

The same function as ``csrc/countsketch.cu``, on the hash streams of
``core.hashing`` (so a table built by the kernel matches one built on the
host): the wrapper in ``countsketch.py`` uses it for CPU tensors, and the
tests and ``chip_smoke.py`` compare the kernel with it.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import hash_bucket, hash_sign


def countsketch_ref(values: torch.Tensor, seed_bucket, seed_sign,
                    m: int) -> torch.Tensor:
    """(n,) -> (m,) float32: ``out[bucket(j)] += sign(j) * values[j]``."""
    n = values.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=values.device)
    bucket = hash_bucket(seed_bucket, idx, m).to(torch.int64)
    sign = hash_sign(seed_sign, idx)
    out = torch.zeros((m,), dtype=torch.float32, device=values.device)
    return out.index_add_(0, bucket, sign * values.to(torch.float32))
