"""Stateless integer hashing shared by every sketching method.

Bit-identical to ``repro.core.hashing``: the same 32-bit finalizer and the
same 24-bit unit ``((h >> 8) + 0.5) * 2^-24``, so a sketch built by either
package joins with one built by the other.  PyTorch has no full uint32
arithmetic on every backend (no ``>>`` or ``<`` on ``torch.uint32`` on the
CPU), so the hash runs in int64 and every product is reduced to its low 32
bits.  A product of two 32-bit numbers would overflow int64, so each
multiply is split into two 16-bit halves of the constant.
"""
from __future__ import annotations

import numpy as np
import torch

GOLDEN = 0x9E3779B9
_M1 = 0x21F0AAAD
_M2 = 0x735A2D97
_MASK = 0xFFFFFFFF
# 2^-24: scale for a 24-bit mantissa-exact uniform in (0, 1).
UNIT = np.float32(1.0 / (1 << 24))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant, without int64 overflow (each partial product < 2^49)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer (low-bias avalanche) on int64 values in [0, 2^32)."""
    x = x.to(torch.int64) & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    x = x ^ (x >> 15)
    return x


def _seed64(seed, like: torch.Tensor | None = None) -> torch.Tensor:
    device = None if like is None else like.device
    return torch.as_tensor(int(seed) & _MASK, dtype=torch.int64,
                           device=device)


def fold_seed(seed, stream: int = 0) -> torch.Tensor:
    """Derive an independent 32-bit stream seed from (seed, stream)."""
    s = _seed64(seed)
    return mix32((s + _mul32(torch.tensor(stream & _MASK), GOLDEN) + 1)
                 & _MASK)


def hash_u32(seed, idx: torch.Tensor) -> torch.Tensor:
    """Uniform 32-bit hash (as int64) of integer indices under ``seed``."""
    i = idx.to(torch.int64) & _MASK
    return mix32(_mul32(i, GOLDEN) + _seed64(seed, i))


def hash_unit(seed, idx: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in (0, 1): top 24 bits of the hash plus 1/2 ulp."""
    h = hash_u32(seed, idx)
    return ((h >> 8).to(torch.float32) + 0.5) * float(UNIT)


def hash_sign(seed, idx: torch.Tensor) -> torch.Tensor:
    """Rademacher +-1 (float32) from the hash's low bit."""
    h = hash_u32(seed, idx)
    one = torch.ones((), dtype=torch.float32, device=h.device)
    return torch.where((h & 1) == 0, one, -one)


def hash_bucket(seed, idx: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Uniform bucket id in [0, n_buckets) (int32): a mask for powers of
    two, a modulo otherwise."""
    h = hash_u32(seed, idx)
    if n_buckets & (n_buckets - 1) == 0:
        return (h & (n_buckets - 1)).to(torch.int32)
    return (h % n_buckets).to(torch.int32)
