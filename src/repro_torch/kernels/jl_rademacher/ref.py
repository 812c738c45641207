"""Plain PyTorch versions of the matrix-free JL kernel.

The same sign stream as ``csrc/jl_rademacher.cu``: ``sign(r, j)`` is the
low bit of ``mix32(j * GOLDEN + row_seed[r])``.  The +-1 matrix is made
in blocks of ``row_block`` rows (the int64 hash emulation of a whole
(m, n) matrix would take gigabytes at the join-size widths).  The wrapper
in ``jl_rademacher.py`` uses :func:`jl_rows_ref` for CPU tensors, and the
tests and ``chip_smoke.py`` compare the kernel with it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import GOLDEN, _MASK, _mul32, mix32


def jl_row_seeds(seed, rows: torch.Tensor) -> torch.Tensor:
    """``kernels.jl_project``'s row seeds, ``mix32(seed + r * GOLDEN)``
    (int64 holding 32-bit values)."""
    r = rows.to(torch.int64) & _MASK
    return mix32(((int(seed) & _MASK) + _mul32(r, GOLDEN)) & _MASK)


def _signs(row_seeds: torch.Tensor, n: int) -> torch.Tensor:
    cols = _mul32(torch.arange(n, dtype=torch.int64,
                               device=row_seeds.device), GOLDEN)
    h = mix32(cols[None, :] + (row_seeds.to(torch.int64) & _MASK)[:, None])
    one = torch.ones((), dtype=torch.float32, device=row_seeds.device)
    return torch.where((h & 1) == 0, one, -one)


def jl_signs_ref(seed, rows: torch.Tensor, n: int) -> torch.Tensor:
    """(len(rows), n) +-1 float32 matrix of ``jl_project``'s rows."""
    return _signs(jl_row_seeds(seed, rows), n)


def jl_rows_ref(values: torch.Tensor, row_seeds: torch.Tensor, *,
                row_block: int = 64) -> torch.Tensor:
    """(n,) float32 and (m,) row seeds -> (m,) float32
    ``sum_j sign(r, j) * values[j]``."""
    v = values.to(torch.float32)
    n = v.shape[0]
    out = [_signs(row_seeds[r0:r0 + row_block], n) @ v
           for r0 in range(0, row_seeds.shape[0], row_block)]
    return torch.cat(out) if out else v.new_zeros((0,))


def jl_ref(values: torch.Tensor, m: int, seed) -> torch.Tensor:
    """``S(a) = Pi a / sqrt(m)`` with the kernel's Pi, made in row blocks."""
    rows = torch.arange(m, dtype=torch.int64, device=values.device)
    return jl_rows_ref(values, jl_row_seeds(seed, rows)) / sqrt_m(m)


def sqrt_m(m: int) -> float:
    """``sqrt(m)`` rounded to float32, as the reference divides."""
    return float(np.sqrt(np.float32(m)))
