"""Wrapper of the CUDA matrix-free JL kernel (``csrc/jl_rademacher.cu``).

:func:`jl_rademacher` (replaces ``jl_pallas``): one (n,) float32 vector
and (m,) 32-bit row seeds -> the (m,) sums ``sum_j sign(r, j) * v_j``,
the +-1 matrix hashed where it is used and never stored.  The row seeds
are an input so that ``kernels.jl_project`` and ``core.baselines.
jl_sketch``, which derive them by different rules, share the kernel.
Bound: operations (m * n hashes and adds).  One launch: blocks of a few
rows by a chunk of the columns, the chunks of a row tile summed in a
fixed order inside a thread-block cluster; the chunks depend on n alone,
so a row's bits depend only on its seed and the vector.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  The wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import jl_rows_ref

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"repro_jl_rademacher": [_P, _P, _I64, _I64, _P, _P]}


def _lib():
    return _build.load("jl_rademacher", _SIGNATURES)


def jl_rademacher(values: torch.Tensor, row_seeds: torch.Tensor) -> torch.Tensor:
    """(n,) float32 and (m,) integer row seeds (32-bit values) -> (m,)
    float32 unscaled projection."""
    if values.device.type == "cpu":
        return jl_rows_ref(values, row_seeds.cpu())
    if not values.is_cuda:
        raise ValueError(f"values must be a CUDA or CPU tensor, got "
                         f"{values.device}")
    if (values.dtype != torch.float32 or values.ndim != 1
            or not values.is_contiguous()):
        raise ValueError(f"values must be a contiguous (n,) float32 tensor, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if row_seeds.ndim != 1 or row_seeds.dtype not in (torch.int32,
                                                      torch.int64):
        raise ValueError(f"row_seeds must be an (m,) int32 or int64 tensor, "
                         f"got {row_seeds.dtype} {tuple(row_seeds.shape)}")
    if row_seeds.device != values.device:
        raise ValueError(f"row_seeds on {row_seeds.device}, values on "
                         f"{values.device}")
    m, n = row_seeds.shape[0], values.shape[0]
    if m >= 2**31 or n >= 2**32:
        raise ValueError(f"m = {m}, n = {n} beyond one launch")
    dev = values.device
    # an integer narrowing keeps the low 32 bits: the seeds' bits
    seeds = row_seeds.to(torch.int32).contiguous()
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    lib = _lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_jl_rademacher(
        values.data_ptr(), seeds.data_ptr(), n, m, out.data_ptr(), stream))
    _build.check(err, "jl_rademacher")
    _build.count_launch(jl_rademacher)
    return out


jl_rademacher.launches = 0
