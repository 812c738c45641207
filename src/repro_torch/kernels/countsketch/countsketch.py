"""Wrapper of the CUDA CountSketch kernel (``csrc/countsketch.cu``).

:func:`countsketch_scatter` (replaces ``countsketch_pallas``): one (n,)
float32 vector -> its (m,) CountSketch table under two 32-bit hash seeds,
a deterministic scatter-add (two launches of the .cu: per-chunk sorted
partial tables, then their sum over chunks in order).  Bound: bytes, the
vector read once and the table written once; at its callers' sizes the
time is launch latency.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  The wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import countsketch_ref

_P, _I64, _U32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
_SIGNATURES = {
    "repro_countsketch": [_P, _I64, _I64, _U32, _U32, _P, _P, _P],
}
CHUNK = 4096   # inputs per block of the first pass (kept in step with the .cu)


def _lib():
    return _build.load("countsketch", _SIGNATURES)


def countsketch_scatter(values: torch.Tensor, m: int, seed_bucket: int,
                        seed_sign: int) -> torch.Tensor:
    """(n,) float32 -> (m,) float32 CountSketch table; the seeds are the
    bucket and sign streams' 32-bit seeds."""
    if values.device.type == "cpu":
        return countsketch_ref(values, seed_bucket, seed_sign, m)
    if not values.is_cuda:
        raise ValueError(f"values must be a CUDA or CPU tensor, got "
                         f"{values.device}")
    if (values.dtype != torch.float32 or values.ndim != 1
            or not values.is_contiguous()):
        raise ValueError(f"values must be a contiguous (n,) float32 tensor, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if not 1 <= m < 2**31 - 1:
        raise ValueError(f"need 1 <= m < 2^31 - 1, got {m}")
    n = values.shape[0]
    dev = values.device
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    if n == 0:
        return out.zero_()
    partial = torch.empty((-(-n // CHUNK) * m,), dtype=torch.float32,
                          device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_countsketch(values.data_ptr(), n, m,
                                    int(seed_bucket) & 0xFFFFFFFF,
                                    int(seed_sign) & 0xFFFFFFFF,
                                    partial.data_ptr(), out.data_ptr(),
                                    stream)
    _build.check(err, "countsketch")
    countsketch_scatter.launches += 1
    return out


countsketch_scatter.launches = 0
