"""Wrapper of the CUDA CountSketch kernel (``csrc/countsketch.cu``).

:func:`countsketch_scatter` (replaces ``countsketch_pallas``): one (n,)
float32 vector -> its (m,) CountSketch table under two 32-bit hash seeds,
a deterministic scatter-add.  Up to ``one_pass_max_m()`` buckets (3417;
every caller's m) one launch of a thread-block cluster that sums in shared
memory, with no scratch; beyond, two launches (per-chunk sorted partial
tables in a scratch this wrapper allocates, then their sum over chunks in
order).  Bound: bytes, the vector read once and the table written once;
at its callers' sizes the time is launch latency.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  The wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import countsketch_ref

_P, _I64, _U32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
_SIGNATURES = {
    "repro_countsketch": [_P, _I64, _I64, _U32, _U32, _P, _P, _P],
    "repro_countsketch_one_pass_max_m": [],
}
CHUNK = 4096   # inputs a block of the two-pass path (as in the .cu)


def _lib():
    return _build.load("countsketch", _SIGNATURES)


@functools.cache
def one_pass_max_m() -> int:
    """The largest m that one launch serves (the .cu's own limit)."""
    return int(_lib().repro_countsketch_one_pass_max_m())


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
    lib = _lib()
    partial = None if m <= one_pass_max_m() else torch.empty(
        (-(-n // CHUNK) * m,), dtype=torch.float32, device=dev)
    err = _build.launch_on(dev, lambda stream: lib.repro_countsketch(
        values.data_ptr(), n, m, int(seed_bucket) & 0xFFFFFFFF,
        int(seed_sign) & 0xFFFFFFFF, out.data_ptr(),
        None if partial is None else partial.data_ptr(), stream))
    _build.check(err, "countsketch")
    _build.count_launch(countsketch_scatter)
    return out


countsketch_scatter.launches = 0
