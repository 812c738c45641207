"""Wrappers of the CUDA build kernels (``csrc/sketch_build.cu``).

- :func:`hash_rank_hist` (replaces ``hash_rank_hist_pallas``): fused hash,
  weight and rank of a (D, n) block plus the level-0 histogram of the rank
  bit patterns.
- :func:`rank_hist` (replaces ``rank_hist_pallas``): one 8-bit refinement
  level of that histogram under a per-row prefix.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._args import check_block, variant_code
from .ref import NBINS, hash_rank_hist_ref, rank_hist_ref

_P, _I64, _U32, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                        ctypes.c_int)
_SIGNATURES = {
    "repro_hash_rank_hist": [_P, _P, _P, _P, _I64, _I64, _U32, _INT, _P],
    "repro_rank_hist": [_P, _P, _P, _I64, _I64, _INT, _P],
}


def _lib():
    return _build.load("sketch_build", _SIGNATURES)


def hash_rank_hist(values: torch.Tensor, seed, *, variant: str = "l2"):
    """(D, n) float32 -> (h (n,), rank (D, n), hist (D, 256) int32)."""
    if values.device.type == "cpu":
        return hash_rank_hist_ref(values, seed, variant=variant)
    check_block(values, "values")
    code = variant_code(variant)
    D, n = values.shape
    dev = values.device
    h = torch.empty((n,), dtype=torch.float32, device=dev)
    rank = torch.empty((D, n), dtype=torch.float32, device=dev)
    hist = torch.zeros((D, NBINS), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_hash_rank_hist(
            values.data_ptr(), h.data_ptr(), rank.data_ptr(), hist.data_ptr(),
            D, n, int(seed) & 0xFFFFFFFF, code, stream)
    _build.check(err, "hash_rank_hist")
    hash_rank_hist.launches += 1
    return h, rank, hist


def rank_hist(keys: torch.Tensor, prefix: torch.Tensor, *,
              shift: int) -> torch.Tensor:
    """One refinement level over (D, n) nonnegative float32 keys with a
    (D,) int32 prefix -> (D, 256) int32 counts."""
    if keys.device.type == "cpu":
        return rank_hist_ref(keys, prefix, shift=shift)
    check_block(keys, "keys")
    D, n = keys.shape
    if (prefix.device != keys.device or prefix.dtype != torch.int32
            or prefix.shape != (D,) or not prefix.is_contiguous()):
        raise ValueError("prefix must be a contiguous (D,) int32 tensor on "
                         "the keys' device")
    if shift not in (0, 8, 16, 24):
        raise ValueError(f"shift must be 0, 8, 16 or 24, got {shift}")
    hist = torch.zeros((D, NBINS), dtype=torch.int32, device=keys.device)
    lib = _lib()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.repro_rank_hist(keys.data_ptr(), prefix.data_ptr(),
                                  hist.data_ptr(), D, n, shift, stream)
    _build.check(err, "rank_hist")
    rank_hist.launches += 1
    return hist


hash_rank_hist.launches = 0
rank_hist.launches = 0
