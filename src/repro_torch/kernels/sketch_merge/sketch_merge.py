"""Wrapper of the CUDA bucketized merge (``csrc/sketch_merge.cu``).

:func:`merge_bucketized` (replaces ``merge_bucketized_pallas``): two
coordinated (D, B, S) bucketized corpora and the per-row merged tau ->
the merged corpus and the entries each row lost to a full bucket.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  The wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._args import MAX_ROWS, variant_code
from .ref import merge_bucketized_ref

_P, _I64, _U32, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                        ctypes.c_int)
_SIGNATURES = {
    "repro_merge_bucketized": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                               _INT, _U32, _INT, _P],
}
MAX_SLOTS = 8   # the kernel is instantiated for 1 <= S <= 8


def _lib():
    return _build.load("sketch_merge", _SIGNATURES)


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def merge_bucketized(a_idx, a_val, b_idx, b_val, tau, seed, *,
                     variant: str = "l2"):
    """(D, B, S) int32/float32 corpora a and b, (D,) float32 tau ->
    (out_idx (D, B, S) int32, out_val (D, B, S) float32, dropped (D,)
    int32)."""
    if a_idx.device.type == "cpu":
        return merge_bucketized_ref(a_idx, a_val, b_idx, b_val, tau, seed,
                                    variant=variant)
    dev = a_idx.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if a_idx.ndim != 3:
        raise ValueError(f"expected (D, B, S) corpora, got "
                         f"{tuple(a_idx.shape)}")
    D, B, S = a_idx.shape
    if not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"slots={S}: the merge kernel takes 1..{MAX_SLOTS}")
    if D > MAX_ROWS:
        raise ValueError(f"{D} rows; at most {MAX_ROWS} per launch")
    code = variant_code(variant)
    for t, what, dtype in ((a_idx, "a_idx", torch.int32),
                           (a_val, "a_val", torch.float32),
                           (b_idx, "b_idx", torch.int32),
                           (b_val, "b_val", torch.float32)):
        _check(t, what, dtype, (D, B, S), dev)
    _check(tau, "tau", torch.float32, (D,), dev)
    out_idx = torch.empty((D, B, S), dtype=torch.int32, device=dev)
    out_val = torch.empty((D, B, S), dtype=torch.float32, device=dev)
    dropped = torch.zeros((D,), dtype=torch.int32, device=dev)
    lib = _lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_merge_bucketized(
        a_idx.data_ptr(), a_val.data_ptr(), b_idx.data_ptr(), b_val.data_ptr(),
        tau.data_ptr(), out_idx.data_ptr(), out_val.data_ptr(),
        dropped.data_ptr(), D, B, S, int(seed) & 0xFFFFFFFF, code, stream))
    _build.check(err, "merge_bucketized")
    _build.count_launch(merge_bucketized)
    return out_idx, out_val, dropped


merge_bucketized.launches = 0
