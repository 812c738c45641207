"""Wrappers of the CUDA build kernels.

- :func:`hash_rank_hist` (replaces ``hash_rank_hist_pallas``;
  ``csrc/sketch_build.cu``): fused hash, weight and rank of a (D, n) block
  plus the level-0 histogram of the rank bit patterns; on a block as
  small as one vector, one cluster launch that writes the histogram
  (``hash_rank.spread_route``), else the batched grid, which adds into a
  zeroed one.
- :func:`radix_select` (replaces ``rank_hist_pallas`` and the four-level
  descent over it; ``csrc/radix_select.cu``): the exact per-row k-th
  smallest key in one launch, every 8-bit level on chip.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._args import check_block, variant_code
from ..hash_rank.hash_rank import spread_route
from .ref import NBINS, hash_rank_hist_ref, kth_smallest_ranks_ref

_P, _I64, _U32, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                        ctypes.c_int)
_SIGNATURES = {
    "repro_hash_rank_hist": [_P, _P, _P, _P, _I64, _I64, _U32, _INT, _INT,
                             _P],
}
_SELECT_SIGNATURES = {
    "repro_radix_select": [_P, _P, _P, _I64, _P, _I64, _I64, _P],
}


def _lib():
    return _build.load("sketch_build", _SIGNATURES)


def _select_lib():
    return _build.load("radix_select", _SELECT_SIGNATURES)


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
    spread = spread_route(dev, D, n, hist=True)
    # the spread route writes every bin; the batched one adds into zeros
    hist = (torch.empty if spread else torch.zeros)(
        (D, NBINS), dtype=torch.int32, device=dev)
    lib = _lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_hash_rank_hist(
        values.data_ptr(), h.data_ptr(), rank.data_ptr(), hist.data_ptr(), D,
        n, int(seed) & 0xFFFFFFFF, code, int(spread), stream))
    _build.check(err, "hash_rank_hist")
    _build.count_launch(hash_rank_hist)
    return h, rank, hist


def check_k(k, n: int) -> None:
    """Raise unless an int ``k`` names one of ``n`` keys (1 <= k <= n)."""
    if isinstance(k, int) and not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n for the k-th smallest of {n} "
                         f"keys, got k={k}")


def radix_select(keys: torch.Tensor, k, *,
                 hist0: torch.Tensor | None = None) -> torch.Tensor:
    """Exact per-row k-th smallest of (D, n) nonnegative float32 keys in
    one launch -> (D,) float32.  ``k`` is an int or a (D,) tensor with
    1 <= k <= n; ``hist0`` the (D, 256) int32 level-0 histogram when the
    caller has it.  No host synchronisation."""
    check_k(k, keys.shape[1])
    if keys.device.type == "cpu":
        return kth_smallest_ranks_ref(keys, k, hist0=hist0)
    check_block(keys, "keys")
    D, n = keys.shape
    dev = keys.device
    if hist0 is not None and (hist0.device != dev
                              or hist0.dtype != torch.int32
                              or tuple(hist0.shape) != (D, NBINS)
                              or not hist0.is_contiguous()):
        raise ValueError("hist0 must be a contiguous (D, 256) int32 tensor "
                         "on the keys' device")
    if isinstance(k, torch.Tensor):
        kvec = torch.broadcast_to(k.to(device=dev, dtype=torch.int64),
                                  (D,)).contiguous()
        kptr, kscalar = kvec.data_ptr(), 0
    else:
        kvec, kptr, kscalar = None, None, int(k)
    out = torch.empty((D,), dtype=torch.float32, device=dev)
    lib = _select_lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_radix_select(
        keys.data_ptr(), None if hist0 is None else hist0.data_ptr(), kptr,
        kscalar, out.data_ptr(), D, n, stream))
    _build.check(err, "radix_select")
    _build.count_launch(radix_select)
    return out


hash_rank_hist.launches = 0
radix_select.launches = 0
