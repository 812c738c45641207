"""Wrappers of the hash/rank kernel (``csrc/sketch_build.cu``, no
histogram).

- :func:`hash_rank_batched` (replaces ``hash_rank_batched_pallas``): the
  shared hash row and the sampling ranks of a (D, n) block — the threshold
  build's front end;
- :func:`hash_rank` (replaces ``hash_rank_pallas``): the same for one
  (n,) vector, the kernel's D = 1 launch through its own C entry.

The kernel has two routes (``csrc/sketch_build.cu``): the batched grid,
and the spread route for a block whose batched grid would leave the card
mostly idle, as one vector does.  :func:`spread_route` draws the boundary
for this module and for ``sketch_build.hash_rank_hist`` alike.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._args import check_block, variant_code
from .ref import hash_rank_batched_ref, hash_rank_ref

_P, _I64, _U32, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                        ctypes.c_int)
_SIGNATURES = {
    "repro_hash_rank_batched": [_P, _P, _P, _I64, _I64, _U32, _INT, _INT,
                                _P],
    "repro_hash_rank": [_P, _P, _P, _I64, _U32, _INT, _INT, _P],
}
CHUNK = 4096       # coordinates a block of the batched route takes
# With the histogram the spread route is one cluster of at most 16 SMs a
# row: past 2^17 coordinates (8 strides of a 16-block cluster) the batched
# grid and the fill of its histogram take less time on an H100
# (chip_smoke.py's hash_rank_hist_routes).
HIST_SPREAD_MAX_N = 1 << 17


def takes_spread_route(D: int, n: int, sms: int, *, hist: bool = False
                       ) -> bool:
    """Whether a (D, n) block takes the spread route on a card of ``sms``
    SMs: its batched grid (a block per CHUNK coordinates of a row) would
    hold fewer than two blocks an SM, and, for the pass with the
    histogram (``hist``), n <= HIST_SPREAD_MAX_N."""
    return (n > 0 and D * -(-n // CHUNK) < 2 * sms
            and not (hist and n > HIST_SPREAD_MAX_N))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def spread_route(dev: torch.device, D: int, n: int, *, hist: bool = False
                 ) -> bool:
    """:func:`takes_spread_route` on CUDA device ``dev``."""
    return takes_spread_route(D, n, _sm_count(dev.index), hist=hist)


def _lib():
    return _build.load("sketch_build", _SIGNATURES)


def hash_rank_batched(values: torch.Tensor, seed, *, variant: str = "l2"):
    """(D, n) float32 -> (h (n,), rank (D, n))."""
    if values.device.type == "cpu":
        return hash_rank_batched_ref(values, seed, variant=variant)
    check_block(values, "values")
    code = variant_code(variant)
    D, n = values.shape
    dev = values.device
    h = torch.empty((n,), dtype=torch.float32, device=dev)
    rank = torch.empty((D, n), dtype=torch.float32, device=dev)
    spread = int(spread_route(dev, D, n))
    lib = _lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_hash_rank_batched(
        values.data_ptr(), h.data_ptr(), rank.data_ptr(), D, n,
        int(seed) & 0xFFFFFFFF, code, spread, stream))
    _build.check(err, "hash_rank_batched")
    hash_rank_batched.launches += 1
    return h, rank


def hash_rank(values: torch.Tensor, seed, *, variant: str = "l2"):
    """(n,) float32 -> (h (n,), rank (n,))."""
    if values.device.type == "cpu":
        return hash_rank_ref(values, seed, variant=variant)
    if values.ndim != 1:
        raise ValueError(f"values must be (n,), got {tuple(values.shape)}")
    check_block(values[None], "values")
    code = variant_code(variant)
    n = values.shape[0]
    dev = values.device
    h = torch.empty((n,), dtype=torch.float32, device=dev)
    rank = torch.empty((n,), dtype=torch.float32, device=dev)
    spread = int(spread_route(dev, 1, n))
    lib = _lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_hash_rank(
        values.data_ptr(), h.data_ptr(), rank.data_ptr(), n,
        int(seed) & 0xFFFFFFFF, code, spread, stream))
    _build.check(err, "hash_rank")
    hash_rank.launches += 1
    return h, rank


hash_rank_batched.launches = 0
hash_rank.launches = 0
