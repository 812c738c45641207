"""Wrappers of the CUDA estimators (``csrc/intersect_estimate.cu``).

- :func:`intersect_estimate` (replaces ``intersect_estimate_pallas``): one
  bucketized query against a corpus -> (C,) estimates.  Each block stages
  the query's occupied buckets as a list and reads only those buckets of
  its rows (16-byte loads at four slots a bucket); a row's bits do not
  depend on the other rows.
- :func:`allpairs_estimate` (replaces ``allpairs_estimate_pallas``): two
  bucketized corpora -> the (D1, D2) estimate matrix, or the (D1, D2, 6)
  co-moment channels with ``moments=True``.  On the card it compacts each
  corpus to its occupied slots (:func:`allpairs_compact`, once when both
  sides are the same corpus) and joins the compacted lists (its own
  count covers the join launch).  The moments join of a corpus with
  itself computes the tiles on and above the diagonal and mirrors them
  (the same bits as a join with a copy of the corpus).
- :func:`allpairs_join_tiles` (the discovery scans' batches of the same
  kernel's join): listed (A tile, B tile) pairs of two compacted corpora
  -> their (64, 64) tiles in one launch, each bit-equal to the plain
  join's tile; a pair runs as several blocks, each on a group of the A
  rows.  :func:`allpairs_compact` takes a row list for it (the scan's
  tiles laid into the compacted tiles).

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches in ``.launches``
(and the tile-list join the tiles it computed in ``.tiles``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import (COMPACT_TILE, MOMENT_CHANNELS, allpairs_compact_ref,
                  allpairs_estimate_ref, allpairs_join_tiles_ref,
                  intersect_estimate_ref)

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "repro_intersect_estimate": [_P, _P, _P, _P, _P, _P, _P, _I64, _INT,
                                 _INT, _INT, _P],
    "repro_allpairs_compact": [_P, _P, _P, _P, _P, _P, _I64, _I64, _INT, _INT,
                               _P],
    "repro_allpairs_join_tiles": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                                  _INT, _INT, _INT, _P],
    "repro_allpairs_join": [_P, _P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT,
                            _P],
    "repro_allpairs_moments_shape": [_INT, _P, _P, _P, _P],
}
# the all-pairs kernels hold a bucket's entries of 64 rows, at most 64 x 16
# a side, in shared memory
MAX_SLOTS = 16
# shared memory a block may take on Hopper (227 KiB)
MAX_SHARED = 232448
# blocks a listed pair of the tile-list join may take (A-row groups)
MAX_GROUPS = 16


def query_shared_bytes(B: int, S: int) -> int:
    """Shared memory of the query kernel (``query_smem`` in the .cu, and
    its 64 static bytes): the query's list (12 bytes a slot and a bucket
    number each) and one term a lane a chunk of 32 entries."""
    return B * S * 12 + B * 4 + -(-B // 32) * 128 + 64


def _lib():
    return _build.load("intersect_estimate", _SIGNATURES)


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def intersect_estimate(q_idx, q_val, q_tau, c_idx, c_val, c_tau
                       ) -> torch.Tensor:
    """q (B, S) int32/f32 and scalar tau; corpus (C, B, S) int32/f32 and
    (C,) tau -> (C,) float32 estimates."""
    if c_idx.device.type == "cpu":
        return intersect_estimate_ref(q_idx, q_val, q_tau, c_idx, c_val, c_tau)
    dev = c_idx.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C, B, S = c_idx.shape
    if query_shared_bytes(B, S) > MAX_SHARED:
        raise ValueError(f"a query of {B} buckets x {S} slots needs more "
                         f"than one block's shared memory ({MAX_SHARED} B)")
    q_tau = torch.as_tensor(q_tau, dtype=torch.float32, device=dev).reshape(1)
    _check(q_idx, "q_idx", torch.int32, (B, S), dev)
    _check(q_val, "q_val", torch.float32, (B, S), dev)
    _check(c_idx, "c_idx", torch.int32, (C, B, S), dev)
    _check(c_val, "c_val", torch.float32, (C, B, S), dev)
    _check(c_tau, "c_tau", torch.float32, (C,), dev)
    out = torch.empty((C,), dtype=torch.float32, device=dev)
    ptrs = (q_idx.data_ptr(), q_val.data_ptr(), c_idx.data_ptr(),
            c_val.data_ptr())
    vec = int(S == 4 and not any(p % 16 for p in ptrs))
    lib = _lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_intersect_estimate(
        ptrs[0], ptrs[1], q_tau.data_ptr(), ptrs[2], ptrs[3],
        c_tau.data_ptr(), out.data_ptr(), C, B, S, vec, stream))
    _build.check(err, "intersect_estimate")
    _build.count_launch(intersect_estimate)
    return out


def allpairs_compact(idx, val, p, rows=None):
    """One (D, B, S) corpus (int32 ids, float32 values and inclusion
    probabilities) -> its compacted all-pairs layout ``(entries (T, B,
    64*S, 4) int32, counts (T, B) int32)``: per tile of 64 rows and
    bucket, the occupied slots in (id, row, slot) order as (id, row in
    tile + 256 x the entries with this id, bits of v, bits of 1/p).
    Tile t holds rows 64 t .. 64 t + 63, T = ceil(D / 64); with ``rows``
    (a (T * 64,) int32 row list on the corpus's device) it holds
    ``rows[64 t:64 t + 64]``, -1 an empty row.  Entries past a count are
    unspecified on the card (zeros in the plain version)."""
    if idx.device.type == "cpu":
        return allpairs_compact_ref(idx, val, p, rows=rows)
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    D, B, S = idx.shape
    if S > MAX_SLOTS:
        raise ValueError(f"slots={S} > {MAX_SLOTS} is not supported")
    for t, what, dt in ((idx, "idx", torch.int32), (val, "val", torch.float32),
                        (p, "p", torch.float32)):
        _check(t, what, dt, (D, B, S), dev)
    if rows is None:
        T = -(-D // COMPACT_TILE)
    else:
        T = rows.shape[0] // COMPACT_TILE
        _check(rows, "rows", torch.int32, (T * COMPACT_TILE,), dev)
    entries = torch.empty((T, B, COMPACT_TILE * S, 4), dtype=torch.int32,
                          device=dev)
    counts = torch.empty((T, B), dtype=torch.int32, device=dev)
    lib = _lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_allpairs_compact(
        idx.data_ptr(), val.data_ptr(), p.data_ptr(),
        None if rows is None else rows.data_ptr(), entries.data_ptr(),
        counts.data_ptr(), T, D, B, S, stream))
    _build.check(err, "allpairs_compact")
    _build.count_launch(allpairs_compact)
    return entries, counts


def auto_groups(n_pairs: int, sms: int) -> int:
    """Blocks a pair of an ``n_pairs``-pair tile-list join takes by
    default: the fewest (a power of two, at most ``MAX_GROUPS``) that give
    the launch two blocks an SM."""
    g = 1
    while g < MAX_GROUPS and n_pairs * g < 2 * sms:
        g *= 2
    return g


def allpairs_join_tiles(a_entries, a_counts, b_entries, b_counts, pairs, *,
                        groups: int | None = None) -> torch.Tensor:
    """Listed tile pairs of two compacted corpora (:func:`allpairs_compact`
    layouts) -> (N, 64, 64) float32 in one launch: ``pairs`` (N, 2) int32
    (a tile of the A side, a tile of the B side), each output the plain
    join's tile of the two bit for bit (zeros for a pair outside the
    tiles).  ``groups`` (1, 2, 4, 8 or 16): blocks a pair, each joining
    64 / groups of the A rows; by default :func:`auto_groups`.  It sets
    the blocks, not the bits."""
    if a_entries.device.type == "cpu":
        return allpairs_join_tiles_ref(a_entries, a_counts, b_entries,
                                       b_counts, pairs)
    dev = a_entries.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    Ta, B, cap, _ = a_entries.shape
    Tb = b_entries.shape[0]
    S = cap // COMPACT_TILE
    N = pairs.shape[0]
    if S > MAX_SLOTS or cap != S * COMPACT_TILE:
        raise ValueError(f"entries of {cap} a bucket: not a compacted "
                         f"layout of at most {MAX_SLOTS} slots")
    for t, what, shape in (
            (a_entries, "a_entries", (Ta, B, cap, 4)),
            (a_counts, "a_counts", (Ta, B)),
            (b_entries, "b_entries", (Tb, B, cap, 4)),
            (b_counts, "b_counts", (Tb, B)),
            (pairs, "pairs", (N, 2))):
        _check(t, what, torch.int32, shape, dev)
    if groups is None:
        groups = auto_groups(N, _sm_count(dev))
    if groups not in (1, 2, 4, 8, 16):
        raise ValueError(f"groups must be 1, 2, 4, 8 or 16, got {groups}")
    out = torch.empty((N, COMPACT_TILE, COMPACT_TILE), dtype=torch.float32,
                      device=dev)
    if N == 0:
        return out
    lib = _lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_allpairs_join_tiles(
        a_entries.data_ptr(), a_counts.data_ptr(), b_entries.data_ptr(),
        b_counts.data_ptr(), pairs.data_ptr(), out.data_ptr(), N, Ta, Tb, B,
        S, groups, stream))
    _build.check(err, "allpairs_join_tiles")
    _build.count_launch(allpairs_join_tiles, tiles=N)
    return out


_SMS: dict = {}


def _sm_count(dev) -> int:
    """The SM count of CUDA device ``dev``, asked once a device."""
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def allpairs_estimate(a_idx, a_val, a_p, b_idx, b_val, b_p, *,
                      moments: bool = False) -> torch.Tensor:
    """(D1, B, S) and (D2, B, S) idx/val/inclusion-probability triples ->
    (D1, D2), or (D1, D2, 6) in ``MOMENT_CHANNELS`` order."""
    if a_idx.device.type == "cpu":
        return allpairs_estimate_ref(a_idx, a_val, a_p, b_idx, b_val, b_p,
                                     moments=moments)
    dev = a_idx.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    D1, B, S = a_idx.shape
    D2 = b_idx.shape[0]
    if S > MAX_SLOTS:
        raise ValueError(f"slots={S} > {MAX_SLOTS} is not supported")
    for t, what, dt, shape in (
            (a_idx, "a_idx", torch.int32, (D1, B, S)),
            (a_val, "a_val", torch.float32, (D1, B, S)),
            (a_p, "a_p", torch.float32, (D1, B, S)),
            (b_idx, "b_idx", torch.int32, (D2, B, S)),
            (b_val, "b_val", torch.float32, (D2, B, S)),
            (b_p, "b_p", torch.float32, (D2, B, S))):
        _check(t, what, dt, shape, dev)
    a = allpairs_compact(a_idx, a_val, a_p)
    same = all(x.data_ptr() == y.data_ptr() for x, y in
               ((a_idx, b_idx), (a_val, b_val), (a_p, b_p))) and D1 == D2
    b = a if same else allpairs_compact(b_idx, b_val, b_p)
    shape = (D1, D2, len(MOMENT_CHANNELS)) if moments else (D1, D2)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_allpairs_join(
        a[0].data_ptr(), a[1].data_ptr(), b[0].data_ptr(), b[1].data_ptr(),
        out.data_ptr(), D1, D2, B, S, int(moments), stream))
    _build.check(err, "allpairs_estimate")
    _build.count_launch(allpairs_estimate)
    return out


def moments_join_shape(slots: int) -> dict:
    """The moments join's launch shape on the current card at ``slots``
    slots a bucket: blocks and warps an SM (the occupancy calculator's),
    dynamic shared memory a block and registers a thread."""
    vals = [ctypes.c_int() for _ in range(4)]
    _build.check(_lib().repro_allpairs_moments_shape(
        slots, *(ctypes.addressof(v) for v in vals)), "moments_join_shape")
    blocks, warps, smem, regs = (v.value for v in vals)
    return {"blocks_per_sm": blocks, "warps_per_block": warps,
            "warps_per_sm": blocks * warps, "smem_bytes_per_block": smem,
            "registers_per_thread": regs}


intersect_estimate.launches = 0
allpairs_estimate.launches = 0
allpairs_compact.launches = 0
allpairs_join_tiles.launches = 0
allpairs_join_tiles.tiles = 0
