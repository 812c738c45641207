"""Wrappers of the CUDA estimators (``csrc/intersect_estimate.cu``).

- :func:`intersect_estimate` (replaces ``intersect_estimate_pallas``): one
  bucketized query against a corpus -> (C,) estimates.
- :func:`allpairs_estimate` (replaces ``allpairs_estimate_pallas``): two
  bucketized corpora -> the (D1, D2) estimate matrix, or the (D1, D2, 6)
  co-moment channels with ``moments=True``.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import MOMENT_CHANNELS, allpairs_estimate_ref, intersect_estimate_ref

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "repro_intersect_estimate": [_P, _P, _P, _P, _P, _P, _P, _I64, _INT,
                                 _INT, _P],
    "repro_allpairs_estimate": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _INT,
                                _INT, _INT, _P],
}
# the all-pairs kernel stages whole buckets of at most 16 slots
MAX_SLOTS = 16
# the query kernel holds the query's B*S ids, values and probabilities
# (12 bytes a slot) in one block's shared memory (227 KiB on Hopper)
MAX_QUERY_SLOTS = 232448 // 12


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
    if B * S > MAX_QUERY_SLOTS:
        raise ValueError(f"B*S = {B * S} query slots exceed one block's "
                         f"shared memory ({MAX_QUERY_SLOTS})")
    q_tau = torch.as_tensor(q_tau, dtype=torch.float32, device=dev).reshape(1)
    _check(q_idx, "q_idx", torch.int32, (B, S), dev)
    _check(q_val, "q_val", torch.float32, (B, S), dev)
    _check(c_idx, "c_idx", torch.int32, (C, B, S), dev)
    _check(c_val, "c_val", torch.float32, (C, B, S), dev)
    _check(c_tau, "c_tau", torch.float32, (C,), dev)
    out = torch.empty((C,), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_intersect_estimate(
            q_idx.data_ptr(), q_val.data_ptr(), q_tau.data_ptr(),
            c_idx.data_ptr(), c_val.data_ptr(), c_tau.data_ptr(),
            out.data_ptr(), C, B, S, stream)
    _build.check(err, "intersect_estimate")
    intersect_estimate.launches += 1
    return out


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
    shape = (D1, D2, len(MOMENT_CHANNELS)) if moments else (D1, D2)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_allpairs_estimate(
            a_idx.data_ptr(), a_val.data_ptr(), a_p.data_ptr(),
            b_idx.data_ptr(), b_val.data_ptr(), b_p.data_ptr(),
            out.data_ptr(), D1, D2, B, S, int(moments), stream)
    _build.check(err, "allpairs_estimate")
    allpairs_estimate.launches += 1
    return out


intersect_estimate.launches = 0
allpairs_estimate.launches = 0
